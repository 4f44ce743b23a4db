"""K3's warp walk (``csrc/composite.cu``: one warp a ray, the slots in
chunks of 32, lane = slot) emulated in plain PyTorch and held against
``composite_rays_plain`` and JAX's ``composite_rays`` on the CPU.

The CUDA kernels cannot run here, so this file pins their algorithm:
  * forward: per chunk, the inclusive sum of tau slot by slot in slot
    order (the serial chain of shuffles, carried from chunk to chunk),
    T_in lane-wise, the stop at the first lane whose entering T is below
    T_thresh (a ballot), nothing read past that chunk; weights_sum, depth
    and image summed per lane over the chunks, then by the warp's xor tree;
  * backward: pass 1 replays the forward and sums R = sum_live w e (per
    lane, then the xor tree); pass 2 replays it again, takes the prefix P
    of w e by a Hillis-Steele scan carried from chunk to chunk, and writes
    g_sigma = (e exp(-tau) T_in - (R - P)) delta and g_rgb = w g_img on the
    kept slots, zeros elsewhere.
The emulation adds and multiplies in fp32 in the kernels' order, so its
weights must equal, bit for bit, those of the sequential walk (one slot at
a time, the order of the one-thread-a-ray kernel it replaces).  Both take
exp through float64 (``_exp``), so that the comparison does not hang on
which of PyTorch's exp paths a tensor's shape selects.  Against the plain
version and JAX: rtol 1e-5 / atol 1e-6 forward (test_torch_ops) and 1e-5
relative L2 backward (test_torch_train_ops): the sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.ops import composite as j_comp
from nerf_signature_tpu_torch.kernel_cases import k3_edge_inputs
from nerf_signature_tpu_torch.ops import composite as t_comp
from test_torch_train_ops import rel_l2

LANES = 32
T = torch.from_numpy
SIZES = [1, 31, 32, 40, 128]
MASKS = ["on", "off", "all_masked"]
THRESHOLDS = [0.0, 1e-4]


def _exp(x):
    return torch.exp(x.double()).float()


def _inputs(S, mask_kind):
    return k3_edge_inputs(64, S, mask_kind, seed=50)


def _cotangents(N, S, seed=51):
    rng = np.random.default_rng(seed)
    return {"weights_sum": rng.normal(size=N).astype(np.float32),
            "depth": rng.normal(size=N).astype(np.float32),
            "image": rng.normal(size=(N, 3)).astype(np.float32),
            "weights": rng.normal(size=(N, S)).astype(np.float32)}


def _sequential_weights(sig, dt, mask, T_thresh):
    """The one-thread-a-ray walk: slot by slot, the stop at the first slot
    whose entering T is below T_thresh."""
    N, S = sig.shape
    live = torch.ones((N, S), dtype=torch.bool) if mask is None else mask
    cum = torch.zeros(N)
    stopped = torch.zeros(N, dtype=torch.bool)
    w = torch.zeros((N, S))
    for i in range(S):
        tau = torch.where(live[:, i], sig[:, i] * dt[:, i], 0.0)
        cum_i = cum + tau
        T_in = _exp(-(cum_i - tau))
        stopped |= ~(T_in >= T_thresh)
        w[:, i] = torch.where(~stopped & live[:, i], (1.0 - _exp(-tau)) * T_in, 0.0)
        cum = torch.where(stopped, cum, cum_i)
    return w


def _xor_tree(v):
    """__shfl_xor_sync's butterfly over the lane axis: lane 0's result."""
    lanes = torch.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ off]
    return v[:, 0]


def _hillis_steele(v):
    """The inclusive scan over the lane axis, as __shfl_up_sync builds it."""
    for off in (1, 2, 4, 8, 16):
        up = torch.zeros_like(v)
        up[:, off:] = v[:, :-off]
        v = torch.where(torch.arange(LANES) >= off, up + v, v)
    return v


def _pad(x, c0, S):
    """Slots [c0, c0 + 32) of x [N, S, ...], zero past S."""
    n = min(LANES, S - c0)
    out = torch.zeros((x.shape[0], LANES) + tuple(x.shape[2:]), dtype=x.dtype)
    out[:, :n] = x[:, c0:c0 + n]
    return out


class _Chunk:
    """One chunk of every ray's walk: the serial chain, T_in, the stop."""

    def __init__(self, sig, dt, live, cum, walking, c0, S, T_thresh, stop=None):
        lanes = torch.arange(LANES)
        self.valid = (c0 + lanes < S)[None, :]
        self.live = _pad(live, c0, S) & walking[:, None]
        if stop is not None:
            self.live &= (c0 + lanes)[None, :] < stop[:, None]
        self.tau = torch.where(self.live, _pad(sig, c0, S) * _pad(dt, c0, S), 0.0)
        self.delta = _pad(dt, c0, S)
        # the serial chain: slot by slot in slot order, carried across chunks
        cum_i = torch.zeros((sig.shape[0], LANES))
        c = cum.clone()
        for j in range(LANES):
            c = c + self.tau[:, j]
            cum_i[:, j] = c
        self.carry = c
        self.T_in = _exp(-(cum_i - self.tau))
        stop_lanes = self.valid & ~(self.T_in >= T_thresh) & walking[:, None]
        self.stops = stop_lanes.any(-1)
        first = torch.where(self.stops, stop_lanes.int().argmax(-1), LANES)
        self.first = first
        self.keep = self.live & (lanes[None, :] < first[:, None])
        self.e_tau = _exp(-self.tau)
        self.w = torch.where(self.keep, (1.0 - self.e_tau) * self.T_in, 0.0)


def _live(sig, mask):
    return torch.ones(sig.shape, dtype=torch.bool) if mask is None else mask


def warp_forward(sig, rgb, dt, ts, mask=None, T_thresh=1e-4):
    N, S = sig.shape
    live = _live(sig, mask)
    cum = torch.zeros(N)
    walking = torch.ones(N, dtype=torch.bool)
    weights = torch.zeros((N, S))
    ws, dep, col = torch.zeros((N, LANES)), torch.zeros((N, LANES)), torch.zeros((N, LANES, 3))
    for c0 in range(0, S, LANES):
        ch = _Chunk(sig, dt, live, cum, walking, c0, S, T_thresh)
        k = ch.keep
        ws = torch.where(k, ws + ch.w, ws)
        dep = torch.where(k, dep + ch.w * _pad(ts, c0, S), dep)
        col = torch.where(k[..., None], col + ch.w[..., None] * _pad(rgb, c0, S), col)
        n = min(LANES, S - c0)
        weights[:, c0:c0 + n] = torch.where(walking[:, None], ch.w[:, :n], 0.0)
        cum = torch.where(walking, ch.carry, cum)
        walking = walking & ~ch.stops
    image = torch.stack([_xor_tree(col[..., q]) for q in range(3)], -1)
    return {"weights_sum": _xor_tree(ws), "depth": _xor_tree(dep), "image": image,
            "weights": weights}


def warp_backward(sig, rgb, dt, ts, mask, T_thresh, g_ws, g_depth, g_image, g_weights):
    N, S = sig.shape
    live = _live(sig, mask)
    gc = g_image[:, None, :]

    def slot_e(c0):
        c = _pad(rgb, c0, S)
        e = (gc[..., 0] * c[..., 0] + gc[..., 1] * c[..., 1]) + gc[..., 2] * c[..., 2]
        e = (e + g_ws[:, None]) + g_depth[:, None] * _pad(ts, c0, S)
        return e if g_weights is None else e + _pad(g_weights, c0, S)

    # pass 1: R and the stop slot
    cum, r_lane = torch.zeros(N), torch.zeros((N, LANES))
    walking = torch.ones(N, dtype=torch.bool)
    stop = torch.full((N,), S)
    for c0 in range(0, S, LANES):
        ch = _Chunk(sig, dt, live, cum, walking, c0, S, T_thresh)
        r_lane = torch.where(ch.keep, r_lane + ch.w * slot_e(c0), r_lane)
        stop = torch.where(walking & ch.stops, c0 + ch.first, stop)
        cum = torch.where(walking, ch.carry, cum)
        walking = walking & ~ch.stops
    R = _xor_tree(r_lane)
    # pass 2: the gradients before the stop, the suffix sum as R - prefix
    cum, P = torch.zeros(N), torch.zeros(N)
    walking = torch.ones(N, dtype=torch.bool)
    g_sig, g_rgb = torch.zeros((N, S)), torch.zeros((N, S, 3))
    for c0 in range(0, S, LANES):
        ch = _Chunk(sig, dt, live, cum, walking, c0, S, T_thresh, stop)
        k = ch.keep
        e = slot_e(c0)
        Pk = P[:, None] + _hillis_steele(torch.where(k, ch.w * e, 0.0))
        P = torch.where(k.any(-1), Pk[:, -1], P)
        dtau = (e * ch.e_tau) * ch.T_in - (R[:, None] - Pk)
        n = min(LANES, S - c0)
        g_sig[:, c0:c0 + n] = torch.where(k, dtau * ch.delta, 0.0)[:, :n]
        g_rgb[:, c0:c0 + n] = torch.where(k[..., None], ch.w[..., None] * gc, 0.0)[:, :n]
        cum = torch.where(walking, ch.carry, cum)
    return g_sig, g_rgb


def _torch_args(sig, rgb, dt, ts, mask):
    return T(sig), T(rgb), T(dt), T(ts), None if mask is None else T(mask)


@pytest.mark.parametrize("T_thresh", THRESHOLDS)
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("S", SIZES)
def test_warp_forward_matches_plain_and_jax(S, mask_kind, T_thresh):
    sig, rgb, dt, ts, mask = _inputs(S, mask_kind)
    args = _torch_args(sig, rgb, dt, ts, mask)
    emu = warp_forward(*args, T_thresh=T_thresh)
    # the weights are the sequential walk's, bit for bit
    seq = _sequential_weights(args[0], args[2], args[4], T_thresh)
    assert torch.equal(emu["weights"], seq)
    plain = t_comp.composite_rays_plain(*args[:4], mask=args[4], T_thresh=T_thresh)
    oj = j_comp.composite_rays(*(jnp.asarray(v) for v in (sig, rgb, dt, ts)),
                               mask=None if mask is None else jnp.asarray(mask),
                               T_thresh=T_thresh)
    for k in ("weights_sum", "depth", "image", "weights"):
        torch.testing.assert_close(emu[k], plain[k], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(emu[k].numpy(), np.asarray(oj[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    if mask_kind == "all_masked":
        assert not emu["weights"].any()
    elif T_thresh > 0:
        # the engineered rays stop after their opaque slot: at 1 (inside the
        # first chunk), 31 (the chunk's last lane) and 32 (the next chunk's first)
        for row, slot in ((0, 0), (1, 30), (2, 31)):
            if slot + 1 < S:
                assert not emu["weights"][row, slot + 1:].any() and emu["weights"][row, slot] > 0


@pytest.mark.parametrize("T_thresh", THRESHOLDS)
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("S", SIZES)
def test_warp_backward_matches_plain_and_jax(S, mask_kind, T_thresh):
    sig, rgb, dt, ts, mask = _inputs(S, mask_kind)
    N = sig.shape[0]
    cts = _cotangents(N, S)
    args = _torch_args(sig, rgb, dt, ts, mask)
    gs, gr = warp_backward(*args, T_thresh, *(T(cts[k]) for k in
                                              ("weights_sum", "depth", "image", "weights")))
    st, rt = args[0].clone().requires_grad_(True), args[1].clone().requires_grad_(True)
    out = t_comp.composite_rays_plain(st, rt, *args[2:4], mask=args[4], T_thresh=T_thresh)
    torch.autograd.backward([out[k] for k in cts], [T(v) for v in cts.values()])

    def fj(s, r):
        return j_comp.composite_rays(s, r, jnp.asarray(dt), jnp.asarray(ts),
                                     mask=None if mask is None else jnp.asarray(mask),
                                     T_thresh=T_thresh)

    _, vjp = jax.vjp(fj, jnp.asarray(sig), jnp.asarray(rgb))
    gs_j, gr_j = vjp({k: jnp.asarray(v) for k, v in cts.items()})
    if mask_kind == "all_masked":
        assert not gs.any() and not gr.any()
        assert not st.grad.any() and not np.asarray(gs_j).any()
        return
    assert rel_l2(gs.numpy(), st.grad.numpy()) <= 1e-5
    assert rel_l2(gr.numpy(), rt.grad.numpy()) <= 1e-5
    assert rel_l2(gs.numpy(), gs_j) <= 1e-5
    assert rel_l2(gr.numpy(), gr_j) <= 1e-5
    # no gradient on masked slots or past the stop
    if mask is not None:
        assert not gs[~args[4]].any() and not gr[~args[4]].any()
    w = warp_forward(*args, T_thresh=T_thresh)["weights"]
    assert not gr[w == 0].any()


def test_warp_backward_without_optional_cotangents():
    """A train step's cotangents: weights_sum and image only (the kernel
    takes the others as NULL, i.e. zero)."""
    sig, rgb, dt, ts, mask = _inputs(128, "on")
    N, S = sig.shape
    cts = _cotangents(N, S)
    args = _torch_args(sig, rgb, dt, ts, mask)
    zero_d = torch.zeros(N)
    gs, gr = warp_backward(*args, 1e-4, T(cts["weights_sum"]), zero_d, T(cts["image"]), None)
    st, rt = args[0].clone().requires_grad_(True), args[1].clone().requires_grad_(True)
    out = t_comp.composite_rays_plain(st, rt, *args[2:4], mask=args[4])
    torch.autograd.backward([out["weights_sum"], out["image"]],
                            [T(cts["weights_sum"]), T(cts["image"])])
    assert rel_l2(gs.numpy(), st.grad.numpy()) <= 1e-5
    assert rel_l2(gr.numpy(), rt.grad.numpy()) <= 1e-5


def test_a_parallel_scan_of_tau_rounds_otherwise():
    """Why the forward's sum is a serial chain: a Hillis-Steele scan of the
    same taus differs from the sequential sum in the last bits, and T_in
    with it, so a slot whose T_in sits at T_thresh would flip."""
    sig, _, dt, _, _ = _inputs(32, "off")
    tau = T(sig) * T(dt)
    seq = torch.zeros_like(tau)
    c = torch.zeros(tau.shape[0])
    for j in range(LANES):
        c = c + tau[:, j]
        seq[:, j] = c
    assert not torch.equal(_hillis_steele(tau), seq)
