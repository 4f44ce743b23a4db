"""On-device K-step train loops (counterpart of
``nerf_signature_tpu/train/device_loop.py`` and the watermark stage's
``_wm_device_loop``): ``--steps_per_dispatch K``.

The dataset (poses, images or the pseudo-GT pool, intrinsics) is preloaded
to the device, and each step samples its pose and pixels there, makes its
rays there (``rays_from_pixels``), renders, takes the loss, and runs
backward, Adam at ``lr * 0.1 ** min(count / iters, 1)`` and the EMA, with no
value read back to the host inside a dispatch.

Randomness: each dispatch draws its steps' random numbers up front into
static [K, ...] device buffers from the model's ``torch.Generator`` (pose
index, pixels -- patch-structured with a uniform tail under the SSIM patch
guard --, background (none with the bg-sphere model), march noise, the
error map's three uniforms; in the watermark stage the message and the
distortion's draws), and step i reads
row i through a step counter that lives on the device.  A test can fill the
buffers with JAX's draws instead.  The grid update draws its own, as
``update_extra_state`` does.  With ``--error_map`` a step samples its pixels
from its pose's row of the coarse error map (``sample_error_map``) and
writes the row's EMA back, both on the device: the map is a static
[P, 128*128] tensor the step reads and writes.

On the card a dispatch replays a CUDA graph of one whole step (``StepGraph``):
two eager warm-up steps on a side stream (the one-time set-up a capture may
not do: the kernels' shared-memory attributes, per-device constants, library
handles), then a capture, then one replay a step; Adam runs ``capturable``
with its state made up front and its lr a device tensor that the schedule
computes from Adam's device step count.  The grid update, every ``update_interval`` steps,
runs eagerly between two replays on the same stream and writes into the
grid's own tensors, which the graph reads.  The graph holds the objects it
was captured on (the data, the draw buffers, the grid), so none of their
tensors is freed under it, but not the step's closure, which would tie it in
a cycle to its trainer and leave its release (illegal while another graph is
captured) to the garbage collector.  A change of shape (the march budget, the compaction's Mc,
the group budget), of the data, the draw buffers or the grid captures the
step again; whatever replaces the trainer's own tensors (``prepare_device_loop``,
a checkpoint's load) drops the graph first.  At most one graph is alive.  If
the capture fails on the card the run raises.  On the CPU (only when the caller asked for it) the
same step runs eagerly, K times.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import _cuda
from ..ops.grid import _set_last_wins

WARMUP_STEPS = 2
SSIM_WITH_ERROR_MAP = ("--lambda_ssim patch sampling and --error_map importance "
                       "sampling are mutually exclusive in the scan loop")


class DeviceData(NamedTuple):
    """A loader's views preloaded to the device: poses [P, 4, 4], images
    [P, H*W, C] (C = 3 or 4), intrinsics [4] (fx, fy, cx, cy)."""

    poses: torch.Tensor
    images: torch.Tensor
    intrinsics: torch.Tensor
    H: int
    W: int


def preload(poses, images, intrinsics, H, W, device):
    """``DeviceData`` from a loader's numpy poses, images [P, H, W, C] (or
    [P, H*W, C]) and intrinsics."""
    P = len(poses)
    f32 = np.float32
    images = np.asarray(images, f32)
    return DeviceData(
        torch.as_tensor(np.asarray(poses, f32), device=device),
        torch.as_tensor(images.reshape(P, -1, images.shape[-1]), device=device),
        torch.as_tensor(np.asarray(intrinsics, f32), device=device),
        int(H), int(W))


def rays_from_pixels(pose, intrinsics, pix, H, W):
    """Rays of flat pixel indices: pose [4, 4], intrinsics [4] tensor (fx,
    fy, cx, cy), pix [N] int in [0, H*W) -> (rays_o, rays_d) [N, 3]."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    i = torch.remainder(pix, W).to(torch.float32) + 0.5
    j = torch.div(pix, W, rounding_mode="floor").to(torch.float32) + 0.5
    xs = (i - cx) / fx
    ys = (j - cy) / fy
    dirs = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_d = dirs @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand(rays_d.shape).contiguous()
    return rays_o, rays_d.contiguous()


def percentile_weights(n, q=95.0):
    """``jnp.percentile``'s linear interpolation over n sorted values: (low,
    high, low weight, high weight), the position computed in float32."""
    f32 = np.float32
    pos = f32(f32(q) / f32(100.0)) * f32(n - 1)
    low, high = np.floor(pos), np.ceil(pos)
    hw = f32(pos - low)
    return int(min(max(low, 0), n - 1)), int(min(max(high, 0), n - 1)), float(f32(1.0) - hw), \
        float(hw)


def p95(x):
    """The 95th percentile of x [n] (float32), as ``jnp.percentile``."""
    lo, hi, lw, hw = percentile_weights(x.shape[0])
    s = torch.sort(x.to(torch.float32)).values
    return s[lo] * lw + s[hi] * hw


# ------------------------------------------------------------- the optimizer
class DeviceSchedule:
    """``lr * 0.1 ** min(count / iters, 1)`` on the device, in float32, from
    Adam's device step count (the host's ``make_lr_schedule`` computes the
    same in numpy)."""

    def __init__(self, lr, iters, device):
        def full(v):
            return torch.full((), v, dtype=torch.float32, device=device)

        self.lr, self.iters, self.tenth = full(lr), full(iters), full(0.1)

    def __call__(self, count):
        frac = torch.clamp_max(count / self.iters, 1.0)
        return self.lr * torch.pow(self.tenth, frac)


def make_capturable(optimizer, device):
    """Switch Adam to its capturable form: the lr a device tensor, each
    leaf's step count on the device (a checkpoint loads it on the host)."""
    for group in optimizer.param_groups:
        group["capturable"] = True
        if not torch.is_tensor(group["lr"]):
            group["lr"] = torch.full((), group["lr"], dtype=torch.float32, device=device)
    for state in optimizer.state.values():
        if "step" in state:
            state["step"] = state["step"].to(device=device, dtype=torch.float32)


def adam_step(optimizer, count, device):
    """Adam's step count as its state holds it: a host tensor, or a device
    one where Adam is capturable."""
    t = torch.tensor(float(count), dtype=torch.float32)
    return t.to(device) if optimizer.param_groups[0].get("capturable") else t


def prepare_device_loop(trainer, leaves):
    """Before a trainer's dispatches: the grid's update count read once
    (the host counts them from then on) and, on the card, Adam capturable
    with its state made now (zeros, step 0, as its first step would make
    them), so that the state a capture reads exists before it, and the
    device lr schedule."""
    m = trainer.model
    drop_graph(trainer)
    trainer.grid_updates = int(m.occ.iter_density)
    if m.device.type != "cuda":
        return
    opt = trainer.optimizer
    make_capturable(opt, m.device)
    for p in leaves:
        if not opt.state.get(p):
            opt.state[p] = {"step": torch.zeros((), dtype=torch.float32, device=m.device),
                            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                            "exp_avg_sq": torch.zeros_like(p,
                                                           memory_format=torch.preserve_format)}
    trainer.device_schedule = DeviceSchedule(trainer.opt.lr, trainer.opt.iters, m.device)


def set_lr(optimizer, first_leaf, schedule, device_schedule=None):
    """The lr of the next Adam step from the steps taken so far: on the
    host from Adam's count, or, where Adam is capturable (the lr a device
    tensor), on the device from its step count with no read-back."""
    state = optimizer.state.get(first_leaf)
    lr = optimizer.param_groups[0]["lr"]
    if torch.is_tensor(lr):
        if state:
            lr.copy_(device_schedule(state["step"]))
        else:
            lr.fill_(schedule(0))
        return
    value = schedule(int(state["step"]) if state else 0)
    for group in optimizer.param_groups:
        group["lr"] = value


# ---------------------------------------------------------------- the graph
class StepGraph:
    """At most one live CUDA graph of one train step.  It holds the objects
    the step was captured on (``held``: the data, the draw buffers, the
    grid), so their tensors stay alive as long as the graph; the trainer's
    own tensors live with the trainer, and whatever replaces them drops the
    graph (``drop_graph``).  The kernel launches its capture recorded are
    added to the launch counts once a replay."""

    def __init__(self):
        self.captures = 0
        self.drop()

    def drop(self):
        """Free the graph (and, with it, its memory pool) and what it held."""
        self.graph, self.key, self.held, self.launches = None, None, (), {}

    def fits(self, key, held):
        return (self.graph is not None and self.key == key and len(held) == len(self.held)
                and all(a is b for a, b in zip(held, self.held)))

    def run(self, body, key, held, n, before_step=None):
        """Run ``body`` (one step) n times on the card: replays of a graph
        captured under ``key`` on the objects ``held`` (compared by
        identity), captured now (after up to WARMUP_STEPS eager steps) when
        either differs.  ``before_step(j)`` runs eagerly before step j."""
        j = 0
        if not self.fits(key, held):
            self.drop()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                while j < min(WARMUP_STEPS, n):
                    if before_step is not None:
                        before_step(j)
                    body()
                    j += 1
            torch.cuda.current_stream().wait_stream(side)
            if j == n:
                return
            graph = torch.cuda.CUDAGraph()
            with _cuda.capturing() as launches:
                with torch.cuda.graph(graph):
                    body()
            self.graph, self.key, self.held = graph, key, tuple(held)
            self.launches = launches
            self.captures += 1
        for j in range(j, n):
            if before_step is not None:
                before_step(j)
            self.graph.replay()
            _cuda.count_replay(self.launches)


def drop_graph(trainer):
    """Drop a trainer's live graph: before its params, Adam state, lr or
    schedule tensors are replaced."""
    if getattr(trainer, "step_graph", None) is not None:
        trainer.step_graph.drop()


def run_steps(owner, body, key, held, n, device, before_step=None):
    """n steps of ``body``: graph replays on the card (``owner.step_graph``),
    eagerly on the CPU."""
    if torch.device(device).type == "cuda":
        if getattr(owner, "step_graph", None) is None:
            owner.step_graph = StepGraph()
        owner.step_graph.run(body, key, held, n, before_step)
        return
    for j in range(n):
        if before_step is not None:
            before_step(j)
        body()


# ------------------------------------------------------------- clean stage
EM_RES = 128  # the error map's side: [P, EM_RES**2] coarse cells


def sample_error_map(em_row, u, H, W, coarse=EM_RES):
    """Importance sampling over one pose's coarse error map (JAX's
    ``sample_error_map``): cells drawn in proportion to their error by
    inverse CDF, with replacement, then jittered into full resolution.
    em_row [coarse**2]; u [3, N] U[0, 1) (the CDF draw, the row and column
    jitter).  Returns (pix [N], inds_coarse [N]) int64."""
    cdf = torch.cumsum(em_row, dim=0)
    inds = torch.clamp(torch.searchsorted(cdf, u[0] * cdf[-1]), 0, coarse * coarse - 1)
    ix = torch.div(inds, coarse, rounding_mode="floor").to(torch.float32)
    iy = torch.remainder(inds, coarse).to(torch.float32)
    sx, sy = H / coarse, W / coarse
    ix = torch.clamp_max((ix * sx + u[1] * sx).to(torch.int64), H - 1)
    iy = torch.clamp_max((iy * sy + u[2] * sy).to(torch.int64), W - 1)
    return ix * W + iy, inds


def update_error_map_(em, pidx, inds, err):
    """The EMA at the sampled cells of pose ``pidx`` ([1] int64):
    ``0.1 * em + 0.9 * err``, a repeated cell taking its last sample's
    error (last-wins, as a sequential scatter), in place, no read-back."""
    row = em.index_select(0, pidx)[0]
    _set_last_wins(row, inds, 0.1 * row[inds] + 0.9 * err)
    em.index_copy_(0, pidx, row[None])


def patch_pixels(k, N, pp, H, W, generator, device):
    """[k, N] pixels: N // pp**2 patches of pp x pp at corners drawn in
    [0, H - pp) x [0, W - pp), the rest uniform over the image (JAX's
    patch-structured draws, ``device_loop.py:150-165``)."""
    g = dict(generator=generator, device=device)
    npatch = N // (pp * pp)
    tx = torch.randint(0, H - pp, (k, npatch), **g)
    ty = torch.randint(0, W - pp, (k, npatch), **g)
    rest = torch.randint(0, H * W, (k, N - npatch * pp * pp), **g)
    return patch_grid(tx, ty, pp, W, rest)


def patch_grid(tx, ty, pp, W, rest):
    """Flat pixels of patches at corners (tx, ty) [k, npatch], row-major
    within a patch, followed by the tail ``rest`` [k, r]."""
    pi, pj = torch.meshgrid(torch.arange(pp), torch.arange(pp), indexing="ij")
    off = (pi.reshape(-1) * W + pj.reshape(-1)).to(tx.device)
    pix = ((tx * W + ty)[..., None] + off).reshape(tx.shape[0], -1)
    return torch.cat([pix, rest.to(pix.dtype)], dim=-1)


class CleanDraws(NamedTuple):
    """One dispatch's draws: pose index [K], pixels [K, N] (int64; None when
    the error map draws them), the random background [K, N, 3] (None
    without alpha), the march noise [K, N] and the error map's uniforms
    [K, 3, N] (None without the map)."""

    pidx: torch.Tensor
    pix: Optional[torch.Tensor]
    bg: Optional[torch.Tensor]
    noise: torch.Tensor
    em_u: Optional[torch.Tensor] = None


def draw_clean(generator, k, P, N, HW, has_alpha, device, *, patch=None, error_map=False):
    """``CleanDraws`` of k steps from ``generator``.  ``patch``: (pp, H, W)
    for patch-structured pixels; ``error_map``: draw the map's uniforms
    instead of pixels."""
    g = dict(generator=generator, device=device)
    pidx = torch.randint(0, P, (k,), **g)
    em_u = None
    if error_map:
        pix = None
        em_u = torch.rand((k, 3, N), **g)
    elif patch is not None:
        pix = patch_pixels(k, N, *patch, generator, device)
    else:
        pix = torch.randint(0, HW, (k, N), **g)
    bg = torch.rand((k, N, 3), **g) if has_alpha else None
    return CleanDraws(pidx, pix, bg, torch.rand((k, N), **g), em_u)


class LoopStats(NamedTuple):
    """A clean dispatch's statistics, as JAX's loop returns them: the losses
    [k], the mean post-cull ``n_occupied``, the max over steps of the
    per-step p95 of ``n_occupied_raw``, the mean ``n_groups_occ`` and the
    mean ``n_occupied_raw``."""

    losses: np.ndarray
    mean_occupied: float
    occ_p95: float
    mean_groups_occ: float
    mean_occupied_raw: float


class _Buffers:
    """Static device buffers of a loop: the draws (K rows each), the step
    counter, the per-step statistics and the white background of images
    without alpha."""

    def __init__(self, draws, n_stats, device):
        self.draws = type(draws)(*(None if t is None else torch.empty_like(t, device=device)
                                   for t in draws))
        self.i = torch.zeros((1,), dtype=torch.int64, device=device)
        self.ones = torch.ones((1, 3), dtype=torch.float32, device=device)
        self.stats = torch.zeros((draws[0].shape[0], n_stats), dtype=torch.float32,
                                 device=device)

    def fits(self, draws):
        """Whether these draws fit: the same fields, the same shapes but
        for as many steps or fewer (a dispatch shorter than the last)."""
        return all((a is None) == (b is None) and (
            a is None or (a.shape[1:] == b.shape[1:] and a.shape[0] >= b.shape[0]))
                   for a, b in zip(self.draws, draws))

    def load(self, draws, k):
        for dst, src in zip(self.draws, draws):
            if dst is not None:
                dst[:k].copy_(src[:k])
        self.i.zero_()

    def row(self, name):
        """This step's row of a draw buffer."""
        return getattr(self.draws, name).index_select(0, self.i)[0]


def _buffers(owner, attr, draws, n_stats, device):
    """The owner's static buffers for these draws' shapes (made anew, and
    the graph with them, when the shapes change or a dispatch is longer)."""
    buf = getattr(owner, attr, None)
    if buf is None or not buf.fits(draws):
        buf = _Buffers(draws, n_stats, device)
        setattr(owner, attr, buf)
    return buf


def _grid_update_hook(trainer, step0, update_interval, grid_full_until, grid_draws):
    """Before step j: the grid update at ``step % update_interval == 0``
    (full while fewer than ``grid_full_until`` updates are done, counted
    on the host), in place, on the current params."""
    m = trainer.model

    def before(j):
        step = step0 + j
        if step % update_interval:
            return
        full = trainer.grid_updates < grid_full_until
        m.update_extra_state(full=full,
                             draws=None if grid_draws is None else grid_draws(step, full))
        trainer.grid_updates += 1

    return before


def device_train_loop(trainer, data: DeviceData, n_steps, *, draws=None, grid_draws=None,
                      update_interval=16, grid_full_until=16, error_map=None):
    """``n_steps`` clean train steps of ``trainer`` (``Trainer``) on
    ``data``, from step ``trainer.global_step``.  ``draws``: the steps'
    ``CleanDraws`` (drawn from the model's generator when None);
    ``grid_draws(step, full)``: a grid update's ``GridDraws`` (drawn from the
    generator when None).  ``error_map``: the [P, 128*128] device map to
    sample pixels from and EMA-update, in place (``--error_map``).  With
    the SSIM patch guard on (``trainer.lambda_ssim``) the pixels are
    patch-structured.  ``trainer.grid_updates`` counts the grid's updates
    on the host.  Returns ``LoopStats``; the params, EMA, Adam state, the
    grid and the error map are updated in place."""
    m = trainer.model
    dev = m.device
    N = trainer.opt.num_rays
    P, HW, C = data.images.shape
    if trainer.grid_updates is None:
        trainer.grid_updates = int(m.occ.iter_density)
    pp = trainer.patch_size if trainer.lambda_ssim > 0 else 1
    if pp > 1 and error_map is not None:
        raise RuntimeError(SSIM_WITH_ERROR_MAP)
    if draws is None:
        # the bg-sphere model draws no random background (JAX's loop)
        draws = draw_clean(m.generator, n_steps, P, N, HW, C == 4 and not m.cfg.bg_radius > 0,
                           dev, patch=(pp, data.H, data.W) if pp > 1 else None,
                           error_map=error_map is not None)
    buf = _buffers(trainer, "_loop_buffers", draws, 5, dev)
    buf.load(draws, n_steps)
    rc, budget = trainer._rc_train(), m.train_budget
    flat_images = data.images.reshape(-1, C)

    def body():
        i = buf.i
        pidx = buf.draws.pidx.index_select(0, i)
        if error_map is not None:
            pix, inds = sample_error_map(error_map.index_select(0, pidx)[0], buf.row("em_u"),
                                         data.H, data.W)
        else:
            pix = buf.row("pix")
        rays_o, rays_d = rays_from_pixels(data.poses.index_select(0, pidx)[0], data.intrinsics,
                                          pix, data.H, data.W)
        images = flat_images.index_select(0, pidx * HW + pix)
        bg = buf.row("bg") if buf.draws.bg is not None else buf.ones
        loss, per_ray, n_occ, n_raw, n_groups = trainer._train_step(
            rays_o, rays_d, images, bg, buf.row("noise"), rc, budget)
        if error_map is not None:
            update_error_map_(error_map, pidx, inds, per_ray)
        row = torch.stack([loss, n_occ.float().mean(), p95(n_raw), n_groups.float().mean(),
                           n_raw.float().mean()])
        buf.stats.index_copy_(0, i, row[None])
        i.add_(1)

    held = (data, buf, m.occ) + (() if error_map is None else (error_map,))
    run_steps(trainer, body, (budget, rc, N), held, n_steps, dev,
              _grid_update_hook(trainer, trainer.global_step, update_interval,
                                grid_full_until, grid_draws))
    stats = buf.stats[:n_steps].cpu().numpy()
    return LoopStats(stats[:, 0].copy(), float(np.float32(stats[:, 1].mean())),
                     float(stats[:, 2].max()), float(np.float32(stats[:, 3].mean())),
                     float(np.float32(stats[:, 4].mean())))


# --------------------------------------------------------- watermark stage
class WmDraws(NamedTuple):
    """One watermark dispatch's draws: the messages [K, D] (int32 0/1), the
    pose index [K] and pixels [K, N] into the pseudo-GT pool, and the
    distortion's draws stacked [K, ...] (None for ``none``)."""

    message: torch.Tensor
    pidx: torch.Tensor
    pix: torch.Tensor
    distortion: Optional[torch.Tensor]


def draw_wm(generator, k, D, P, N, HW, distortion, view_shape, device, *, patch=None):
    """``WmDraws`` of k steps from ``generator``; ``patch``: (pp, H, W) for
    patch-structured content pixels."""
    from ..utils.image import distortion_draws

    g = dict(generator=generator, device=device)
    message = torch.randint(0, 2, (k, D), **g).to(torch.int32)
    pidx = torch.randint(0, P, (k,), **g)
    if patch is not None:
        pix = patch_pixels(k, N, *patch, generator, device)
    else:
        pix = torch.randint(0, HW, (k, N), **g)
    dist = [distortion_draws(distortion, view_shape, generator, device) for _ in range(k)]
    return WmDraws(message, pidx, pix, None if dist[0] is None else torch.stack(dist))


def wm_device_loop(trainer, data: DeviceData, rays_o_b, rays_d_b, n_steps, *, draws=None):
    """``n_steps`` watermark steps of ``trainer`` (``WatermarkTrainer``):
    the key blocks ``rays_*_b`` (static bundles on the device) and content
    rays sampled from the pseudo-GT pool ``data``.  lambda_w is the device
    scalar ``trainer.lambda_w_t`` (set before the dispatch), so the polish
    phase changes it without a new capture.  With ``--patch_size`` the
    content pixels are patch-structured (JAX's ``trainer_wtmk.py:290-306``).
    Returns (losses, lossws, lossis), numpy [n_steps]."""
    from .trainer_wtmk import view_batch_shape

    m = trainer.model
    dev = m.device
    N = trainer.opt.num_rays
    P, HW, _ = data.images.shape
    if draws is None:
        pp = trainer.patch_size
        draws = draw_wm(m.generator, n_steps, m.wcfg.message_dim, P, N, HW,
                        trainer.distortion, view_batch_shape(rays_o_b.shape), dev,
                        patch=(pp, data.H, data.W) if pp > 1 else None)
    buf = _buffers(trainer, "_loop_buffers", draws, 3, dev)
    buf.load(draws, n_steps)
    if trainer.lambda_w_t is None:
        trainer.lambda_w_t = torch.zeros((), dtype=torch.float32, device=dev)
    trainer.lambda_w_t.fill_(trainer.lambda_w)
    flat_images = data.images.reshape(-1, 3)

    def body():
        i = buf.i
        pidx = buf.draws.pidx.index_select(0, i)
        pix = buf.row("pix")
        ct_o, ct_d = rays_from_pixels(data.poses.index_select(0, pidx)[0], data.intrinsics,
                                      pix, data.H, data.W)
        ct_gt = flat_images.index_select(0, pidx * HW + pix)
        dist = buf.row("distortion") if buf.draws.distortion is not None else None
        loss, lossw, lossi, _ = trainer._train_step(
            rays_o_b, rays_d_b, ct_o, ct_d, ct_gt, buf.row("message"), dist, m.rc,
            lambda_w=trainer.lambda_w_t)
        buf.stats.index_copy_(0, i, torch.stack([loss, lossw, lossi])[None])
        i.add_(1)

    key = (m.rc, trainer.content_budget, m.infer_budget, trainer.lambda_i,
           trainer.lambda_msg_reg, trainer.distortion)
    run_steps(trainer, body, key, (data, buf, m.occ, m.backbone, rays_o_b, rays_d_b), n_steps,
              dev)
    stats = buf.stats[:n_steps].cpu().numpy()
    return stats[:, 0].copy(), stats[:, 1].copy(), stats[:, 2].copy()
