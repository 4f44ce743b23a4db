"""Port parity of the prewatermark baseline (``--prewatermark``): the HiDDeN
encoder and single-view decoder (``train=True`` with the running statistics'
update, ``train=False`` on them), one ``pretrain_hidden`` step on the same
crops, bits and noise, ``watermark_images`` and ``bit_survival``, each
against the JAX package on JAX's init converted (CPU), and the port's CLI:
``main_nerf --prewatermark`` trains and writes ``prewatermark.ckpt``,
``--test --prewatermark`` reports the bit survival, and each package reads
the other's file.  Tiny sizes: 16 x 16 images, 8 channels, 2 blocks (the
CLI: 16 x 16 views, the default 64 channels).

Tolerances and why (fp32, absolute unless stated):
  * encoder residual and decoder logits 1e-5, running statistics 1e-6
    relative: the convs sum in another order through the batch norms;
    measured 8.6e-7 (residual), 1.2e-7 (logits) and 1.6e-7 (statistics).
  * the pretrain step: loss 1e-5 relative and the decoder's running
    statistics 1e-5 relative; Adam's first step (eps 1e-8) moves every entry
    by about lr * sign(g), so each leaf's entries agree within 1e-6 where
    the gradient is not at rounding level: at least 99 % of them, with the
    conv biases before a batch norm (zero gradient in exact arithmetic)
    left out.
  * watermarked images 1e-5 (measured 1.8e-7); the bit survival equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_signature_tpu.models import hidden as j_hidden
from nerf_signature_tpu.train import prewatermark as j_pre
from nerf_signature_tpu_torch.models import hidden as t_hidden
from nerf_signature_tpu_torch.train import checkpoint as t_ckpt
from nerf_signature_tpu_torch.train import prewatermark as t_pre

T = torch.from_numpy
D = 8
CH = 8


def _cfgs(blocks=2):
    return (j_hidden.HiddenEncoderConfig(num_bits=D, channels=CH, num_blocks=blocks),
            t_hidden.HiddenEncoderConfig(num_bits=D, channels=CH, num_blocks=blocks),
            j_hidden.HiddenDecoderSingleConfig(num_blocks=blocks, num_bits=D, channels=CH),
            t_hidden.HiddenDecoderSingleConfig(num_blocks=blocks, num_bits=D, channels=CH))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_init(seed=0, blocks=2):
    """JAX's pretrain init (``k_enc, k_dec = split(PRNGKey(seed))``), numpy."""
    jec, _, jdc, _ = _cfgs(blocks)
    k_enc, k_dec = jax.random.split(jax.random.PRNGKey(seed))
    dp, ds = j_hidden.init_hidden_decoder_single(k_dec, jdc)
    return _np(j_hidden.init_hidden_encoder(k_enc, jec)), _np(dp), _np(ds)


def _images(n=6, h=16, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, h, h, 3)).astype(np.float32)


def test_encoder_matches_jax():
    jec, tec, *_ = _cfgs()
    enc, _, _ = _jax_init()
    imgs = _images(4)
    bits = np.random.default_rng(1).integers(0, 2, (4, D)).astype(np.float32)
    rj = np.asarray(j_hidden.hidden_encoder_apply(enc, jec, jnp.asarray(imgs), jnp.asarray(bits)))
    rt = t_hidden.hidden_encoder_apply(t_ckpt.conv_tree_from_jax(enc), tec, T(imgs), T(bits))
    assert rt.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(rt.numpy(), rj, rtol=0, atol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_single_decoder_matches_jax(train):
    *_, jdc, tdc = _cfgs()
    _, dp, ds = _jax_init()
    rng = np.random.default_rng(2)
    ds = {"bn": [{"mean": rng.normal(size=s["mean"].shape).astype(np.float32) * 0.1,
                  "var": rng.uniform(0.5, 2.0, size=s["var"].shape).astype(np.float32)}
                 for s in ds["bn"]]}
    x = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    lj, sj = j_hidden.hidden_decoder_single_apply(dp, ds, jdc, jnp.asarray(x), train=train)
    lt, st = t_hidden.hidden_decoder_single_apply(
        t_ckpt.conv_tree_from_jax(dp), t_ckpt.conv_tree_from_jax(ds), tdc, T(x), train=train)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-5)
    for a, b, s0 in zip(st["bn"], sj["bn"], ds["bn"]):
        for k in ("mean", "var"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), rtol=1e-6, atol=1e-7)
            # train: moved by the momentum towards the batch's (biased)
            # statistics; eval: the running ones, as they were
            assert np.array_equal(a[k].numpy(), s0[k]) != train


def test_pretrain_step_matches_jax():
    """One step of each package from the same init, on the same crops and
    bits (both draw them from ``default_rng(seed)``) and JAX's noise."""
    jec, tec, jdc, tdc = _cfgs()
    imgs = _images(6, 20)
    logs_j, logs_t = [], []
    kw = dict(steps=1, crop=16, batch=4, seed=3, channels=CH, dec_blocks=2, enc_blocks=2)
    enc_j, dec_j, _, _ = j_pre.pretrain_hidden(imgs, D, log=logs_j.append, **kw)
    enc0, dp0, ds0 = _jax_init(seed=3)
    init = (t_ckpt.conv_tree_from_jax(enc0), *t_ckpt.conv_tree_from_jax([dp0, ds0]))
    noise = lambda i, shape: T(np.asarray(jax.random.normal(  # noqa: E731
        jax.random.PRNGKey(3 * 100003 + i), tuple(shape))))
    enc_t, dec_t, _, _ = t_pre.pretrain_hidden(imgs, D, log=logs_t.append, init=init,
                                               noise=noise, **kw)
    loss = [float(s.split("loss=")[1].split()[0]) for s in (logs_j[0], logs_t[0])]
    assert abs(loss[1] - loss[0]) <= 1e-5 * abs(loss[0]) + 1e-4  # logged to 4 decimals
    for a, b in zip(jax.tree_util.tree_leaves(t_ckpt.conv_tree_to_jax(dec_t["state"])),
                    jax.tree_util.tree_leaves(dec_j["state"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-7)
    trees = ((t_ckpt.conv_tree_to_jax(enc_t), enc_j, enc0),
             (t_ckpt.conv_tree_to_jax(dec_t["params"]), dec_j["params"], dp0))
    for tt, tj, t0 in trees:
        flat = jax.tree_util.tree_flatten_with_path(tj)[0]
        for (path, b), a, a0 in zip(flat, jax.tree_util.tree_leaves(tt),
                                    jax.tree_util.tree_leaves(t0)):
            name = jax.tree_util.keystr(path)
            if name.endswith("['conv']['b']"):
                continue  # a conv bias before a batch norm
            b = np.asarray(b)
            assert not np.array_equal(a, a0), name
            assert np.mean(np.abs(a - b) <= 1e-6) >= 0.99, name


def test_watermark_images_and_bit_survival_match_jax():
    jec, tec, jdc, tdc = _cfgs()
    enc, dp, ds = _jax_init(seed=5)
    imgs = np.concatenate([_images(5, seed=6), np.ones((5, 16, 16, 1), np.float32)], -1)
    msg = np.random.default_rng(7).integers(0, 2, D)
    wj = j_pre.watermark_images(enc, jec, imgs, msg)
    wt = t_pre.watermark_images(t_ckpt.conv_tree_from_jax(enc), tec, imgs, msg)
    assert wt.shape == (5, 16, 16, 3) and wt.min() >= 0 and wt.max() <= 1
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-5)
    assert np.abs(wt - imgs[..., :3]).max() > 1e-3  # the mark is there
    dec_j = {"params": dp, "state": ds}
    acc_j, per_j = j_pre.bit_survival(dec_j, jdc, wj, msg)
    acc_t, per_t = t_pre.bit_survival(t_ckpt.conv_tree_from_jax(dec_j), tdc, wj, msg)
    assert per_t == per_j and acc_t == acc_j


def test_cli_prewatermark_trains_tests_and_files_cross(tmp_path):
    """The port's CLI: --prewatermark trains (its file in JAX's keys, which
    JAX's reader restores), then --test --prewatermark reports the bit
    survival; a file JAX's trainer wrote, the port's reader decodes with
    JAX's bit survival."""
    import glob
    import json

    from PIL import Image

    from nerf_signature_tpu.train import checkpoint as j_ckpt
    from nerf_signature_tpu_torch import main_nerf as t_main
    from nerf_signature_tpu_torch.train.trainer import write_png
    from test_torch_wm_io import write_scene

    scene = write_scene(str(tmp_path / "scene"))
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        with open(os.path.join(scene, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        for fr in meta["frames"]:
            write_png(os.path.join(scene, fr["file_path"] + ".png"),
                      rng.integers(0, 255, (meta["h"], meta["w"], 3), dtype=np.uint8))
        if split == "test":
            with open(os.path.join(scene, "transforms_val.json"), "w") as f:
                json.dump(meta, f)
    ws = str(tmp_path / "ws")
    flags = [scene, "--workspace", ws, "--cpu", "-O", "--grid_size", "16", "--num_rays", "32",
             "--bound", "1.0", "--scale", "1.0", "--dt_gamma", "0", "--min_near", "0.05",
             "--density_thresh", "0.01", "--train_budget", "16", "--infer_budget", "16",
             "--max_steps", "64", "--n_levels", "2", "--prewatermark", "--prewatermark_bits",
             str(D), "--prewatermark_steps", "2", "--mesh_resolution", "16"]
    assert t_main.main(flags + ["--iters", "4"]) == 0
    path = os.path.join(ws, "prewatermark.ckpt")
    art = j_ckpt.load_checkpoint(path)
    assert int(art["num_bits"]) == D and int(art["dec_blocks"]) == 8
    assert int(art["channels"]) == 64 and art["message"].shape == (D,)
    # JAX's reader (the root CLI's --test --prewatermark) restores the decoder
    jdc = j_hidden.HiddenDecoderSingleConfig(num_blocks=8, num_bits=D, channels=64)
    tp, ts = j_hidden.init_hidden_decoder_single(jax.random.PRNGKey(0), jdc)
    dec_j = j_ckpt.restore_like({"params": tp, "state": ts}, art["decoder"])
    assert np.asarray(dec_j["params"]["blocks"][0]["conv"]["w"]).shape == (3, 3, 3, 64)
    assert t_main.main(flags + ["--test"]) == 0
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    line = [s for s in log.splitlines() if "[prewatermark] bit survival" in s][-1]
    frames = [np.asarray(Image.open(p))
              for p in sorted(glob.glob(os.path.join(ws, "results", "ngp_*_rgb.png")))]
    assert frames
    acc_j, per_j = j_pre.bit_survival(dec_j, jdc, np.stack(frames).astype(np.float32) / 255.0,
                                      art["message"])
    assert f"over {len(per_j)} rendered views: {acc_j:.4f}" in line
    # a file in JAX's layout (the root CLI's save) read by the port's reader
    enc, dec, _, _ = j_pre.pretrain_hidden(np.stack(frames)[..., :3].astype(np.float32) / 255.0,
                                           D, steps=1, crop=16, batch=2, log=None)
    j_ckpt.save_checkpoint(path, {"decoder": dec, "encoder": enc, "message": art["message"],
                                  "dec_blocks": 8, "channels": 64, "num_bits": D})
    opt = t_main.argparse.Namespace(workspace=ws, prewatermark_bits=D)
    acc_t, per_t = t_main.prewatermark_survival(opt, frames, "cpu")
    acc_j, per_j = j_pre.bit_survival(dec, jdc, np.stack(frames).astype(np.float32) / 255.0,
                                      art["message"])
    assert per_t == per_j and acc_t == acc_j
