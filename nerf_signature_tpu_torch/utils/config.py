"""CLI flag surface (a copy of the clean-stage half of
``nerf_signature_tpu/utils/config.py``, which the port does not import; the
watermark flags come with the watermark slice), reproducing both reference
entry points
(``main_nerf.py:12-62`` — 27 flags; ``main_nerf_wtmk.py:12-77`` — +13 wm
flags), including the ``-O`` macro (= fp16 + occupancy-grid marching +
preload) and the reference quirks we consciously keep or fix:

  * the reference force-sets ``fp16=True`` regardless of the flag
    (``main_nerf.py:75``); here ``--fp16`` maps to bf16 compute (TPU-native)
    and is honoured, with ``-O`` enabling it like upstream,
  * ``--ff`` / ``--tcnn`` are accepted but no-ops (they were in the reference
    too — the import was unconditional),
  * ``--cuda_ray`` selects the occupancy-grid marching path (the TPU
    equivalent of the CUDA marcher); the flag name is kept for CLI
    compatibility.
"""

import argparse


def add_common_args(parser: argparse.ArgumentParser):
    parser.add_argument("path", type=str)
    parser.add_argument("-O", action="store_true",
                        help="equals --fp16 --cuda_ray --preload")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--workspace", type=str, default="workspace")
    parser.add_argument("--seed", type=int, default=0)

    # training
    parser.add_argument("--iters", type=int, default=30000)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--ckpt", type=str, default="latest")
    parser.add_argument("--num_rays", type=int, default=4096)
    parser.add_argument("--cuda_ray", action="store_true",
                        help="occupancy-grid accelerated marching (TPU path)")
    parser.add_argument("--max_steps", type=int, default=1024)
    parser.add_argument("--num_steps", type=int, default=512)
    parser.add_argument("--upsample_steps", type=int, default=0)
    parser.add_argument("--update_extra_interval", type=int, default=16)
    parser.add_argument("--max_ray_batch", type=int, default=4096)
    parser.add_argument("--patch_size", type=int, default=1)
    parser.add_argument("--clip_model", type=str, default=None,
                        help="transformers CLIP model id or local path for "
                             "--clip_text guidance (default "
                             "openai/clip-vit-base-patch32)")
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help="path to a torch lpips.LPIPS(net='alex') state "
                             "dict; enables the in-graph perceptual patch "
                             "loss + LPIPS metric (default: $LPIPS_WEIGHTS "
                             "or the lpips package if importable)")

    # backbone
    parser.add_argument("--fp16", action="store_true",
                        help="low-precision compute (bf16 on TPU)")
    parser.add_argument("--ff", action="store_true", help="(no-op, parity)")
    parser.add_argument("--tcnn", action="store_true", help="(no-op, parity)")

    # dataset
    parser.add_argument("--color_space", type=str, default="srgb")
    parser.add_argument("--preload", action="store_true")
    parser.add_argument("--bound", type=float, default=2.0)
    parser.add_argument("--scale", type=float, default=0.33)
    parser.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    parser.add_argument("--dt_gamma", type=float, default=1 / 128)
    parser.add_argument("--min_near", type=float, default=0.2)
    parser.add_argument("--density_thresh", type=float, default=10)
    parser.add_argument("--bg_radius", type=float, default=-1)

    # GUI-era flags (offline viewer)
    parser.add_argument("--gui", action="store_true")
    parser.add_argument("--W", type=int, default=1920)
    parser.add_argument("--H", type=int, default=1080)
    parser.add_argument("--radius", type=float, default=5)
    parser.add_argument("--fovy", type=float, default=50)
    parser.add_argument("--max_spp", type=int, default=64)

    # experimental
    parser.add_argument("--error_map", action="store_true")
    parser.add_argument("--clip_text", type=str, default="")
    parser.add_argument("--rand_pose", type=int, default=-1)

    # TPU-native extras
    parser.add_argument("--stochastic_hash_grad", action="store_true",
                        help="exact-forward, one-corner unbiased-stochastic "
                             "hash-table gradients (~8x fewer scatter "
                             "updates, the TPU train-step wall; see PERF.md)")
    parser.add_argument("--hash_level_stride", type=int, default=1,
                        help="backward hash-gradient level subsampling "
                             "stride (1=off; 2 scatters every other level "
                             "per sample, unbiased — needs "
                             "--stochastic_hash_grad)")
    parser.add_argument("--hash_fwd_corners", type=int, default=8,
                        choices=(1, 8),
                        help="forward hash-gather corner count INSIDE the "
                             "train step only (8=exact trilinear; 1=gather "
                             "only the weight-sampled corner — unbiased "
                             "FEATURE estimate, ~8x fewer forward gather "
                             "rows; the loss gradient is of the estimator "
                             "and biased through the nonlinear field — "
                             "measured ~1 dB at equal wall-clock, PERF.md; "
                             "needs --stochastic_hash_grad; eval/render/"
                             "decode paths always stay exact; both trainers)")
    parser.add_argument("--n_levels", type=int, default=16,
                        help="hash-encoding level count (reference default "
                             "16, hash_encoding.py:60); with --n_features "
                             "this sets the table geometry — e.g. 8 levels x "
                             "4 features keeps the 32-feature encoding width "
                             "but halves the per-sample gather/scatter index "
                             "counts (the measured step wall, PERF.md)")
    parser.add_argument("--n_features", type=int, default=2,
                        help="features per hash level (reference default 2)")
    parser.add_argument("--dense_coarse", action="store_true",
                        help="tcnn-style dense (collision-free, spatially "
                             "ordered) storage for coarse hash levels — "
                             "gather-engine locality; breaks .pth table "
                             "bit-layout (ingest densifies automatically)")
    parser.add_argument("--train_budget", type=int, default=128,
                        help="static per-ray sample budget (auto-adapted)")
    parser.add_argument("--infer_budget", type=int, default=256)
    parser.add_argument("--compact_frac", type=float, default=-1,
                        help="global sample compaction: run the field on "
                             "~frac*N*S packed occupied samples instead of "
                             "the padded [N, S] budget grid (0 = off; "
                             "-1 = DEFAULT, auto-adapt from measured "
                             "occupancy — measured 2.43x on the training "
                             "step at converged-scene fill, PERF.md)")
    parser.add_argument("--grid_size", type=int, default=128)
    parser.add_argument("--t_cull", type=float, default=0.0,
                        help="transmittance cull threshold (0 = off, the "
                             "default): the march drops samples whose "
                             "PROXY entering transmittance (accumulated "
                             "from the grid's live cell densities) falls "
                             "below this — samples entering at true T < "
                             "1e-4 carry exactly zero weight AND zero "
                             "gradient (measured 46%% of samples on the "
                             "trained headline scene). 1e-5 measures 1.83x "
                             "step throughput at +0.01 dB on the 600-it "
                             "gate, but a 1200-it campaign regressed ~8 dB "
                             "when the old decayed-max proxy latched a "
                             "transient density spike (PERF.md r5 post-"
                             "mortem) — the proxy now uses live requeried "
                             "densities, and the default stays EXACT until "
                             "a long-horizon gate revalidates it. Train-"
                             "step only (fog gate until the grid's full-"
                             "update phase ends); ownership decodes, "
                             "eval/test renders and attack sweeps always "
                             "run with the cull off.")
    parser.add_argument("--group_budget", type=int, default=-1,
                        help="march coarse-group budget (prefilter path): "
                             "max coarse-occupied groups kept per ray (4 "
                             "fine candidates each). -1 = DEFAULT, "
                             "auto-adapt to the power-of-two bucket >= 1.5x "
                             "the measured mean occupied-group count (same "
                             "rule and truncation class as the march "
                             "budget); 0 = the static formula "
                             "max(64, budget//2); >0 = fixed. Exactness-"
                             "contract paths force prefilter off and are "
                             "unaffected.")
    parser.add_argument("--devices", type=int, default=0,
                        help="shard rays over N devices (0 = all available)")
    parser.add_argument("--mesh_resolution", type=int, default=256)
    parser.add_argument("--mesh_only", action="store_true",
                        help="with --test: skip eval/test renders and only "
                             "export the marching-cubes mesh")
    parser.add_argument("--steps_per_dispatch", type=int, default=0,
                        help=">0: fully on-device lax.scan training loop "
                             "with K steps per dispatch (uniform sampling)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the plain PyTorch versions of "
                             "the kernels); default is the CUDA GPU")
    parser.add_argument("--save_interval", type=int, default=10,
                        help="checkpoint every N epochs/dispatches; a FULL "
                             "save fetches params+EMA+opt state off the "
                             "device (~280 MB at headline scale), so raise "
                             "this on slow transports")
    parser.add_argument("--profile", action="store_true",
                        help="dump a jax.profiler trace of the first training "
                             "steps to <workspace>/profile")
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="enable jax_debug_nans (the reference's "
                             "commented torch set_detect_anomaly, "
                             "main_nerf.py:8)")
    # prewatermarking baseline (2D-watermark-then-train; ref stale snapshot
    # utils_wtmk_pre-checkpoint.py / NeRFDataset_Prewatermarking)
    parser.add_argument("--prewatermark", action="store_true",
                        help="embed a HiDDeN 2D watermark into the training "
                             "images before NeRF training; --test decodes it "
                             "from rendered views and reports bit accuracy")
    parser.add_argument("--prewatermark_bits", type=int, default=16)
    parser.add_argument("--prewatermark_steps", type=int, default=600,
                        help="HiDDeN encoder/decoder pretraining steps")
    parser.add_argument("--prewatermark_strength", type=float, default=0.1)
    return parser


def apply_O_macro(opt):
    if opt.O:
        opt.fp16 = True
        opt.cuda_ray = True
        opt.preload = True
    if opt.patch_size > 1:
        opt.error_map = False
        assert opt.num_rays % (opt.patch_size**2) == 0
    return opt
