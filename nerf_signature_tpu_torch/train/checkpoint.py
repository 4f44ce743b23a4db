"""Checkpoints in the JAX package's format, read and written without flax.

The JAX package writes ``pickle.dump(flax.serialization.to_state_dict(tree))``
(``nerf_signature_tpu/train/checkpoint.py``): nested dicts of numpy arrays,
where a list becomes ``{"0": ..., "1": ...}`` and a NamedTuple a dict of its
fields.  This module reads and writes exactly that, and converts the NGP
params and the optimizer state between that form and the port's tensors.
The optimizer state is optax's ``adam`` with a schedule:
``(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))``, i.e.
``{"0": {"count", "mu", "nu"}, "1": {"count"}}`` with ``mu``/``nu`` laid out
like the params, so a port checkpoint resumes in JAX and back.
"""

import glob
import os
import pickle

import numpy as np
import torch


def save_checkpoint(path, state: dict):
    """Atomic write (tmp file + rename) of a state dict whose leaves are
    numpy arrays, tensors or Python scalars; lists become {"0": ...}."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(to_state_dict(state), f)
    os.replace(tmp, path)


def load_checkpoint(path):
    """Unpickle a checkpoint this package or the JAX package wrote.  Only
    load files you trust: unpickling can run code."""
    with open(path, "rb") as f:
        return pickle.load(f)


def to_state_dict(tree):
    """flax-style state dict: tensors -> numpy, lists/tuples -> {"i": ...}."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        return {k: to_state_dict(v) for k, v in tree._asdict().items()
                if v is not None}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def _as_list(node):
    """A list stored either as a list or as {"0": ..., "1": ...}."""
    if isinstance(node, dict):
        return [node[str(i)] for i in range(len(node))]
    return list(node)


def params_from_jax(state_dict, device="cpu"):
    """JAX NGP params (``init_ngp_params`` tree, as numpy, in list or
    state-dict form) -> the port's dict of fp32 tensors on ``device``."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    out = {}
    for k, v in state_dict.items():
        if k.endswith("_net"):
            out[k] = [t(w) for w in _as_list(v)]
        else:
            out[k] = t(v)
    return out


def params_to_jax(params):
    """The port's params -> the JAX checkpoint's state-dict form (numpy
    leaves, MLP lists as {"0": ..., "1": ...})."""
    return to_state_dict(params)


def opt_state_to_jax(count, mu, nu):
    """Adam's step count and moments (params-shaped dicts of tensors) ->
    optax's ``adam`` state in state-dict form."""
    c = np.asarray(count, np.int32)
    return {"0": {"count": c, "mu": params_to_jax(mu), "nu": params_to_jax(nu)},
            "1": {"count": c.copy()}}


def opt_state_from_jax(state_dict, device="cpu"):
    """optax's ``adam`` state (state-dict form) -> (count, mu, nu), the
    moments as the port's params dicts on ``device``."""
    adam = state_dict["0"]
    return (int(np.asarray(adam["count"])), params_from_jax(adam["mu"], device),
            params_from_jax(adam["nu"], device))


def check_params_like(template, params):
    """Raise when a loaded tree's leaf shapes differ from the model's: a
    silent layout mismatch (e.g. a --dense_coarse checkpoint in a hashed
    model) would corrupt results with no error."""
    for k, v in template.items():
        if k not in params:
            raise ValueError(f"checkpoint params lack {k!r}")
        tv = v if isinstance(v, list) else [v]
        pv = params[k] if isinstance(params[k], list) else [params[k]]
        shapes_t = [tuple(x.shape) for x in tv]
        shapes_p = [tuple(x.shape) for x in pv]
        if shapes_t != shapes_p:
            raise ValueError(
                f"checkpoint shape mismatch for {k!r}: saved {shapes_p} vs model "
                f"{shapes_t} — was the model configured differently (e.g. "
                f"--dense_coarse, n_levels) than when the checkpoint was written?")


def latest_checkpoint(ckpt_dir, name):
    lst = sorted(glob.glob(os.path.join(ckpt_dir, f"{name}_ep*.ckpt")))
    return lst[-1] if lst else None


def checkpoint_candidates(ckpt_dir, name):
    """All ring-buffer checkpoints, newest first."""
    return sorted(glob.glob(os.path.join(ckpt_dir, f"{name}_ep*.ckpt")),
                  reverse=True)


def prune_checkpoints(ckpt_dir, name, max_keep=2):
    """Keep the newest ``max_keep`` ring-buffer checkpoints (like the JAX
    package, ``max_keep=0`` keeps them all)."""
    lst = sorted(glob.glob(os.path.join(ckpt_dir, f"{name}_ep*.ckpt")))
    for p in lst[:-max_keep]:
        try:
            os.remove(p)
        except FileNotFoundError:
            pass
