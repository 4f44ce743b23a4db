"""Checkpoints in the JAX package's format, read and written without flax.

The JAX package writes ``pickle.dump(flax.serialization.to_state_dict(tree))``
(``nerf_signature_tpu/train/checkpoint.py``): nested dicts of numpy arrays,
where a list becomes ``{"0": ..., "1": ...}`` and a NamedTuple a dict of its
fields.  This module reads and writes exactly that, and converts the NGP
params, the watermark stage's ``trainable`` tree (``trainable_from_jax`` /
``trainable_to_jax``: ``msg_tables`` or the CopyRNeRF ``msg_mlp``, and the
decoder, whose conv weights are HWIO there, OIHW here; ``conv_tree_from_jax``
/ ``conv_tree_to_jax`` do the same for any HiDDeN tree) and the optimizer
state between that form and the port's tensors.  The optimizer state is
optax's ``adam`` with a schedule:
``(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))``, i.e.
``{"0": {"count", "mu", "nu"}, "1": {"count"}}`` with ``mu``/``nu`` laid out
like the params, so a port checkpoint resumes in JAX and back.  Under
``--finetune_decoder`` JAX wraps it in ``optax.multi_transform`` (the
decoder trains, the rest is frozen): ``{"inner_states": {"train":
{"inner_state": <adam's>}, "freeze": {"inner_state": {}}}}``, where the
moments hold the decoder's and an empty ``{}`` for each frozen subtree
(``masked_opt_state_to_jax`` / ``masked_opt_state_from_jax``).
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


def _is_list(node):
    return isinstance(node, (list, tuple)) or (
        isinstance(node, dict) and len(node) > 0 and all(k.isdigit() for k in node))


def conv_tree_from_jax(tree, device="cpu"):
    """A JAX HiDDeN or MLP tree (numpy, list or state-dict form) -> the
    port's fp32 tensors, every 4-D weight HWIO -> OIHW."""
    if _is_list(tree):
        return [conv_tree_from_jax(v, device) for v in _as_list(tree)]
    if isinstance(tree, dict):
        return {k: conv_tree_from_jax(v, device) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if a.ndim == 4:
        a = np.transpose(a, (3, 2, 0, 1))
    return torch.tensor(a, device=device)


def conv_tree_to_jax(tree):
    """The port's HiDDeN or MLP tree -> the JAX state-dict form, every 4-D
    weight OIHW -> HWIO."""
    if isinstance(tree, dict):
        return {str(k): conv_tree_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): conv_tree_to_jax(v) for i, v in enumerate(tree)}
    a = tree.detach().cpu().numpy()
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 else a


def trainable_from_jax(state_dict, device="cpu"):
    """JAX watermark ``trainable`` ({msg_tables or msg_mlp, decoder}, numpy,
    list or state-dict form) -> the port's tensors; conv weights HWIO ->
    OIHW.  A subtree stored empty (a frozen one in a ``multi_transform``
    moment) is left out."""
    out = {}
    if len(np.shape(state_dict.get("msg_tables", {}))) > 0:
        out["msg_tables"] = torch.tensor(np.asarray(state_dict["msg_tables"], np.float32),
                                         device=device)
    for k in ("msg_mlp", "decoder"):
        if state_dict.get(k):
            out[k] = conv_tree_from_jax(state_dict[k], device)
    return out


def trainable_to_jax(trainable):
    """The port's ``trainable`` -> the JAX checkpoint's state-dict form;
    conv weights OIHW -> HWIO."""
    out = {k: conv_tree_to_jax(v) for k, v in trainable.items() if k != "msg_tables"}
    if "msg_tables" in trainable:
        out["msg_tables"] = trainable["msg_tables"].detach().cpu().numpy()
    return out


def opt_state_to_jax(count, mu, nu, tree_to_jax=params_to_jax):
    """Adam's step count and moments (laid out like the params) -> optax's
    ``adam`` state in state-dict form; ``tree_to_jax`` converts one moment
    tree (``trainable_to_jax`` for the watermark stage)."""
    c = np.asarray(count, np.int32)
    return {"0": {"count": c, "mu": tree_to_jax(mu), "nu": tree_to_jax(nu)},
            "1": {"count": c.copy()}}


def opt_state_from_jax(state_dict, device="cpu", tree_from_jax=params_from_jax):
    """optax's ``adam`` state (state-dict form) -> (count, mu, nu), the
    moments converted by ``tree_from_jax`` onto ``device``."""
    adam = state_dict["0"]
    return (int(np.asarray(adam["count"])), tree_from_jax(adam["mu"], device),
            tree_from_jax(adam["nu"], device))


def masked_opt_state_to_jax(count, mu, nu, frozen):
    """``optax.multi_transform({"train": adam, "freeze": set_to_zero()})``'s
    state in state-dict form: Adam's over the trained subtrees of the
    moments ``mu``/``nu`` (watermark trainable trees), ``{}`` for each key
    in ``frozen``."""
    def tree(t):
        return dict(trainable_to_jax(t), **{k: {} for k in frozen})

    return {"inner_states": {"train": {"inner_state": opt_state_to_jax(count, mu, nu, tree)},
                             "freeze": {"inner_state": {}}}}


def masked_opt_state_from_jax(state_dict, device="cpu"):
    """(count, mu, nu) of the trained subtrees from ``masked_opt_state_to_jax``'s
    form (the frozen subtrees, stored empty, are left out)."""
    return opt_state_from_jax(state_dict["inner_states"]["train"]["inner_state"], device,
                              trainable_from_jax)


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
