"""Import and device hygiene of the PyTorch/CUDA port.

* No module of ``nerf_signature_tpu_torch/`` and not ``chip_smoke.py``
  imports JAX, flax, optax, the JAX package, ``bench`` or ``scripts_dev``
  (the port must run where JAX is not installed, and keeps its own copies).
* Entry points run on the GPU unless asked for the CPU: with no GPU
  visible, ``NGPModel()`` raises instead of running on the CPU.
"""

import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "nerf_signature_tpu_torch")
BANNED = ("jax", "jaxlib", "flax", "optax", "nerf_signature_tpu", "bench", "scripts_dev")


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_sources_exist():
    files = _port_sources()
    assert os.path.exists(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in BANNED})
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_default_device_is_the_gpu_and_never_silently_the_cpu():
    from nerf_signature_tpu_torch.api import NGPModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig
    from nerf_signature_tpu_torch.utils.device import resolve_device

    small = NGPConfig(n_levels=4, log2_hashmap_size=12)
    if torch.cuda.is_available():
        assert NGPModel(small, grid_size=16).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            NGPModel(small, grid_size=16)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    assert NGPModel(small, grid_size=16, device="cpu").device.type == "cpu"


def test_wrappers_refuse_grad_through_forward_only_kernels():
    from nerf_signature_tpu_torch.ops import _cuda

    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        _cuda.no_grad_inputs("k", x)
    with torch.no_grad():
        _cuda.no_grad_inputs("k", x)
