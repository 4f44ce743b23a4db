"""Import and device hygiene of the PyTorch/CUDA port.

* No module of ``nerf_signature_tpu_torch/`` and not ``chip_smoke.py``
  imports JAX, flax, optax, the JAX package, ``bench`` or ``scripts_dev``
  (the port must run where JAX is not installed, and keeps its own copies).
* No module of the port imports PIL or OpenCV at module level: the GPU
  machine has neither; the code that needs one imports it where it is used.
* Entry points run on the GPU unless asked for the CPU: with no GPU
  visible, ``NGPModel()`` and ``WatermarkModel()`` raise instead of running
  on the CPU.
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


def _module_level_roots(path):
    """Roots imported by statements at module level (not inside a def)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_image_library_at_module_level(path):
    bad = sorted({r for r in _module_level_roots(path) if r in ("PIL", "cv2")})
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad} at module level"


def test_default_device_is_the_gpu_and_never_silently_the_cpu():
    from nerf_signature_tpu_torch.api import NGPModel, WatermarkModel
    from nerf_signature_tpu_torch.models.ngp import NGPConfig
    from nerf_signature_tpu_torch.models.watermark import WatermarkConfig
    from nerf_signature_tpu_torch.utils.device import resolve_device

    # the narrow model the field kernels are built for (ops/_cuda.py:FIELD_WIDTHS)
    small = NGPConfig(n_levels=4, log2_hashmap_size=12, hidden_dim=16, hidden_dim_color=16)
    wsmall = WatermarkConfig(ngp=small, message_dim=2, msg_log2_hashmap_size=10)
    if torch.cuda.is_available():
        assert NGPModel(small, grid_size=16).device.type == "cuda"
        assert WatermarkModel(wsmall, grid_size=16).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            NGPModel(small, grid_size=16)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            WatermarkModel(wsmall, grid_size=16)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    assert NGPModel(small, grid_size=16, device="cpu").device.type == "cpu"
    assert WatermarkModel(wsmall, grid_size=16, device="cpu").device.type == "cpu"


def test_wrappers_refuse_grad_through_forward_only_kernels():
    """No kernel of the train path is forward-only any more: each has its
    backward kernel, and ``needs_grad`` routes a call through the kernel's
    autograd Function exactly when autograd will differentiate it."""
    from nerf_signature_tpu_torch.ops import _cuda

    x = torch.zeros(3, requires_grad=True)
    assert _cuda.needs_grad(x) and _cuda.needs_grad(None, x)
    assert not _cuda.needs_grad(torch.zeros(3), None)
    with torch.no_grad():
        assert not _cuda.needs_grad(x)
    assert {"K1_hash_encode_bwd", "K3_composite_bwd", "K4_field_bwd", "K4_field_bwd_feat",
            "K9_msg_table", "K9_msg_table_bwd", "P1_gather"} <= set(_cuda.KERNELS)
    assert not hasattr(_cuda, "no_grad_inputs")
