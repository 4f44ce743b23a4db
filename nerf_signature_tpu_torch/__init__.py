"""nerf_signature_tpu_torch — the PyTorch/CUDA port of ``nerf_signature_tpu``
for NVIDIA Hopper (H100).

Same sub-packages and module names as the JAX package, which stays the
reference: every module here is tested against its JAX counterpart on the
same inputs.  The hot ops that the JAX package runs as XLA programs are
hand-written CUDA kernels here (``csrc/``), each beside a plain PyTorch
version: K1 hash encoder, K2 marcher, K3 compositor, K4 fused field heads.
Entry points run on the GPU unless the caller asks for the CPU.

This package imports torch and numpy, never JAX and never the JAX package.
"""

__version__ = "0.1.0"
