"""Device resolution: the port runs on the card unless the caller asks for
the CPU, and never falls back to the CPU on its own."""

import torch


def resolve_device(device=None):
    """``None`` means ``"cuda"``.  Raises when CUDA is asked for (explicitly
    or by default) and no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nerf_signature_tpu_torch runs on a CUDA GPU by default, and no "
            "GPU is visible. Pass device='cpu' (the CLI: --cpu) to run the "
            "plain PyTorch versions on the CPU.")
    return dev
