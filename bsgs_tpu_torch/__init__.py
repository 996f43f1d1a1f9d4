"""bsgs_tpu_torch — the secp256k1 baby-step/giant-step solver in PyTorch.

The PyTorch/CUDA port of ``bsgs_tpu``: the same layout and names, plain
functions on tensors with an explicit ``device``, and hand-written CUDA
kernels (``csrc/``) where the JAX package has Pallas kernels. Each kernel
wrapper launches its kernel for a CUDA tensor and runs its plain PyTorch
version for a CPU tensor; nothing falls back from one to the other.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    one. Raises when CUDA is asked for (explicitly or by default) and there
    is none — never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
