"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent.

    Entry points default to "cuda" and never fall back to the CPU on their
    own: a caller that wants the CPU (the tests) passes device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
