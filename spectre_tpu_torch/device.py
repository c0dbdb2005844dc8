"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=None) -> torch.device:
    """The torch device an entry point runs on: "cuda" unless the caller
    names another. Asking for CUDA on a machine without a usable GPU raises:
    nothing carries on on the CPU unless the caller passed device="cpu"."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spectre_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
