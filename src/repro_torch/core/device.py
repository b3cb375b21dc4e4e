"""Device resolution and host-side waits shared by the port's entry points.

Every entry point takes an explicit ``device``. ``None`` means the card:
the port never falls back to the CPU on its own, so a machine without CUDA
raises instead of quietly running the plain PyTorch versions.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising when CUDA is absent); else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA unless told otherwise, and no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def block(device: torch.device) -> None:
    """Wait for all work queued on ``device``'s current stream."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
