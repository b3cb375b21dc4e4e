"""The check every CUDA route makes before it launches its kernel.

A wrapper writes its outputs through ``data_ptr()`` into fresh tensors, so
on the card its result has no autograd graph: a gradient through it would
be lost without a word. Until the kernels have backward kernels, each CUDA
route raises instead when autograd would record the call. The CPU route
runs the plain, differentiable version and needs no check.
"""

from __future__ import annotations

import torch


def check_no_grad(name: str, *tensors) -> None:
    """Raise if grad mode is on and any of ``tensors`` (``None`` skipped)
    requires grad."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            f"grad; call it under torch.no_grad(), or detach the inputs")
