"""The check a CUDA route without a backward kernel makes before it
launches its kernel.

A wrapper writes its outputs through ``data_ptr()`` into fresh tensors, so
on the card its result has no autograd graph: a gradient through it would
be lost without a word. Flash attention, the SSD scan and the row gather
have backward kernels and are differentiable on the card (their autograd
``Function``s in ``kernels/flash_attention.py``, ``ssd_scan.py`` and
``gather_batch.py``); the two LSTM cells do not, and each of their CUDA
routes raises instead when autograd would record the call. The CPU routes
run the plain, differentiable versions and need no check.
"""

from __future__ import annotations

import torch


def check_no_grad(name: str, *tensors, until: str = "") -> None:
    """Raise if grad mode is on and any of ``tensors`` (``None`` skipped)
    requires grad; ``until`` names the work that brings the backward."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        later = f" (it comes with {until})" if until else ""
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward{later}, and an input "
            f"requires grad; call it under torch.no_grad(), or detach the "
            f"inputs")
