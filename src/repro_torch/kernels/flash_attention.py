"""Blockwise (flash) attention with grouped KV heads.

Every self-attention of a prefill (and a cross-attention, non-causal with
``Sq != Skv``) runs here. On the card it is the hand-written kernel in
``csrc/flash_attention.cu``: one block per (batch, head, 64 query rows),
four warps of 16 rows running Q K^T and P V on the tensor cores (3xTF32,
fp32 accuracy) with the online softmax on the accumulators, looping over
64-row K/V tiles double-buffered by cp.async, reading the KV head
``h // G`` in place (no seven-fold copy of K and V for Qwen2's 14/2 heads)
and stopping at the diagonal when causal. For tensors on the CPU the
wrapper runs the plain version in :mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

import torch

from . import build, ref

HEAD_DIMS = (16, 32, 64, 128)   # the kernel's template instances


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D), ``H % KV == 0`` ->
    (B, Sq, H, D), equal to :func:`ref.flash_attention_ref`. ``causal``
    masks column ``j > i`` (both counted from 0) and ``window`` (causal
    only; 0 = none) also masks ``i - j >= window``. On the card: float32,
    ``D`` in :data:`HEAD_DIMS`, the last dim contiguous, every other stride
    a multiple of 4 elements and 16-byte aligned pointers."""
    if window and not causal:
        raise ValueError("flash_attention: a window needs causal=True")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal, window)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k and v must be 4-D")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, KV, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} heads over {KV} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"flash_attention: {name} must be float32 on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if (t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             f"last dim, strides in multiples of 4 and a "
                             f"16-byte aligned pointer; got strides "
                             f"{t.stride()}")
    out = torch.empty((B, Sq, H, D), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if Skv == 0:
        raise ValueError("flash_attention: no keys to attend to")
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, KV, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(causal), window, stream), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
