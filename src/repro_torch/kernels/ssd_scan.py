"""Chunked SSD scan (Mamba-2).

Every SSM layer of a prefill runs its sequence through here. On the card it
is the hand-written kernel in ``csrc/ssd_scan.cu``: one block per (batch,
head, 32 rows of the head dim) carries its slice of the state, seeded from
``init_state`` or zero, through a loop over the chunks, runs each chunk's
four matrix products on the tensor cores (3xTF32, fp32 accuracy) and
writes the final state for the decode cache. For tensors on the CPU the
wrapper runs the plain chunked version in :mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

import torch

from . import build, counting, guard, ref

MAX_CHUNK = 128
MAX_STATE = 128


def ssd_scan(x, dt, A, B, C, chunk: int, init_state=None):
    """x: (b, l, h, p); dt: (b, l, h); A: (h,); B, C: (b, l, g, n), the g
    groups shared by ``h // g`` heads each; ``l % chunk == 0``. Returns
    ``(y (b, l, h, p), final_state (b, h, p, n) float32)``, equal to
    :func:`ref.ssd_scan_ref`. On the card: float32, ``chunk`` and ``n`` at
    most 128, ``init_state`` (if given) a contiguous (b, h, p, n) float32
    tensor, and each other tensor contiguous within a position (the batch
    and length strides are free, so slices of a packed projection need no
    copy)."""
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, B, C, chunk, init_state)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {dev}")
    guard.check_no_grad("ssd_scan", x, dt, A, B, C, init_state,
                        until="the SSD scan's backward kernel, the next "
                              "training slice")
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or B.ndim != 4:
        raise ValueError("ssd_scan: x, B, C must be 4-D, dt 3-D and A 1-D")
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    shapes = {"dt": (dt, (b, l, h)), "A": (A, (h,)), "B": (B, (b, l, g, n)),
              "C": (C, (b, l, g, n))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"ssd_scan: {name} must be float32 on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if not (0 < chunk <= MAX_CHUNK and l % chunk == 0):
        raise ValueError(f"ssd_scan: chunk {chunk} must be in 1..{MAX_CHUNK} "
                         f"and divide the length {l}")
    if not (0 < n <= MAX_STATE and g > 0 and h % g == 0):
        raise ValueError(f"ssd_scan: state size {n} must be in "
                         f"1..{MAX_STATE} and {g} groups must divide {h} "
                         f"heads")
    inner = {"x": (x, (p, 1)), "B": (B, (n, 1)), "C": (C, (n, 1))}
    for name, (t, strides) in inner.items():
        if t.stride()[2:] != strides:
            raise ValueError(f"ssd_scan: {name} must be contiguous within a "
                             f"position, got strides {t.stride()}")
    if dt.stride(2) != 1 or not A.is_contiguous():
        raise ValueError("ssd_scan: dt must be contiguous within a position "
                         "and A contiguous")
    if init_state is not None:
        if (tuple(init_state.shape) != (b, h, p, n)
                or init_state.dtype != torch.float32
                or init_state.device != dev
                or not init_state.is_contiguous()):
            raise ValueError(f"ssd_scan: init_state must be a contiguous "
                             f"float32 {(b, h, p, n)} tensor on {dev}, got "
                             f"{init_state.dtype} {tuple(init_state.shape)} "
                             f"on {init_state.device}")
    y = torch.empty((b, l, h, p), dtype=torch.float32, device=dev)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, (final.zero_() if init_state is None
                   else final.copy_(init_state))
    lib = build.library()
    with torch.cuda.device(dev):   # the launch goes to the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), final.data_ptr(), b, l, h, p, g, n,
            chunk, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            B.stride(0), B.stride(1), C.stride(0), C.stride(1), stream),
            "ssd_scan")
    counting.count(ssd_scan)
    return y, final


ssd_scan.launches = 0
