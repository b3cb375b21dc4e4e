"""Chunked SSD scan (Mamba-2), and its backward.

Every SSM layer of a prefill or a training step runs its sequence through
here. On the card the forward is the hand-written kernel in
``csrc/ssd_scan.cu``: one block per (batch, head, 32 rows of the head dim)
carries its slice of the state, seeded from ``init_state`` or zero,
through a loop over the chunks, runs each chunk's four matrix products on
the tensor cores (3xTF32, fp32 accuracy) and writes the final state for
the decode cache. Asked for them, it also writes the state each chunk
starts from. bfloat16 x, dt, B and C (A float32) go to their own forward
kernel, ``csrc/ssd_scan_bf16.cu``, written for Hopper: one block per
(head, batch) holding the head's whole state (head dim at most 64), a
producer warp keeping the next chunk's C, B and x in flight by TMA, and the
four products as ``wgmma`` with fp32 accumulators, rounding to bf16 where
the reference rounds; y in bf16, the states in fp32. Its launches are
counted on :func:`ssd_scan_bf16`. A bfloat16 backward runs
``csrc/ssd_scan_bwd_bf16.cu``: the state pass, then a chunk kernel written
for Hopper (a block per head block of a group and chunk, the group's head
blocks one thread-block cluster; one lane streaming each head's x
and dy by TMA; every product a ``wgmma`` with fp32 sums, rounding where the
reference rounds; the group's dB and dC summed in the block and then over
the cluster's ranks in order); dx, ddt, dB and dC in bf16, dA in fp32;
its launches are counted on :func:`ssd_scan_backward_bf16`.

When autograd records the call (grad mode on and an input that requires
grad), the wrapper runs :class:`SsdScanFunction`: the forward, saving the
chunks' start states where any can be nonzero (more than one chunk, or an
initial state; float32 only: the bf16 backward recomputes them), and as
its backward the kernels of ``csrc/ssd_scan_bwd.cu`` or their bf16 forms
(:func:`ssd_scan_backward`). Otherwise nothing is saved. For tensors on
the CPU the wrappers run the plain versions in
:mod:`repro_torch.kernels.ref`, which autograd differentiates. On the meta
device they take the card's route, each launch a plain version standing in
for its kernel (:func:`ref.stand_in`).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import build, costs, counting, ref

MAX_CHUNK = 128
MAX_STATE = 128
MAX_HEAD_DIM_BACKWARD = 64   # csrc/ssd_scan_bwd.cu: MAXP
MAX_HEAD_DIM_BF16 = 64       # csrc/ssd_scan_bf16.cu: MAXP


def _check(x, dt, A, B, C, chunk: int, init_state) -> tuple:
    """Raise on what the kernels do not take; returns (b, l, h, p, g, n).
    x, dt, B and C all float32 or all bfloat16, A and the initial state
    float32; bfloat16 x, B and C with every stride but the last a multiple
    of 8 elements and 16-byte aligned pointers (TMA reads them), and a
    head dim of at most 64."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {dev}")
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
    for name, t in (("x", x), ("dt", dt), ("B", B), ("C", C)):
        if t.dtype not in (torch.float32, torch.bfloat16) or \
                t.dtype != x.dtype or t.device != dev:
            raise ValueError(f"ssd_scan: x, dt, B and C must all be float32 "
                             f"or all bfloat16 on {dev}, got {name} "
                             f"{t.dtype} on {t.device}")
    if A.dtype != torch.float32 or A.device != dev:
        raise ValueError(f"ssd_scan: A must be float32 on {dev}, got "
                         f"{A.dtype} on {A.device}")
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
    if x.dtype == torch.bfloat16:
        if p > MAX_HEAD_DIM_BF16:
            raise ValueError(f"ssd_scan: bfloat16 head dim {p} is above "
                             f"{MAX_HEAD_DIM_BF16}")
        for name, t in (("x", x), ("B", B), ("C", C)):
            if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
                raise ValueError(f"ssd_scan: bfloat16 {name} needs strides "
                                 f"in multiples of 8 elements and a 16-byte "
                                 f"aligned pointer; got strides "
                                 f"{t.stride()}")
    if init_state is not None:
        if (tuple(init_state.shape) != (b, h, p, n)
                or init_state.dtype != torch.float32
                or init_state.device != dev
                or not init_state.is_contiguous()):
            raise ValueError(f"ssd_scan: init_state must be a contiguous "
                             f"float32 {(b, h, p, n)} tensor on {dev}, got "
                             f"{init_state.dtype} {tuple(init_state.shape)} "
                             f"on {init_state.device}")
    return b, l, h, p, g, n


def ssd_scan_forward(x, dt, A, B, C, chunk: int, init_state=None,
                     with_states: bool = False):
    """The forward alone, recording nothing for autograd: ``(y, final,
    states)`` with ``states`` the state each chunk starts from ((b, l //
    chunk, h, p, n) float32, the first ``init_state`` or zero) when
    ``with_states``, else None. Without them ``y`` and ``final`` are the
    same, bit for bit. Inputs as :func:`ssd_scan`."""
    if x.device.type in ref.PLAIN_DEVICES:
        with torch.no_grad(), ref.stand_in(lambda: costs.ssd_scan(
                *x.shape, *B.shape[2:], chunk, init_state is not None,
                with_states, x.element_size())):
            # the batch split: heads share their group's B and C
            args = (x, dt, A, B, C, chunk, init_state)
            labels = ("blhp", "blh", "h", "blgn", "blgn", None,
                      None if init_state is None else "bhpn")
            y, final = ref.reckon(ref.ssd_scan_ref, args, labels,
                                  ("blhp", "bhpn"), "b")
            states = (ref.reckon(ref.ssd_chunk_states, args[:4] + args[5:],
                                 labels[:4] + labels[5:], "bchpn", "b")
                      if with_states else None)
        return y, final, states
    if x.dtype == torch.bfloat16 and init_state is not None and \
            init_state.dtype == torch.bfloat16:
        init_state = init_state.float()   # as the reference's astype
    b, l, h, p, g, n = _check(x, dt, A, B, C, chunk, init_state)
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=dev)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    states = (torch.empty((b, l // chunk, h, p, n), dtype=torch.float32,
                          device=dev) if with_states else None)
    if y.numel() == 0:   # then states is empty too
        return y, (final.zero_() if init_state is None
                   else final.copy_(init_state)), states
    lib = build.library()
    launch = lib.ssd_scan_bf16_launch if bf16 else lib.ssd_scan_launch
    with torch.cuda.device(dev):   # the launch goes to the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), final.data_ptr(),
            None if states is None else states.data_ptr(), b, l, h, p, g, n,
            chunk, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            B.stride(0), B.stride(1), C.stride(0), C.stride(1), stream),
            "ssd_scan_bf16" if bf16 else "ssd_scan")
    counting.count(ssd_scan_bf16 if bf16 else ssd_scan)
    return y, final, states


def ssd_scan_backward(x, dt, A, B, C, chunk: int, init_state, dy,
                      dfinal=None, states=None):
    """Gradients ``(dx, ddt, dA, dB, dC, dinit)`` of :func:`ssd_scan` at
    its inputs for the output gradients ``dy`` and ``dfinal`` (None: zero);
    ``dinit`` is None when ``init_state`` is. ``states``: the forward's
    chunk start states (:func:`ssd_scan_forward` with ``with_states``), or
    None where they are all zero (one chunk and no initial state); the
    bf16 kernels recompute them in fp32 and read none. On the card the
    kernels of ``csrc/ssd_scan_bwd.cu`` (the state pass over the
    chunks, where it is needed; C B^T once per group of heads; the chunk
    kernel on the tensor cores; the group sums), counted as one launch,
    with the head dim at most 64; bfloat16 x, dt, B, C and ``dy`` (A,
    ``dfinal``, the states and the initial state float32, or a bfloat16
    initial state taken as its float32 value) go to those of
    ``csrc/ssd_scan_bwd_bf16.cu`` (counted on
    :func:`ssd_scan_backward_bf16`; dx, ddt, dB, dC bfloat16, dA float32,
    ``dinit`` in the initial state's dtype), and mixed dtypes raise;
    a float32 ``dy`` and ``dfinal`` in another layout are copied
    contiguous first, a bfloat16 ``dy`` (which TMA reads) that is not
    contiguous with a 16-byte aligned pointer raises, copying nothing. The
    gradients are dense.
    On the CPU the plain version (:func:`ref.ssd_scan_bwd_ref`)."""
    if x.device.type in ref.PLAIN_DEVICES:
        with ref.stand_in(lambda: costs.ssd_scan_backward(
                *x.shape, *B.shape[2:], chunk, init_state is not None,
                dfinal is not None, states is not None, x.element_size())):
            init = None if init_state is None else "bhpn"
            return ref.reckon(
                ref.ssd_scan_bwd_ref,
                (x, dt, A, B, C, chunk, init_state, dy, dfinal, states),
                ("blhp", "blh", "h", "blgn", "blgn", None, init, "blhp",
                 None if dfinal is None else "bhpn",
                 None if states is None else "bchpn"),
                ("blhp", "blh", "h", "blgn", "blgn", init), "b")
    bf16 = x.dtype == torch.bfloat16
    init_dtype = None if init_state is None else init_state.dtype
    if bf16 and init_dtype == torch.bfloat16:
        init_state = init_state.float()   # as the forward takes it
    b, l, h, p, g, n = _check(x, dt, A, B, C, chunk, init_state)
    dev = x.device
    if p > MAX_HEAD_DIM_BACKWARD:
        raise ValueError(f"ssd_scan backward: head dim {p} is above "
                         f"{MAX_HEAD_DIM_BACKWARD}")
    nc = l // chunk
    wants = {"dy": (dy, (b, l, h, p), x.dtype),
             "dfinal": (dfinal, (b, h, p, n), torch.float32),
             "states": (states, (b, nc, h, p, n), torch.float32)}
    for name, (t, shape, dtype) in wants.items():
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"ssd_scan backward: {name} must be a "
                             f"{str(dtype).removeprefix('torch.')} {shape} "
                             f"tensor on {dev} (x is {x.dtype}), got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if states is None and not bf16 and (nc > 1 or init_state is not None):
        raise ValueError("ssd_scan backward: the chunks' start states are "
                         "needed with more than one chunk or an initial "
                         "state")
    if bf16 and (not dy.is_contiguous() or dy.data_ptr() % 16):
        raise ValueError(f"ssd_scan backward: a bfloat16 dy must be "
                         f"contiguous with a 16-byte aligned pointer (TMA "
                         f"reads it); got strides {dy.stride()}")
    dy = dy.contiguous()
    dfinal = None if dfinal is None else dfinal.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(dtype=x.dtype, device=dev)
    dx = torch.empty((b, l, h, p), **out)
    ddt = torch.empty((b, l, h), **out)
    dA = torch.empty((h,), **f32)
    dB = torch.empty((b, l, g, n), **out)
    dC = torch.empty((b, l, g, n), **out)
    dinit = (None if init_state is None
             else torch.empty((b, h, p, n), **f32))
    if dx.numel() == 0:
        return (dx, ddt, dA.zero_(), dB.zero_(), dC.zero_(),
                None if dinit is None else
                (dinit.zero_() if dfinal is None else
                 dinit.copy_(dfinal)).to(init_dtype))
    state_pass = nc > 1 or dfinal is not None or dinit is not None
    gbuf = torch.empty((b, nc, h, p, n) if state_pass else (0,), **f32)
    # the bf16 kernels recompute the chunks' start states in fp32
    sbuf = (torch.empty((b, nc, h, p, n), **f32)
            if bf16 and (nc > 1 or init_state is not None) else None)
    dapart = torch.empty((b * nc, h), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), dy.data_ptr(), ptr(dfinal))
        tail = (dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                dC.data_ptr(), ptr(dinit), b, l, h, p, g, n, chunk,
                int(init_state is not None), x.stride(0), x.stride(1),
                dt.stride(0), dt.stride(1), B.stride(0), B.stride(1),
                C.stride(0), C.stride(1), stream)
        if bf16:
            # the chunk kernel's count of finished blocks (it leaves it 0)
            counter = torch.zeros((1,), dtype=torch.int32, device=dev)
            build.check(lib.ssd_scan_bwd_bf16_launch(
                *head, ptr(init_state), ptr(sbuf), gbuf.data_ptr(),
                dapart.data_ptr(), counter.data_ptr(), *tail),
                "ssd_scan_backward_bf16")
        else:
            s16 = -(-chunk // 16)
            cbuf = torch.empty((b * nc * g, s16, 2 * s16, 32, 4), **f32)
            dbh = torch.empty((b, l, h, n), **f32)
            dch = torch.empty((b, l, h, n), **f32)
            build.check(lib.ssd_scan_bwd_launch(
                *head, ptr(states), gbuf.data_ptr(), cbuf.data_ptr(),
                dbh.data_ptr(), dch.data_ptr(), dapart.data_ptr(), *tail),
                "ssd_scan_backward")
    counting.count(ssd_scan_backward_bf16 if bf16 else ssd_scan_backward)
    return (dx, ddt, dA, dB, dC,
            None if dinit is None else dinit.to(init_dtype))


def ssd_scan_backward_bf16(x, dt, A, B, C, chunk: int, init_state, dy,
                           dfinal=None, states=None):
    """:func:`ssd_scan_backward` of bfloat16 x, dt, B, C and ``dy``,
    which on the card runs the bf16 backward kernels
    (``csrc/ssd_scan_bwd_bf16.cu``); their launches are counted here,
    whichever of the two names was called."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"ssd_scan_backward_bf16: x must be bfloat16, got "
                         f"{x.dtype}")
    return ssd_scan_backward(x, dt, A, B, C, chunk, init_state, dy, dfinal,
                             states)


class SsdScanFunction(torch.autograd.Function):
    """The card's differentiable route: the forward kernel, saving x, dt,
    A, B, C, the initial state and, in float32 where any can be nonzero,
    the chunks' start states; the backward kernels as its gradient. A
    final state whose gradient never arrives counts as zero gradient, and
    an ``init_state`` that was None gets None."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int, init_state):
        # the bf16 backward recomputes the start states in fp32
        with_states = x.dtype == torch.float32 and (
            x.shape[1] > chunk or init_state is not None)
        y, final, states = ssd_scan_forward(x, dt, A, B, C, chunk,
                                            init_state, with_states)
        ctx.save_for_backward(x, dt, A, B, C, init_state, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, init_state, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        dx, ddt, dA, dB, dC, dinit = ssd_scan_backward(
            x, dt, A, B, C, ctx.chunk, init_state, dy, dfinal, states)
        return dx, ddt, dA, dB, dC, None, dinit


def ssd_scan(x, dt, A, B, C, chunk: int, init_state=None):
    """x: (b, l, h, p); dt: (b, l, h); A: (h,); B, C: (b, l, g, n), the g
    groups shared by ``h // g`` heads each; ``l % chunk == 0``. Returns
    ``(y (b, l, h, p) of x's dtype, final_state (b, h, p, n) float32)``,
    equal to :func:`ref.ssd_scan_ref`. On the card: x, dt, B and C all
    float32 or all bfloat16 and A float32, ``chunk`` and ``n`` at most
    128, ``init_state`` (if given) a contiguous (b, h, p, n) float32
    tensor (bfloat16 with bfloat16 inputs, taken as its float32 value),
    and each other tensor contiguous within a position (the batch and
    length strides are free, so slices of a packed projection need no
    copy; for bfloat16 multiples of 8 elements, see :func:`_check`);
    differentiable through :class:`SsdScanFunction` when autograd records
    (either dtype, head dim at most 64)."""
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, B, C, chunk, init_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, init_state)):
        return SsdScanFunction.apply(x, dt, A, B, C, chunk, init_state)
    return ssd_scan_forward(x, dt, A, B, C, chunk, init_state)[:2]


def ssd_scan_bf16(x, dt, A, B, C, chunk: int, init_state=None):
    """:func:`ssd_scan` of bfloat16 x, dt, B and C (A float32), which on
    the card runs the bf16 forward kernel (``csrc/ssd_scan_bf16.cu``); its
    launches are counted here, whichever of the two names was called."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"ssd_scan_bf16: x must be bfloat16, got {x.dtype}")
    return ssd_scan(x, dt, A, B, C, chunk, init_state)


ssd_scan.launches = 0
ssd_scan_bf16.launches = 0
ssd_scan_backward.launches = 0
ssd_scan_backward_bf16.launches = 0
