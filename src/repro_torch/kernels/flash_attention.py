"""Blockwise (flash) attention with grouped KV heads, and its backward.

Every self-attention of a prefill or a training step (and a
cross-attention, non-causal with ``Sq != Skv``) runs here. On the card the
forward is the hand-written kernel in ``csrc/flash_attention.cu``: one
block per (batch, head, 64 query rows), four warps of 16 rows running
Q K^T and P V on the tensor cores (3xTF32, fp32 accuracy) with the online
softmax on the accumulators, looping over 64-row K/V tiles double-buffered
by cp.async, reading the KV head ``h // G`` in place (no seven-fold copy
of K and V for Qwen2's 14/2 heads) and stopping at the diagonal when
causal. Asked for it, it also writes each row's log-sum-exp. bfloat16
q, k and v go to their own forward kernel, ``csrc/flash_attention_bf16.cu``,
written for Hopper: the query heads of a KV head folded into the rows of
one block, so that one K/V tile feeds them all (at most 64 query heads a
KV head), Q and the K/V tiles brought by TMA from a producer warp, both
products as ``wgmma`` with fp32 accumulators, P rounded to bf16 before
P V as the reference's kernel rounds it; the output in bf16, the
log-sum-exp in fp32. Its launches are counted on
:func:`flash_attention_bf16`. A bfloat16 backward runs
``csrc/flash_attention_bwd_bf16.cu``, also written for Hopper: a table of
the rows' log-sum-exp and dO . o, then dk/dv with the query heads of a KV
head folded into the rows of each query tile (K and V loaded once by TMA,
Q, dO and the table streamed by a producer warp, the four products as
``wgmma``, the query tiles split over the ranks of a thread-block cluster
and summed in rank order), and dq, which forms S and dP again; fp32 sums,
dq, dk and dv rounded to bf16 once. Its launches are counted on
:func:`flash_attention_backward_bf16`.

When autograd records the call (grad mode on and an input that requires
grad), the wrapper runs :class:`FlashAttentionFunction`: the forward with
the log-sum-exp, and as its backward the kernels of
``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_backward`).
Otherwise nothing is saved. For tensors on the CPU the wrappers run the
plain versions in :mod:`repro_torch.kernels.ref`, which autograd
differentiates. On the meta device they take the card's route, each launch
a plain version standing in for its kernel (:func:`ref.stand_in`).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import build, costs, counting, ref

HEAD_DIMS = (16, 32, 64, 128)   # the kernels' template instances
DTYPES = (torch.float32, torch.bfloat16)   # the kernels' types
MAX_GROUP_BF16 = 64   # csrc/flash_attention_bf16.cu: the rows of a block


def _check(q, k, v):
    """Raise on what the kernels do not take; returns the shapes."""
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
    if q.dtype == torch.bfloat16 and H // KV > MAX_GROUP_BF16:
        raise ValueError(f"flash_attention: bfloat16 takes at most "
                         f"{MAX_GROUP_BF16} query heads a kv head, got "
                         f"{H // KV}")
    _check_layout(q.device, zip("qkv", (q, k, v)))
    return B, Sq, Skv, H, KV, D


def _check_layout(dev, named, dtypes=DTYPES) -> None:
    """Every tensor of ``named`` on ``dev``, of one dtype of ``dtypes``,
    in the layout of :func:`_fits`."""
    named = list(named)
    names = ", ".join(name for name, _ in named)
    taken = " or all ".join(str(d).removeprefix("torch.") for d in dtypes)
    first = named[0][1].dtype
    for name, t in named:
        if t.dtype not in dtypes or t.dtype != first or t.device != dev:
            raise ValueError(f"flash_attention: {names} must all be {taken} "
                             f"on {dev}, got {name} {t.dtype} on {t.device}")
        if not _fits(t):
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             f"last dim, strides in multiples of "
                             f"{16 // t.element_size()} elements and a "
                             f"16-byte aligned pointer; got strides "
                             f"{t.stride()}")


def _fits(t: torch.Tensor) -> bool:
    """The kernels' layout rule for a (B, S, heads, D) operand: every
    stride but the last a multiple of 16 bytes, the pointer 16-byte
    aligned."""
    unit = 16 // t.element_size()
    return (t.stride(3) == 1 and not any(s % unit for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def flash_attention_forward(q, k, v, causal: bool = True, window: int = 0,
                            with_lse: bool = False):
    """The forward alone, recording nothing for autograd: ``(out, lse)``
    with ``lse`` the rows' log-sum-exp of the scaled, masked scores
    (natural log, (B, H, Sq) float32; -1e30 for a row that sees no key)
    when ``with_lse``, else None. Without it the output is the same,
    bit for bit. Inputs as :func:`flash_attention`."""
    if window and not causal:
        raise ValueError("flash_attention: a window needs causal=True")
    if q.device.type in ref.PLAIN_DEVICES:
        B, Sq, H, D = q.shape
        Skv, KV = k.shape[1], k.shape[2]
        with torch.no_grad(), ref.stand_in(lambda: costs.flash_attention(
                B, Sq, Skv, H, KV, D, causal, window, with_lse,
                q.element_size())):
            # batch and heads split alike: the kernel's blocks
            out = ref.reckon(ref.flash_attention_ref,
                             (q, k, v, causal, window),
                             ("bshd", "bthd", "bthd", None, None), "bshd",
                             "bh")
            lse = (ref.reckon(ref.flash_attention_lse_ref,
                              (q, k, causal, window),
                              ("bshd", "bthd", None, None), "bhs", "bh")
                   if with_lse else None)
        return out, lse
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    B, Sq, Skv, H, KV, D = _check(q, k, v)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    if Skv == 0:
        raise ValueError("flash_attention: no keys to attend to")
    lib = build.library()
    bf16 = q.dtype == torch.bfloat16
    launch = (lib.flash_attention_bf16_launch if bf16
              else lib.flash_attention_launch)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None,
        B, Sq, Skv, H, KV, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(causal), window, stream),
        "flash_attention_bf16" if bf16 else "flash_attention")
    counting.count(flash_attention_bf16 if bf16 else flash_attention)
    return out, lse


def flash_attention_backward(q, k, v, out, dout, lse, causal: bool = True,
                             window: int = 0):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention` at ``q, k, v``
    for the output gradient ``dout``, given the forward's ``out`` and
    ``lse`` (:func:`flash_attention_forward` with ``with_lse``). On the
    card the three kernels of ``csrc/flash_attention_bwd.cu`` (rowdot;
    dk/dv in thread-block clusters over a kv head's query heads; dq),
    counted as one launch; q, k, v, ``out`` and ``dout`` all bfloat16 go
    to those of ``csrc/flash_attention_bwd_bf16.cu`` (counted on
    :func:`flash_attention_backward_bf16`; ``lse`` float32 either way),
    and mixed dtypes raise; a float32 ``dout`` in another layout than the
    kernels take is copied contiguous first, a bfloat16 one (which TMA
    reads) raises, copying nothing. On the CPU the
    plain version (:func:`ref.flash_attention_backward_ref`; ``out`` and
    ``lse`` are not read)."""
    if window and not causal:
        raise ValueError("flash_attention: a window needs causal=True")
    if q.device.type in ref.PLAIN_DEVICES:
        B, Sq, H, D = q.shape
        Skv, KV = k.shape[1], k.shape[2]
        with ref.stand_in(lambda: costs.flash_attention_backward(
                B, Sq, Skv, H, KV, D, causal, window, q.element_size())):
            return ref.reckon(ref.flash_attention_backward_ref,
                              (q, k, v, dout, causal, window),
                              ("bshd", "bthd", "bthd", "bshd", None, None),
                              ("bshd", "bthd", "bthd"), "bh")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    B, Sq, Skv, H, KV, D = _check(q, k, v)
    if tuple(out.shape) != (B, Sq, H, D) or \
            tuple(dout.shape) != (B, Sq, H, D):
        raise ValueError(f"flash_attention backward: out {tuple(out.shape)} "
                         f"and dout {tuple(dout.shape)} must be "
                         f"{(B, Sq, H, D)}")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous() or lse.device != dev:
        raise ValueError(f"flash_attention backward: lse must be a "
                         f"contiguous float32 {(B, H, Sq)} tensor on {dev}")
    if dout.dtype == torch.float32 and not _fits(dout):
        dout = dout.contiguous()
    _check_layout(dev, zip(("q", "k", "v", "out", "dout"),
                           (q, k, v, out, dout)), (q.dtype,))
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Skv, KV, D), dtype=q.dtype, device=dev)
    dv = torch.empty((B, Skv, KV, D), dtype=q.dtype, device=dev)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    dvec = torch.empty(backward_scratch(q, k), dtype=torch.float32,
                       device=dev)
    backward_kernels(q, k, v, out, dout, lse, causal, window,
                     (dvec, dq, dk, dv))
    counting.count(flash_attention_backward_bf16
                   if q.dtype == torch.bfloat16 else flash_attention_backward)
    return dq, dk, dv


def flash_attention_backward_bf16(q, k, v, out, dout, lse,
                                  causal: bool = True, window: int = 0):
    """:func:`flash_attention_backward` of bfloat16 q, k, v, ``out`` and
    ``dout``, which on the card runs the bf16 backward kernels
    (``csrc/flash_attention_bwd_bf16.cu``); their launches are counted
    here, whichever of the two names was called."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_backward_bf16: q must be "
                         f"bfloat16, got {q.dtype}")
    return flash_attention_backward(q, k, v, out, dout, lse, causal, window)


BACKWARD_PARTS = {"rowdot": 1, "dkdv": 2, "dq": 4}


def backward_scratch(q: torch.Tensor, k: torch.Tensor) -> tuple:
    """The shape of the backward's float32 scratch (the first of
    :func:`backward_kernels`' buffers): D of each row, (B, H, Sq), for
    float32; for bfloat16 the bf16 kernels' row table, 128 floats (the
    log2(e) lse and D of its 64 rows) for each query tile of 64 // G
    queries by the G heads of a kv head, (B, KV, tiles, 128)."""
    B, Sq, H, _ = q.shape
    KV = k.shape[2]
    if q.dtype != torch.bfloat16:
        return (B, H, Sq)
    qb = 64 // (H // KV)
    return (B, KV, -(-Sq // qb), 128)


def backward_kernels(q, k, v, out, dout, lse, causal, window, buffers,
                     parts: int = 7) -> None:
    """Launch the backward's kernels picked by ``parts`` (a sum of
    :data:`BACKWARD_PARTS`; 7 all three, in order) on the current stream,
    into ``buffers`` = (float32 scratch of :func:`backward_scratch`'s
    shape, dq, dk, dv), all contiguous on the card, the gradients in q's
    dtype (the bf16 kernels for bfloat16). Checks nothing and counts
    nothing: :func:`flash_attention_backward` checks, allocates and counts; this is
    also how one kernel is timed alone (each reads what the earlier ones
    wrote)."""
    dvec, dq, dk, dv = buffers
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    bf16 = q.dtype == torch.bfloat16
    launch = (lib.flash_attention_bwd_bf16_launch if bf16
              else lib.flash_attention_bwd_launch)
    build.check(launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, KV, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], *dout.stride()[:3], int(causal), window, parts,
        stream), "flash_attention_backward" + ("_bf16" if bf16 else ""))


class FlashAttentionFunction(torch.autograd.Function):
    """The card's differentiable route: the forward kernel with the rows'
    log-sum-exp, saved with q, k, v and the output, and the backward
    kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_forward(q, k, v, causal, window,
                                           with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout, lse,
                                              ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D), ``H % KV == 0`` ->
    (B, Sq, H, D) of q's dtype, equal to :func:`ref.flash_attention_ref`.
    ``causal`` masks column ``j > i`` (both counted from 0) and ``window``
    (causal only; 0 = none) also masks ``i - j >= window``. On the card:
    q, k and v all float32 or all bfloat16, ``D`` in :data:`HEAD_DIMS`,
    the last dim contiguous, every other stride a multiple of 16 bytes (4
    float32 or 8 bfloat16 elements) and 16-byte aligned pointers (bfloat16:
    at most 64 query heads a kv head);
    differentiable through :class:`FlashAttentionFunction` when autograd
    records, in either dtype."""
    if window and not causal:
        raise ValueError("flash_attention: a window needs causal=True")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal, window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, window)
    return flash_attention_forward(q, k, v, causal, window)[0]


def flash_attention_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """:func:`flash_attention` of bfloat16 q, k and v, which on the card
    runs the bf16 forward kernel (``csrc/flash_attention_bf16.cu``); its
    launches are counted here, whichever of the two names was called."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_bf16: q must be bfloat16, got "
                         f"{q.dtype}")
    return flash_attention(q, k, v, causal, window)


flash_attention.launches = 0
flash_attention_bf16.launches = 0
flash_attention_backward.launches = 0
flash_attention_backward_bf16.launches = 0
