"""Primitive op registry for cell programs.

Each op kind has a *batched* PyTorch implementation operating on stacked
operands: every source operand arrives as (k, *elem_shape) — k ops of the
same type executed as one batched call (the paper's batched kernel).
A leading instance dimension B may precede k for instance-varying operands;
parameter operands have no B dimension and broadcast over it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class OpKind:
    name: str
    arity: int
    infer_shape: Callable[..., tuple[int, ...]]
    # fn(*operands) with operands shaped (B, k, *elem) for instance operands
    # or (k, *elem) for parameter operands (identified by ndim).
    fn: Callable[..., torch.Tensor]


def _bk(x: torch.Tensor, elem_ndim: int) -> torch.Tensor:
    """Normalize operand to (B, k, *elem); parameter operands get B=1."""
    if x.ndim == elem_ndim + 1:  # (k, *elem) parameter operand
        return x[None]
    return x


def _affine(x, w, b):
    # x: (B,k,n) or (k,n); w: (k,n,m); b: (k,m)
    x = _bk(x, 1)
    w = _bk(w, 2)
    b = _bk(b, 1)
    return torch.einsum("bkn,cknm->bkm", x, w) + b


def _matmul(x, w):
    x = _bk(x, 1)
    w = _bk(w, 2)
    return torch.einsum("bkn,cknm->bkm", x, w)


def _matmul_vv(a, b):
    # MV-RNN style: (B,k,n,n) x (B,k,n) matrices applied to vectors
    a = _bk(a, 2)
    b = _bk(b, 1)
    return torch.einsum("bknm,bkm->bkn", a, b)


def _ew(f):
    def impl(*xs):
        nd = max(x.ndim for x in xs)
        xs = [x if x.ndim == nd else x[None] for x in xs]
        return f(*xs)
    return impl


def _concat2(a, b):
    nd = max(a.ndim, b.ndim)
    a = a if a.ndim == nd else a[None]
    b = b if b.ndim == nd else b[None]
    return torch.cat([a, b], dim=-1)


OPS: dict[str, OpKind] = {}


def _register(name: str, arity: int, infer_shape, fn) -> None:
    OPS[name] = OpKind(name, arity, infer_shape, fn)


_register("affine", 3, lambda x, w, b: (w[-1],), _affine)
_register("matmul", 2, lambda x, w: (w[-1],), _matmul)
_register("matvec", 2, lambda a, b: (a[-2],), _matmul_vv)
_register("add", 2, lambda a, b: a, _ew(torch.add))
_register("sub", 2, lambda a, b: a, _ew(torch.sub))
_register("mul", 2, lambda a, b: a, _ew(torch.mul))
_register("tanh", 1, lambda a: a, _ew(torch.tanh))
# Written out as the reference writes it, not torch.sigmoid.
_register("sigmoid", 1, lambda a: a, _ew(lambda x: 1.0 / (1.0 + torch.exp(-x))))
_register("relu", 1, lambda a: a, _ew(lambda x: torch.clamp(x, min=0.0)))
_register("concat2", 2, lambda a, b: a[:-1] + (a[-1] + b[-1],), _concat2)
_register("addmul", 4, lambda a, b, c, d: a,
          _ew(lambda a, b, c, d: a * b + c * d))
_register("lerp", 3, lambda z, h, hbar: h,
          _ew(lambda z, h, hbar: z * h + (1.0 - z) * hbar))


def _matmat(a, b):
    # (k,n,m) or (B,k,n,m) times (B,k,m,p)
    a = _bk(a, 2)
    b = _bk(b, 2)
    return torch.einsum("cknm,bkmp->bknp", a, b)


_register("matmat", 2, lambda a, b: (a[-2], b[-1]), _matmat)
