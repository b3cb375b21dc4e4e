"""AdamW and the cosine learning-rate schedule, with the reference's
numerics (``src/repro/train/optimizer.py``): clipping by the global norm
with ``gnorm + 1e-9`` in the denominator, bias-corrected moments and
decoupled weight decay, all in float32. ``torch.optim.AdamW`` and
``clip_grad_norm_`` are not used: their epsilons sit elsewhere.

A bfloat16 leaf rounds where the reference rounds it. There ``scale`` and
``lr`` are float32 arrays, so JAX promotes ``g * scale`` and ``lr *
delta.astype(bf16)`` to float32: the clipped gradient stays float32, the
update ``delta`` is rounded to the parameter's dtype once, and ``p - lr *
delta`` is formed in float32 and rounded once. A 0-d tensor does not
promote in PyTorch, so both forms here upcast by hand. The moments stay
float32 beside every leaf.

Parameters, gradients and moments are trees of tensors (dicts, tuples,
lists); the state is ``{"mu", "nu", "step"}`` as in the reference, with
``step`` a 0-d int32 tensor. ``adamw_update`` is functional, as the
reference's: it returns new trees and leaves its inputs alone, one leaf
at a time. ``adamw_update_`` is the same step in place over flat lists
of leaves, each stage one multi-tensor (``torch._foreach_*``) operation
over all of them, and reads nothing back to the host: the step the
trainer captures (``train/loop.py``), where XLA fuses the reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..arch.model import tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


def leaves(tree) -> list:
    """The tensors of a tree in the reference's order (``jax.tree.leaves``:
    dict keys sorted, sequences in order)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in leaves(sub)]
    return [tree]


def unflatten(tree, flat: list):
    """A tree of ``tree``'s structure holding ``flat`` (in :func:`leaves`
    order)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    return build(tree)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine down to ``min_lr_ratio`` of
    it at ``total_steps``: a float32 tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.lr * (cfg.min_lr_ratio
                    + (1 - cfg.min_lr_ratio) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict[str, Any]:
    """Zero moments in float32 beside each parameter, and step 0."""
    first = leaves(params)[0]
    return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total))


def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step. Returns ``(new_params, new_state, metrics)`` with
    metrics ``{"lr", "grad_norm"}`` (tensors, not synchronised)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()

    def upd(p, g, mu, nu):
        g32 = g.float() * scale
        mu2 = cfg.b1 * mu + (1 - cfg.b1) * g32
        nu2 = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g32)
        mhat = mu2 / bc1
        nhat = nu2 / bc2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return ((p.float() - lr * delta.to(p.dtype).float()).to(p.dtype),
                mu2, nu2)

    out = [upd(p, g, m, n) for p, g, m, n in zip(
        leaves(params), leaves(grads), leaves(state["mu"]),
        leaves(state["nu"]))]
    new_state = {"mu": unflatten(params, [o[1] for o in out]),
                 "nu": unflatten(params, [o[2] for o in out]),
                 "step": step}
    return (unflatten(params, [o[0] for o in out]), new_state,
            {"lr": lr, "grad_norm": gnorm})


def grad_norm(grads: list) -> torch.Tensor:
    """The global norm of flat gradient leaves in float32: each leaf's
    norm by one multi-tensor operation (leaves of a lower precision
    upcast, as the reference's ``x.astype(float32)``), then the norm of
    those. Its last bits follow this summation order, not the
    reference's."""
    kw = ({} if all(g.dtype == torch.float32 for g in grads)
          else {"dtype": torch.float32})
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads, 2, **kw)))


def adamw_update_(cfg: AdamWConfig, params: list, grads: list, mu: list,
                  nu: list, step: torch.Tensor) -> dict[str, torch.Tensor]:
    """One AdamW step in place over flat lists of leaves (:func:`leaves`
    order): ``params``, ``mu``, ``nu`` and the 0-d ``step`` counter are
    updated in place, and float32 ``grads`` are scaled in place (they are
    the step's scratch). The per-element formula is :func:`adamw_update`'s:
    the clip scale ``min(1, clip / (gnorm + 1e-9))``, bias corrections ``1
    - b^step``, decoupled decay, ``lr_at`` of the new step, all as device
    tensors. Leaves held in a lower precision (a bfloat16 model's) take
    :func:`_low_precision_update_`, which rounds as :func:`adamw_update`
    rounds; the gradient norm is float32 either way. Returns the metrics
    ``{"lr", "grad_norm"}`` (not synchronised)."""
    step.add_(1)
    gnorm = grad_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    if any(p.dtype != torch.float32 for p in params):
        _low_precision_update_(cfg, params, grads, mu, nu, scale, lr, bc1,
                               bc2)
        return {"lr": lr, "grad_norm": gnorm}
    torch._foreach_mul_(grads, scale)
    torch._foreach_mul_(mu, cfg.b1)
    torch._foreach_add_(mu, grads, alpha=1 - cfg.b1)
    torch._foreach_mul_(nu, cfg.b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - cfg.b2)
    denom = torch._foreach_div(nu, bc2)             # nhat
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    delta = torch._foreach_div(mu, bc1)             # mhat
    torch._foreach_div_(delta, denom)
    torch._foreach_add_(delta, params, alpha=cfg.weight_decay)
    torch._foreach_mul_(delta, lr)
    torch._foreach_sub_(params, delta)
    return {"lr": lr, "grad_norm": gnorm}


def _low_precision_update_(cfg: AdamWConfig, params: list, grads: list,
                           mu: list, nu: list, scale, lr, bc1, bc2) -> None:
    """:func:`adamw_update_`'s step for leaves held in a lower precision
    than float32 (float32 leaves among them pass through unrounded), each
    operation as the reference orders it: the clipped gradient
    ``g.float() * scale`` in a float32 scratch (the gradients are left
    alone), ``b1 mu + (1 - b1) g`` and ``b2 nu + (1 - b2) g^2`` as products
    then a sum, ``delta`` rounded to the parameter's dtype, then
    ``p.float() - lr * delta`` in float32, rounded once into ``params``."""
    g32 = [g.float() for g in grads]
    torch._foreach_mul_(g32, scale)
    torch._foreach_mul_(mu, cfg.b1)
    torch._foreach_add_(mu, torch._foreach_mul(g32, 1 - cfg.b1))
    sq = torch._foreach_mul(g32, g32)
    torch._foreach_mul_(sq, 1 - cfg.b2)
    torch._foreach_mul_(nu, cfg.b2)
    torch._foreach_add_(nu, sq)
    del g32, sq
    denom = torch._foreach_div(nu, bc2)             # nhat
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    delta = torch._foreach_div(mu, bc1)             # mhat
    torch._foreach_div_(delta, denom)
    del denom
    p32 = [p.float() for p in params]
    torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
    lr_delta = [d.to(p.dtype).float() for d, p in zip(delta, params)]
    del delta
    torch._foreach_mul_(lr_delta, lr)
    torch._foreach_sub_(p32, lr_delta)
    torch._foreach_copy_(params, p32)
