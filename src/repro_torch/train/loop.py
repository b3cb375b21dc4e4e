"""The training loop: an eager AdamW step over any ``TransformerLM``
config the port supports, with the reference's log line
(``src/repro/train/loop.py``).

A step is the loss, its gradients by autograd (on the card, attention's
through the flash-attention backward kernel) and :func:`adamw_update`.
The reference jits its step; here each step runs eagerly and is not
captured as a CUDA graph.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..arch.model import TransformerLM
from .optimizer import (AdamWConfig, adamw_update, init_opt_state, leaves,
                        unflatten)


@dataclass
class TrainState:
    params: object
    opt: object
    step: int = 0
    history: list = field(default_factory=list)


def make_train_step(model: TransformerLM, opt_cfg: AdamWConfig):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    with metrics ``{"lr", "grad_norm", "loss"}`` as tensors. ``batch``
    holds tensors on the model's device. The inputs are left alone: the
    step differentiates detached copies of the parameters' leaves."""

    def step(params, opt_state, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss = model.loss(unflatten(params, flat), batch)
            grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            params, opt_state, m = adamw_update(
                opt_cfg, unflatten(params, [p.detach() for p in flat]),
                unflatten(params, list(grads)), opt_state)
        m["loss"] = loss.detach()
        return params, opt_state, m

    return step


def train(model: TransformerLM, params, data_iter, steps: int,
          opt_cfg: AdamWConfig | None = None, log_every: int = 10,
          log_fn=print) -> TrainState:
    """``steps`` steps on batches from ``data_iter`` (dicts of arrays, as
    ``SyntheticCorpus`` yields), logging (and recording in ``history``)
    the loss at the first step and every ``log_every``-th."""
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    state = TrainState(params=params, opt=init_opt_state(params))
    step_fn = make_train_step(model, opt_cfg)
    t0 = time.perf_counter()
    for i in range(steps):
        batch = next(data_iter)
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        state.params, state.opt, m = step_fn(state.params, state.opt, batch)
        state.step = i + 1
        if (i + 1) % log_every == 0 or i == 0:
            loss = float(m["loss"])
            state.history.append(loss)
            log_fn(f"step {i + 1:5d} loss {loss:.4f} "
                   f"lr {float(m['lr']):.2e} "
                   f"gnorm {float(m['grad_norm']):.2f} "
                   f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
    return state
