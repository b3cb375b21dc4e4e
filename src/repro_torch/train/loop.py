"""The training loop: an AdamW step over any ``TransformerLM`` config the
port supports, with the reference's log line (``src/repro/train/loop.py``).

A step is the loss, its gradients by autograd (on the card, attention's
through the flash-attention backward kernel) and the AdamW update. The
reference jits its step. Here :class:`StaticTrainStep` runs it over static
buffers (the parameter leaves, both moments, the step counter and the
batch), updated in place by :func:`~.optimizer.adamw_update_`; on the card
its first step is the eager warm-up of a CUDA-graph capture (by the rules
of :mod:`repro_torch.core.capture`) and every later step one replay; on
the CPU, or with ``capture=False``, every step runs the same body eagerly.
:func:`make_train_step` is the functional step (:func:`~.optimizer.
adamw_update`, one leaf at a time), the reference's form.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..arch.model import TransformerLM
from ..core.capture import CapturedGraph
from .optimizer import (AdamWConfig, adamw_update, adamw_update_,
                        init_opt_state, leaves, unflatten)


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


class StaticTrainStep:
    """The train step over static buffers: copies of the parameter leaves,
    of both moments and of the step counter (the inputs are left alone),
    and one batch buffer a batch shape, each run's batch copied in. A call
    runs one step and returns its metrics ``{"lr", "grad_norm", "loss"}``
    as device tensors (a replay's are the graph's own, overwritten by the
    next replay). With ``capture`` on the card, the first step of a batch
    shape is the eager warm-up of its capture, on a side stream, and every
    later one a replay; otherwise every step runs eagerly over the same
    buffers. A failed capture raises."""

    def __init__(self, model: TransformerLM, opt_cfg: AdamWConfig, params,
                 opt_state=None, capture: bool = True):
        self.model = model
        self.opt_cfg = opt_cfg
        self.tree = params
        opt_state = opt_state if opt_state is not None else \
            init_opt_state(params)
        self.params = [p.detach().clone() for p in leaves(params)]
        self.mu = [t.detach().clone() for t in leaves(opt_state["mu"])]
        self.nu = [t.detach().clone() for t in leaves(opt_state["nu"])]
        self.step = opt_state["step"].detach().clone().to(model.device)
        self.capture = bool(capture) and model.device.type == "cuda"
        self._batches: dict[tuple, dict[str, torch.Tensor]] = {}
        self._graphs: dict[tuple, CapturedGraph] = {}

    def _body(self, batch: dict) -> dict:
        flat = [p.detach().requires_grad_(True) for p in self.params]
        with torch.enable_grad():
            loss = self.model.loss(unflatten(self.tree, flat), batch)
            grads = list(torch.autograd.grad(loss, flat))
        with torch.no_grad():
            m = adamw_update_(self.opt_cfg, self.params, grads, self.mu,
                              self.nu, self.step)
        m["loss"] = loss.detach()
        return m

    def __call__(self, batch: dict) -> dict:
        """One step on ``batch`` (arrays or tensors by name)."""
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        kind = tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(batch.items()))
        static = self._batches.get(kind)
        if static is None:
            static = self._batches[kind] = {
                k: torch.empty(v.shape, dtype=v.dtype,
                               device=self.model.device)
                for k, v in batch.items()}
        for k, v in batch.items():
            static[k].copy_(v)
        if not self.capture:
            return self._body(static)
        entry = self._graphs.get(kind)
        if entry is None:
            entry = CapturedGraph(self.model.device)
            entry.statics = (list(static.values()) + self.params + self.mu
                             + self.nu + [self.step])
        m = entry.run_captured(lambda: self._body(static), reclaim=True)
        self._graphs[kind] = entry
        return m

    def state(self) -> tuple:
        """``(params, opt_state)``: trees over the static buffers."""
        return (unflatten(self.tree, self.params),
                {"mu": unflatten(self.tree, self.mu),
                 "nu": unflatten(self.tree, self.nu), "step": self.step})


def train(model: TransformerLM, params, data_iter, steps: int,
          opt_cfg: AdamWConfig | None = None, log_every: int = 10,
          log_fn=print, capture: bool = True) -> TrainState:
    """``steps`` steps on batches from ``data_iter`` (dicts of arrays, as
    ``SyntheticCorpus`` yields), logging (and recording in ``history``)
    the loss at the first step and every ``log_every``-th; the loss is
    read on the host only then. The steps run through
    :class:`StaticTrainStep`: on the card with ``capture`` step 1 is its
    capture's warm-up and every later step one replay; on the CPU or with
    ``capture=False`` every step runs eagerly over the same buffers.
    Returns the trained parameters and optimizer state (``params`` itself
    is left alone)."""
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    step_fn = StaticTrainStep(model, opt_cfg, params, capture=capture)
    state = TrainState(*step_fn.state())
    t0 = time.perf_counter()
    for i in range(steps):
        m = step_fn(next(data_iter))
        state.step = i + 1
        if (i + 1) % log_every == 0 or i == 0:
            loss = float(m["loss"])
            state.history.append(loss)
            log_fn(f"step {i + 1:5d} loss {loss:.4f} "
                   f"lr {float(m['lr']):.2e} "
                   f"gnorm {float(m['grad_norm']):.2f} "
                   f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
    return state
