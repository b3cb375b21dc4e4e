"""Wave-by-wave TransformerLM serving engine.

A synchronous loop that drains one wave of requests at a time against a
KV-cached :class:`~repro_torch.arch.model.TransformerLM`: the path that
serves the LM architectures of :mod:`repro_torch.arch`.

Serving a wave of requests is itself a dynamic-batching problem: the typed
dataflow graph has one chain per request — a PREFILL node (typed by prompt
length) followed by DECODE nodes — and the engine picks which *type* to
batch next exactly as Alg. 1 does. For chain topologies the
sufficient-condition/FSM policies recover the optimal schedule (prefill
buckets first, then lockstep decode waves). Schedules are cached per
request-graph topology.

Decoding is continuous-batching style: one pooled cache, per-slot
positions. Prefill caches are copied into the pool in place, and each
decode step updates the pool in place.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..arch.model import TransformerLM
from ..core.batching import (SufficientConditionPolicy, policy_cache_key,
                             resolve_schedule)
from ..core.cache import FIFOCache
from ..core.device import resolve_device
from ..core.graph import Graph, Node


@dataclass
class Request:
    prompt: list[int]
    max_new: int
    out: list[int] = field(default_factory=list)


@dataclass
class ServeStats:
    n_batches: int = 0
    n_prefill_batches: int = 0
    n_decode_batches: int = 0
    wall_s: float = 0.0
    schedule_s: float = 0.0      # wave-scheduling time (0 on cache hits)
    sched_cache_hits: int = 0
    tokens_out: int = 0

    @property
    def tok_per_s(self) -> float:
        return self.tokens_out / max(self.wall_s, 1e-9)


def _bucket(n: int) -> int:
    """Prefill type = exact prompt length: batches only group equal-length
    prompts, so no pad tokens pollute the causal prefix."""
    return n


def request_graph(reqs: list[Request]) -> Graph:
    """One chain per request: P<bucket> -> D -> D -> ..."""
    nodes: list[Node] = []
    for ri, r in enumerate(reqs):
        prev = len(nodes)
        nodes.append(Node(id=prev, type=f"P{_bucket(len(r.prompt))}",
                          inputs=(), attrs={"req": ri}))
        for _ in range(r.max_new - 1):
            nid = len(nodes)
            nodes.append(Node(id=nid, type="D", inputs=(nid - 1,),
                              attrs={"req": ri}))
    return Graph(nodes)


class ServeEngine:
    def __init__(self, model: TransformerLM, params, cache_len: int = 256,
                 policy=None, device=None):
        """``device``: where the engine serves; ``None`` means CUDA (and
        raises without it). It must be the model's device."""
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"ServeEngine on {self.device} was given a "
                             f"model on {model.device}")
        self.model = model
        self.params = params
        self.cache_len = cache_len
        self.policy = policy or SufficientConditionPolicy()
        # Wave schedules cached per request-graph topology: recurring traffic
        # shapes (same mix of prompt buckets and decode lengths) skip the
        # Alg. 1 walk entirely. FIFO-capped: long-running processes see an
        # unbounded stream of distinct wave shapes.
        self._sched_cache = FIFOCache(256)

    def generate(self, prompts: list[list[int]], max_new: int = 16,
                 stats: ServeStats | None = None):
        """Greedy decoding of ``max_new`` tokens per prompt. Returns the
        token lists and the stats (``stats``, if given, accumulates)."""
        reqs = [Request(list(p), max_new) for p in prompts]
        stats = stats if stats is not None else ServeStats()
        t0 = time.perf_counter()
        g = request_graph(reqs)
        key = (g.topology_key(), policy_cache_key(self.policy))
        sched = self._sched_cache.get(key)
        if sched is None:
            ts = time.perf_counter()
            sched = resolve_schedule(g, self.policy)
            stats.schedule_s += time.perf_counter() - ts
            self._sched_cache[key] = sched
        else:
            stats.sched_cache_hits += 1

        B = len(reqs)
        dev = self.device
        caches = None
        pos = np.zeros(B, np.int64)
        last_tok = np.zeros(B, np.int64)
        slot_of = {i: i for i in range(B)}

        with torch.no_grad():
            for ty, ids in sched:
                stats.n_batches += 1
                req_ids = [g.nodes[i].attrs["req"] for i in ids]
                if str(ty).startswith("P"):
                    stats.n_prefill_batches += 1
                    L = int(str(ty)[1:])
                    toks = np.zeros((len(req_ids), L), np.int64)
                    for j, ri in enumerate(req_ids):
                        p = reqs[ri].prompt
                        toks[j, L - len(p):] = p   # left-pad into the bucket
                    logits, cc = self.model.prefill(
                        self.params, torch.as_tensor(toks, device=dev),
                        cache_len=self.cache_len)
                    nxt = torch.argmax(logits, -1).cpu().numpy()
                    if caches is None:
                        caches = self._alloc(B)
                    for j, ri in enumerate(req_ids):
                        self._copy_slot(caches, cc, slot_of[ri], j)
                    for j, ri in enumerate(req_ids):
                        tok = int(nxt[j])
                        reqs[ri].out.append(tok)
                        last_tok[slot_of[ri]] = tok
                        pos[slot_of[ri]] = L
                        stats.tokens_out += 1
                else:
                    stats.n_decode_batches += 1
                    logits, caches = self.model.decode_step(
                        self.params, torch.as_tensor(last_tok, device=dev),
                        caches, torch.as_tensor(pos, device=dev))
                    nxt = torch.argmax(logits, -1).cpu().numpy()
                    for ri in req_ids:
                        s = slot_of[ri]
                        tok = int(nxt[s])
                        reqs[ri].out.append(tok)
                        last_tok[s] = tok
                        pos[s] += 1
                        stats.tokens_out += 1
        stats.wall_s += time.perf_counter() - t0
        return [r.out for r in reqs], stats

    # -- cache plumbing ------------------------------------------------------

    def _alloc(self, B: int):
        return self.model.init_cache(B, self.cache_len)

    @staticmethod
    def _copy_slot(pool, src, slot: int, j: int) -> None:
        """Copy request j's prefill caches into pool slot ``slot``, in
        place. Cache leaves are (R, B, ...); prefill happens once per
        request."""
        for dst_c, src_c in zip(pool, src):
            for key, dst in dst_c.items():
                dst[:, slot].copy_(src_c[key][:, j])


def serve_wave(model, params, prompts, max_new=16, cache_len=256, policy=None,
               device=None):
    eng = ServeEngine(model, params, cache_len, policy, device)
    return eng.generate(prompts, max_new)
