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
decode step updates the pool in place. The pool of a wave of B requests
belongs to the decode step of B slots and is kept with it (one per ``(B,
cache_len)``, FIFO-capped with the prefills), where the reference makes
one a wave; each wave zeroes it in place first, to the reference's
fresh pool. That matters where a schedule decodes before every prompt is
prefilled: a decode step runs over all B slots, an unfilled slot's row
reads its SSM state (or its cross cache), and an MoE layer routes the
step's rows as one group whose expert capacity they share, so a stale
row could drop another row's token. One engine serves one wave at a
time: two threads calling :meth:`ServeEngine.generate` on one engine
would share a pool.

A model with cross-attention layers is refused: its prefill needs image
embeddings, which a wave's requests (token prompts) do not carry, as the
reference's wave passes none.

The reference jits the prefill and the decode step. On the card (with
``capture``, the default) each is one CUDA graph: a prefill per ``(B, L,
cache_len)``, a decode step per ``(B, cache_len)``, captured by the rules
of :mod:`repro_torch.core.capture` over static token (and position)
buffers, with the argmax inside the graph, so that the host reads only the
tokens after a replay. The first run of each is its eager warm-up, and
the graphs replay from the second on. ``capture=False``, or the CPU, runs
the same bodies eagerly over the same static buffers.

An engine serves in its model's dtype (float32 or bfloat16): the
parameters must be of it, and the decode pools, the caches the prefills
write and the logits are. The argmax in the graph takes the first of
equal logits, as ``jnp.argmax`` does, which matters in bfloat16, where
logits tie often.
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
from ..core.capture import CapturedGraph, tensors_of
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
    n_captures: int = 0          # CUDA graphs captured (prefill, decode)
    n_replays: int = 0           # and replayed

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


class _WaveProgram(CapturedGraph):
    """One of the wave's programs (a prefill of B prompts of L tokens, or a
    decode step over B slots and their ``pool``): ``body()`` over the
    static input buffers ``statics``. With ``capture`` its first run is the
    eager warm-up of a capture, and later runs replay the graph; else every
    run is ``body()`` eagerly."""

    def __init__(self, body, statics: list[torch.Tensor],
                 device: torch.device, capture: bool, pool=None):
        super().__init__(device)
        self.body = body
        self.statics = statics
        self.capture = capture
        self.pool = pool

    def run(self, stats: ServeStats, *inputs: np.ndarray):
        """Copy ``inputs`` into the static buffers and run; returns the
        body's outputs (a replay's are the graph's own, overwritten by the
        next replay)."""
        for buf, x in zip(self.statics, inputs):
            buf.copy_(torch.from_numpy(x))
        if not self.capture:
            return self.body()
        if self.graph is None:
            stats.n_captures += 1
        else:
            stats.n_replays += 1
        return self.run_captured(self.body, reclaim=True)


class ServeEngine:
    """Serves waves of requests, one wave at a time: the decode pool of B
    slots is kept across waves, so two threads must not call
    :meth:`generate` on one engine at once."""

    def __init__(self, model: TransformerLM, params, cache_len: int = 256,
                 policy=None, device=None, capture: bool = True):
        """``device``: where the engine serves; ``None`` means CUDA (and
        raises without it). It must be the model's device. ``capture``
        (on the card): the prefill and the decode step run as captured
        CUDA graphs (module docstring); False runs them eagerly."""
        self.device = resolve_device(device)
        cross = [s for s in model.cfg.pattern if s.mixer == "cross_attn"]
        if cross:
            raise ValueError(
                f"{model.cfg.name}: the wave engine serves token prompts, "
                f"and a model with cross-attention layers ({len(cross)} "
                f"of its pattern) needs image embeddings at prefill")
        if self.device != model.device:
            raise ValueError(f"ServeEngine on {self.device} was given a "
                             f"model on {model.device}")
        dtypes = {t.dtype for t in tensors_of(params)}
        if dtypes != {model.dtype}:
            raise ValueError(f"ServeEngine of a {model.dtype} model was "
                             f"given parameters of {sorted(map(str, dtypes))}")
        self.model = model
        self.params = params
        self.cache_len = cache_len
        self.policy = policy or SufficientConditionPolicy()
        self.capture = bool(capture) and self.device.type == "cuda"
        # Wave schedules cached per request-graph topology: recurring traffic
        # shapes (same mix of prompt buckets and decode lengths) skip the
        # Alg. 1 walk entirely. FIFO-capped: long-running processes see an
        # unbounded stream of distinct wave shapes.
        self._sched_cache = FIFOCache(256)
        # The wave's programs for the params they were built for, each with
        # its graph and its pool (a decode step with its slots' caches too),
        # capped like the schedules.
        self._programs = FIFOCache(32)
        self._built_for: tuple = ()

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
        self._check_params()
        pos = np.zeros(B, np.int64)
        last_tok = np.zeros(B, np.int64)
        slot_of = {i: i for i in range(B)}

        with torch.no_grad():
            decode = self._decode(B)
            pool = decode.pool
            for cache in pool:    # the reference's fresh pool, in place
                for leaf in cache.values():
                    leaf.zero_()
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
                    nxt, cc = self._prefill(len(req_ids), L).run(stats, toks)
                    for j, ri in enumerate(req_ids):
                        self._copy_slot(pool, cc, slot_of[ri], j)
                    nxt = nxt.cpu().numpy()
                    for j, ri in enumerate(req_ids):
                        tok = int(nxt[j])
                        reqs[ri].out.append(tok)
                        last_tok[slot_of[ri]] = tok
                        pos[slot_of[ri]] = L
                        stats.tokens_out += 1
                else:
                    stats.n_decode_batches += 1
                    nxt = decode.run(stats, last_tok, pos)
                    nxt = nxt.cpu().numpy()
                    for ri in req_ids:
                        s = slot_of[ri]
                        tok = int(nxt[s])
                        reqs[ri].out.append(tok)
                        last_tok[s] = tok
                        pos[s] += 1
                        stats.tokens_out += 1
        stats.wall_s += time.perf_counter() - t0
        return [r.out for r in reqs], stats

    # -- the wave's programs -------------------------------------------------

    def _check_params(self) -> None:
        """Drop the programs (captured over the params' tensors) once
        ``params`` holds other tensors."""
        ptrs = tuple(t.data_ptr() for t in tensors_of(self.params))
        if ptrs != self._built_for:
            self._programs.clear()
            self._built_for = ptrs

    def _prefill(self, B: int, L: int) -> _WaveProgram:
        """The prefill of B prompts of L tokens: (next tokens (B,), the
        decode caches of its rows)."""
        key = ("prefill", B, L, self.cache_len)
        prog = self._programs.get(key)
        if prog is None:
            # the body holds what it reads, not the engine: an engine in a
            # reference cycle with its graphs would be freed by Python's
            # cyclic collector, at any time, another capture's included
            model, params, cache_len = self.model, self.params, self.cache_len
            toks = torch.zeros((B, L), dtype=torch.int64, device=self.device)

            def body():
                logits, cc = model.prefill(params, toks, cache_len=cache_len)
                return torch.argmax(logits, -1), cc

            prog = self._programs[key] = _WaveProgram(
                body, [toks], self.device, self.capture)
            prog.pinned = tensors_of(params)
        return prog

    def _decode(self, B: int) -> _WaveProgram:
        """One decode step of B slots: next tokens (B,); its ``pool``, the
        slots' decode caches, made with it, updated in place."""
        key = ("decode", B, self.cache_len)   # the pool: the model's dtype
        prog = self._programs.get(key)
        if prog is None:
            model, params = self.model, self.params   # as in _prefill
            tok = torch.zeros(B, dtype=torch.int64, device=self.device)
            pos = torch.zeros(B, dtype=torch.int64, device=self.device)
            pool = model.init_cache(B, self.cache_len)

            def body():
                logits, _ = model.decode_step(params, tok, pool, pos)
                return torch.argmax(logits, -1)

            prog = self._programs[key] = _WaveProgram(
                body, [tok, pos], self.device, self.capture, pool)
            prog.pinned = tensors_of(params) + tensors_of(pool)
        return prog

    # -- cache plumbing ------------------------------------------------------

    @staticmethod
    def _copy_slot(pool, src, slot: int, j: int) -> None:
        """Copy request j's prefill caches into pool slot ``slot``, in
        place: the slot's whole row of every leaf (each repeat's k and v,
        ring slots included; the SSM conv and state caches), so that
        nothing of an earlier wave's request stays in it. Cache leaves are
        (R, B, ...); prefill happens once per request."""
        for dst_c, src_c in zip(pool, src):
            for key, dst in dst_c.items():
                dst[:, slot].copy_(src_c[key][:, j])


def serve_wave(model, params, prompts, max_new=16, cache_len=256, policy=None,
               device=None):
    eng = ServeEngine(model, params, cache_len, policy, device)
    return eng.generate(prompts, max_new)
