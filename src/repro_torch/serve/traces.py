"""Synthetic request traces, shared by the launcher, example, and benchmark
so they all measure the same traffic distribution.

``synth_trace`` round-robins over a family list (duplicates weight a
family, e.g. ``["lm", "lm", "tree"]`` is 2:1 lm:tree). Arrival times (in
virtual scheduler rounds) come from ``synth_arrivals``:

- ``constant`` — ``i / rate``: a deterministic open-loop stream (default);
- ``poisson``  — exponential inter-arrival gaps at ``rate`` per round, the
  standard open-loop memoryless model;
- ``burst``    — bursts of ``burst_size`` simultaneous arrivals spaced so
  the long-run rate still matches ``rate`` — the adversarial shape for a
  batch-formation policy (all-at-once admission, then silence).

All three keep the same mean rate, so latency/throughput numbers across
arrival processes are comparable.
"""

from __future__ import annotations

import random

import numpy as np

from .queue import ServeRequest, graph_request, lm_request

ARRIVALS = ("constant", "poisson", "burst")


def synth_arrivals(n: int, rate: float, arrivals: str = "constant",
                   seed: int = 0, burst_size: int = 4) -> list[float]:
    """``n`` virtual arrival times at a long-run mean of ``rate`` per round."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if arrivals == "constant":
        return [i / rate for i in range(n)]
    if arrivals == "poisson":
        # Distinct stream from the request-content RNG (which is seeded
        # with the bare seed): identically-seeded generators would make
        # the i-th inter-arrival gap and the i-th prompt-length draw
        # transforms of the same random values, correlating arrival times
        # with request sizes.
        nrng = np.random.default_rng([seed, 1])
        return list(np.cumsum(nrng.exponential(1.0 / rate, size=n)))
    if arrivals == "burst":
        if burst_size < 1:
            raise ValueError(f"burst_size must be >= 1, got {burst_size}")
        return [(i // burst_size) * (burst_size / rate) for i in range(n)]
    raise ValueError(f"unknown arrival process {arrivals!r}; "
                     f"choose from {ARRIVALS}")


def synth_trace(families: list[str], n: int, rate: float, max_new: int,
                workloads, seed: int = 0, *, prompt_lo: int = 3,
                prompt_hi: int = 8, tree_leaves: tuple[int, int] = (4, 8),
                lattice_chars: tuple[int, int] = (5, 10),
                arrivals: str = "constant", burst_size: int = 4
                ) -> list[ServeRequest]:
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    times = synth_arrivals(n, rate, arrivals, seed, burst_size)
    reqs: list[ServeRequest] = []
    for i in range(n):
        fam = families[i % len(families)]
        arrival = times[i]
        if fam == "lm":
            vocab = getattr(workloads["lm"], "vocab", 256)
            length = int(nrng.integers(prompt_lo, prompt_hi + 1))
            prompt = list(map(int, nrng.integers(0, vocab, length)))
            reqs.append(lm_request(prompt, max_new, arrival))
        elif fam == "tree":
            g = workloads["tree"].sample_graph(rng, 1, leaves_lo=tree_leaves[0],
                                               leaves_hi=tree_leaves[1])
            reqs.append(graph_request("tree", g, arrival))
        elif fam == "lattice":
            g = workloads["lattice"].sample_graph(rng, 1, lo=lattice_chars[0],
                                                  hi=lattice_chars[1])
            reqs.append(graph_request("lattice", g, arrival))
        else:
            raise ValueError(f"unknown family {fam!r}")
    return reqs
