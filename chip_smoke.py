#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Card and build: prints the card's name and power limit (as nvidia-smi
   gives them), builds the CUDA kernels from ``src/repro_torch/csrc`` with
   nvcc into ``build/repro_torch/`` and prints the build seconds and the
   ptxas resource lines.
2. Kernels: each kernel against its plain PyTorch version on the card at
   the path's shapes (gather bit-equal; fused cell within 1e-4, TF32 off),
   then timed cold (L2 flushed before every launch, CUDA events, median)
   beside the plain version and, for the gather, ``torch.index_select``.
3. The slice: BiLSTM-Tagger at model_size=512 on CUDA. An FSM policy is
   learned on small graphs, then fresh 16-sentence minibatches (and one
   repeat) run through the interpreted, per-topology and bucketed
   executors. All three must agree within 1e-4 on every tag logit ``y``,
   the first minibatch must match a plain-PyTorch run of the same seed on
   the CPU, and both kernels' launch counters must rise during the slice.
   Prints steady-state ms per run for each executor and the plan stats.

The line before the last is ``{"kernels": [...]}`` (per kernel: launches in
the slice, max error, kernel / plain / bound / library ms); the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEM_BW = 3.35e12        # H100 SXM HBM3 bytes/s (data sheet)
FP32_PEAK = 67e12       # H100 SXM fp32 FLOP/s outside the tensor cores
MODEL_SIZE = 512
BATCH = 16              # sentences per minibatch, as benchmarks/bench_plan.py
N_FRESH = 3             # fresh topologies, then one repeat of the first
SEED = 0


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing ---------------------------------------------------------------


class ColdTimer:
    """Times one call at a time on the card with the L2 cache flushed
    before each (``cold=True``) or not, and returns the median in ms. A
    spin kernel holds the stream while the host enqueues the call, so the
    events bracket device time and not the wrapper's host overhead."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 30, warmup: int = 3,
                 cold: bool = True) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            if cold:
                self.flush.zero_()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


# -- phase 1 --------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_info.get('seconds', 0.0):.2f} s)")
    for src, report in sorted(build.build_info.get("ptxas", {}).items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")


# -- phase 2 --------------------------------------------------------------


def check_gather(torch, timer) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.gather_batch import gather_rows

    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        ("path K=256", (2048, MODEL_SIZE), torch.float32, 256),
        ("path K=16", (2048, MODEL_SIZE), torch.float32, 16),
        ("ragged D=17", (512, 17), torch.float32, 100),
        ("3-D rows", (300, 4, 24), torch.float32, 77),
        ("bf16", (1000, MODEL_SIZE), torch.bfloat16, 64),
        ("fp16 ragged", (257, 33), torch.float16, 40),
    ]
    worst = 0.0
    for label, shape, dtype, k in cases:
        src = torch.randn(shape, generator=g, device="cuda").to(dtype)
        idx = torch.randint(0, shape[0], (k,), generator=g, device="cuda",
                            dtype=torch.int32)
        idx[: k // 4] = idx[0]                      # duplicate indices
        idx[k // 4] = -1                            # counts from the end
        idx[k // 4 + 1] = -shape[0]
        out = gather_rows(src, idx)
        want = ref.gather_rows_ref(src, idx)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        worst = max(worst, err)
        if not torch.equal(out, want):
            fail(f"gather_rows {label}: not bit-equal to the plain version "
                 f"(max abs err {err})")
        log(f"gather_rows {label}: {tuple(shape)} {dtype} K={k} bit-equal")

    N, D, K = 2048, MODEL_SIZE, 256
    src = torch.randn((N, D), generator=g, device="cuda")
    idx = torch.randint(0, N, (K,), generator=g, device="cuda",
                        dtype=torch.int32)
    idx_long = idx.long()
    ms = timer(lambda: gather_rows(src, idx))
    plain_ms = timer(lambda: ref.gather_rows_ref(src, idx))
    library_ms = timer(lambda: torch.index_select(src, 0, idx_long))
    log(f"gather_rows warm ms (L2-resident): kernel "
        f"{timer(lambda: gather_rows(src, idx), cold=False):.4f}, plain "
        f"{timer(lambda: ref.gather_rows_ref(src, idx), cold=False):.4f}")
    nbytes = 2 * K * D * 4 + K * 4
    return {"name": "gather_rows", "route": "cuda",
            "source": "src/repro_torch/csrc/gather_rows.cu",
            "replaces": "src/repro/kernels/gather_batch.py:26",
            "shape": f"src ({N}, {D}) float32, K={K}",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / MEM_BW * 1e3, "bound_by": "bytes",
            "library_ms": library_ms}


def check_fused(torch, timer) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_gather_cell import fused_gather_lstm_cell

    E = H = MODEL_SIZE
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    Nx, Nh = 2048, 2048
    x_src = torch.randn((Nx, E), generator=g, device="cuda")
    h_src = torch.randn((Nh, H), generator=g, device="cuda")
    c_src = torch.randn((Nh, H), generator=g, device="cuda")
    w = 0.05 * torch.randn((E + H, 4 * H), generator=g, device="cuda")
    b = 0.1 * torch.randn((4 * H,), generator=g, device="cuda")

    def idx(n, B):
        return torch.randint(0, n, (B,), generator=g, device="cuda",
                             dtype=torch.int32)

    worst = 0.0
    cases = [(f"B={B}", idx(Nx, B), idx(Nh, B), idx(Nh, B))
             for B in (1, 16, 32)]
    ix = torch.tensor([0, 0, 0, 3, 3, 3] + [9] * 10, device="cuda",
                      dtype=torch.int32)
    cases.append(("duplicate and pad lanes", ix, ix.flip(0).contiguous(), ix))
    neg = torch.tensor([-1, -Nx, 5, -2], device="cuda", dtype=torch.int32)
    cases.append(("negative indices", neg, neg.flip(0).contiguous(), neg))
    for label, ix, ih, ic in cases:
        h2, c2 = fused_gather_lstm_cell(x_src, h_src, c_src, ix, ih, ic, w, b)
        hr, cr = ref.fused_gather_lstm_cell_ref(x_src, h_src, c_src, ix, ih,
                                                ic, w, b)
        torch.cuda.synchronize()
        err = max(float((h2 - hr).abs().max()), float((c2 - cr).abs().max()))
        if not err <= 1e-4:
            fail(f"fused_gather_lstm_cell {label}: max abs err {err} > 1e-4")
        worst = max(worst, err)
        log(f"fused_gather_lstm_cell {label}: max abs err {err:.3e}")

    B = BATCH
    ix, ih, ic = idx(Nx, B), idx(Nh, B), idx(Nh, B)
    ms = timer(lambda: fused_gather_lstm_cell(x_src, h_src, c_src, ix, ih, ic,
                                              w, b))
    plain_ms = timer(lambda: ref.fused_gather_lstm_cell_ref(
        x_src, h_src, c_src, ix, ih, ic, w, b))
    for Bt in (1, 16, 32):
        jx, jh, jc = idx(Nx, Bt), idx(Nh, Bt), idx(Nh, Bt)

        def call():
            return fused_gather_lstm_cell(x_src, h_src, c_src, jx, jh, jc, w, b)
        log(f"fused_gather_lstm_cell B={Bt} ms: cold {timer(call):.4f}, "
            f"warm (L2-resident) {timer(call, cold=False):.4f}")
    K = E + H
    nbytes = (K * 4 * H + 4 * H + B * (E + 2 * H) + 2 * B * H) * 4 + 3 * B * 4
    flops = 2 * B * K * 4 * H
    t_bytes, t_ops = nbytes / MEM_BW, flops / FP32_PEAK
    return {"name": "fused_gather_lstm_cell", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_gather_lstm_cell.cu",
            "replaces": "src/repro/kernels/fused_gather_cell.py:47",
            "shape": f"E=H={E}, B={B}, float32",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


# -- phase 3 --------------------------------------------------------------


def y_logits(res):
    """Every tag logit of a run, on the host, and the number of y nodes."""
    ids = list(res.nodes_with_field("y"))
    return res.field("y", ids).float().cpu(), len(ids)


def profile_run(torch, fn) -> dict:
    """One traced run: device time (kernel and copy events on the card, which
    run on one stream and do not overlap) over the wall time, and the six
    event names that took the most device time, as [name, count, ms]. The
    wall time includes the profiler's own host cost, so the busy share is a
    lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in events)
    names: dict[str, list] = {}
    for e in events:
        entry = names.setdefault(e.name[:60], [0, 0.0])
        entry[0] += 1
        entry[1] += e.time_range.elapsed_us() / 1e3
    top = sorted(([n, c, ms] for n, (c, ms) in names.items()),
                 key=lambda t: -t[2])[:6]
    return {"wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
            "busy_share": device_us / wall_us if events else None,
            "device_events": len(events), "top_events": top}


def run_slice(device: str, model_size: int = MODEL_SIZE, batch: int = BATCH,
              n_fresh: int = N_FRESH, timed_reps: int = 5,
              lengths: tuple[int, int] = (8, 24)) -> dict:
    """The port's batched-execution path, as a user drives it: learn an
    FSM, then run minibatches (sentences of ``lengths`` tokens) through the
    three executors and check that they agree. The first minibatch must
    also match the interpreted run of the same seed's workload on the CPU,
    where every kernel is its plain version."""
    import torch
    from repro_torch.core.device import block
    from repro_torch.core.executor import DynamicExecutor
    from repro_torch.core.plan import BucketedPlanExecutor, PlanExecutor
    from repro_torch.core.rl import RLConfig, train_fsm
    from repro_torch.models.workloads import make_workload

    dev = torch.device(device)
    rng = random.Random(SEED)
    wl = make_workload("BiLSTM-Tagger", model_size, SEED, device=device)
    t0 = time.perf_counter()
    fsm = train_fsm([wl.sample_graph(rng, 2) for _ in range(3)],
                    RLConfig(max_iters=600, seed=SEED))
    report = {"rl_s": time.perf_counter() - t0, "rl_iters": fsm.iters}
    policy = fsm.policy
    execs = {
        "interpreted": DynamicExecutor(wl.impls, None, device=device),
        "per_topology": PlanExecutor(wl.impls, None, donate=True,
                                     device=device),
        "bucketed": BucketedPlanExecutor(wl.impls, None, device=device),
    }
    graphs = [wl.sample_graph(rng, batch, *lengths) for _ in range(n_fresh)]
    graphs.append(graphs[0])                     # one repeat topology
    worst = 0.0
    for gi, g in enumerate(graphs):
        ys = {}
        for name, ex in execs.items():
            y, n_y = y_logits(ex.run(g, policy))
            if tuple(y.shape) != (n_y, 17) or not torch.isfinite(y).all():
                fail(f"{name} on minibatch {gi}: bad y {tuple(y.shape)}")
            ys[name] = y
        for name in ("per_topology", "bucketed"):
            err = float((ys[name] - ys["interpreted"]).abs().max())
            worst = max(worst, err)
            if not err <= 1e-4:
                fail(f"{name} vs interpreted on minibatch {gi}: max abs err "
                     f"{err} > 1e-4")
        if gi == 0:
            cpu_wl = make_workload("BiLSTM-Tagger", model_size, SEED,
                                   device="cpu")
            y_ref, _ = y_logits(DynamicExecutor(
                cpu_wl.impls, None, device="cpu").run(g, policy))
            err = float((ys["interpreted"] - y_ref).abs().max())
            report["max_abs_err_vs_cpu"] = err
            if not err <= 1e-4:
                fail(f"{device} vs the CPU plain run: max abs err {err}")
        log(f"slice minibatch {gi}: {len(g)} nodes, executors agree "
            f"(max abs err {worst:.3e})")
    report["max_abs_err_executors"] = worst

    g = graphs[0]
    ms = {}
    for name, ex in execs.items():
        times = []
        for _ in range(timed_reps):
            block(dev)
            t = time.perf_counter()
            ex.run(g, policy)
            block(dev)
            times.append((time.perf_counter() - t) * 1e3)
        ms[name] = statistics.median(times)
    report["ms_per_run"] = ms
    if dev.type == "cuda":
        report["profile"] = {
            name: profile_run(torch, lambda: ex.run(g, policy))
            for name, ex in execs.items()}
    plan = execs["per_topology"].plan_for(g, policy)
    report["graph_nodes"] = len(g)
    report["n_batches"] = len(plan.steps)
    report["plan_stats"] = plan.stats.as_dict()
    report["bucketed_stats"] = (execs["bucketed"].pack_for(g, policy)
                                .stats.as_dict())
    report["bucket_compiles"] = execs["bucketed"].n_bucket_compiles
    return report


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    build_kernels()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = ColdTimer(torch)
    rows = [check_gather(torch, timer), check_fused(torch, timer)]

    from repro_torch.kernels.fused_gather_cell import fused_gather_lstm_cell
    from repro_torch.kernels.gather_batch import gather_rows

    wrappers = {"gather_rows": gather_rows,
                "fused_gather_lstm_cell": fused_gather_lstm_cell}
    for fn in wrappers.values():
        fn.launches = 0
    report = run_slice("cuda")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched during the slice")
    for row in rows:
        row["launches"] = launches[row["name"]]
    log(f"slice: {json.dumps(report, default=str)}")
    log(f"slice ms per run: {report['ms_per_run']} ({card})")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
