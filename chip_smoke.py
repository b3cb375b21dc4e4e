#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. Card and build: prints the card's name and power limit (as nvidia-smi
   gives them), builds the CUDA kernels from ``src/repro_torch/csrc`` with
   nvcc into ``build/repro_torch/`` and prints the build seconds and the
   ptxas resource lines.
2. Kernels: counts the tensor-core (``HMMA``) instructions of the
   attention, scan and both LSTM-cell kernels in the built library
   (``cuobjdump -sass``, where the toolkit has it; none fails). Times an
   empty kernel launched through the library in the same timer as the
   kernels (the ``launch floor:`` line). Then each kernel against its
   plain PyTorch version on the card at the path's shapes and edge cases
   (gather bit-equal; the others within 1e-4, TF32 off; the scan also
   from a random initial state), then timed cold (L2 flushed before every
   launch, CUDA events, median) beside the plain version and, where one
   PyTorch call computes the same function, that call
   (``torch.index_select``, ``torch._VF.lstm_cell``,
   ``scaled_dot_product_attention``, whose kernel names one profiled call
   prints; yardsticks the port never calls). The gather is timed cold and
   warm beside ``index_select`` at the path's shapes (``GATHER_TIMED``),
   both cells cold and warm at B = 1, 16, 32, attention and scan at both
   prefill shapes of their LM wave. The dense LSTM cell is also checked on
   gathered rows against the gather cell; no model path launches it, so
   its launches are those of its checks.
3. The slice: BiLSTM-Tagger at model_size=512 on CUDA. An FSM policy is
   learned on small graphs, then fresh 16-sentence minibatches (and one
   repeat) run through the interpreted, per-topology and bucketed
   executors. All three must agree within 1e-4 on every tag logit ``y``,
   the first minibatch must match a plain-PyTorch run of the same seed on
   the CPU, and the gather and fused-cell launch counters must rise during
   the slice. Prints steady-state ms per run for each executor, the plan
   stats, the gather's ``(K, row bytes)`` launch histogram, and the device
   us of the gather and cell kernels in the profiled bucketed run with
   their share of its device time.
4. The LM wave: Qwen2-0.5B, then Mamba2-130m, at full published width and
   depth (random weights from the seed, made on the CPU and copied to the
   card) through the port's wave ``ServeEngine``: six requests, eight new
   tokens each. The flash-attention (Qwen2) and SSD-scan (Mamba2) launch
   counters must rise during the wave; the tokens must equal the same wave
   on the CPU (plain versions only), apart from a near-tie flip within the
   logit tolerance, and one prefill batch's logits must agree with the CPU
   within 2e-3 of the largest |logit|. Prints tokens/s, ms per prefill
   batch and per decode wave, the batch counts and a profiler summary.
5. Trees and lattices at model_size=512: TreeLSTM and LatticeLSTM as the
   tagger runs (two fresh 16-instance minibatches and a repeat through the
   three executors), TreeGRU, MV-RNN, TreeLSTM-2Type and LatticeGRU one
   minibatch through the interpreted and bucketed executors; each against
   the CPU plain run within 1e-4, but MV-RNN, whose float32 result is not
   resolved to 1e-4, against a float64 run (``run_slice``). The gather
   launch counter must rise in every workload and the fused-cell counter
   in LatticeLSTM. Prints ms per run, batches against their lower bound,
   plan stats, lowering seconds, the bucketed busy share and the gather's
   ``(K, row bytes)`` launch histogram.

Phases 2 and 4 hold the kernels other than the gather to 1e-4 of the
largest magnitude of their plain versions' outputs. The line before the
last is ``{"kernels": [...]}`` (per kernel: launches in the phase that
drives its path, max abs error, kernel / plain / bound / library ms);
phase 2 logs each bound's byte and operation times and the peak it
divides by (3xTF32 on the tensor cores for every kernel with products) on
a ``<kernel> bound:`` line; the last line is ``{"ok": true, "device":
{...}}``. The total seconds are printed before them. Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result. ``--phases`` and ``--workloads`` run a part (phase 1 always) and
then print no result lines.
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
TF32X3_PEAK = 495e12 / 3   # fp32 products as 3xTF32 on the tensor cores
MODEL_SIZE = 512
BATCH = 16              # sentences per minibatch, as benchmarks/bench_plan.py
N_FRESH = 3             # fresh topologies, then one repeat of the first
SEED = 0
# (K, row bytes) at which the gather is timed beside index_select: the
# path's most frequent K (TreeLSTM 1, the tagger 16), K = 256 (timed since
# the first port) and the largest K of both (512), all rows of 2048 bytes
# (`gather shapes` lines of phases 3 and 5)
GATHER_TIMED = [(1, 2048), (16, 2048), (256, 2048), (512, 2048)]


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


def timed(dev, fn, reps: int = 5) -> float:
    """Median host ms of ``fn`` ending in a device synchronise."""
    from repro_torch.core.device import block

    times = []
    for _ in range(reps):
        block(dev)
        t = time.perf_counter()
        fn()
        block(dev)
        times.append((time.perf_counter() - t) * 1e3)
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


def hmma_counts(kernels: tuple[str, ...]) -> dict | None:
    """Tensor-core instructions (``HMMA``) in each named kernel's SASS in
    the built library, summed over its template instances, from
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    import os
    import shutil

    from repro_torch.kernels import build

    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        / "cuobjdump")
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(build.build())],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump failed: {out.stderr.strip()[-500:]}")
    counts = dict.fromkeys(kernels, 0)
    current = None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            current = next((k for k in kernels if k in line), None)
        elif current and "HMMA" in line:
            counts[current] += 1
    return counts


# -- phase 2 --------------------------------------------------------------


def rel_err(got, want) -> float:
    """Max abs error relative to the largest magnitude of the result."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


PEAKS = {"fp32 on the CUDA cores": FP32_PEAK,
         "3xTF32 on the tensor cores": TF32X3_PEAK}


def bound(name: str, nbytes: float, flops: float,
          units: str = "fp32 on the CUDA cores") -> dict:
    """The least time the card could take: bytes over its memory rate or
    operations over the fp32 rate of the ``units`` the kernel's arithmetic
    runs on, whichever is larger. Logs both times and the peak used."""
    peak = PEAKS[units]
    t_bytes, t_ops = nbytes / MEM_BW, flops / peak
    log(f"{name} bound: bytes {t_bytes * 1e6:.4f} us ({nbytes:.0f} B at "
        f"{MEM_BW / 1e12} TB/s), operations {t_ops * 1e6:.4f} us "
        f"({flops:.0f} FLOP at {peak / 1e12:.0f} TFLOP/s, {units})")
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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

    timed_shapes = {}
    for K, row_bytes in GATHER_TIMED:
        src = torch.randn((max(2048, 2 * K), row_bytes // 4), generator=g,
                          device="cuda")
        idx = torch.randint(0, src.shape[0], (K,), generator=g,
                            device="cuda", dtype=torch.int32)
        idx_long = idx.long()
        t = {f"{how}_{regime}": timer(fn, cold=regime == "cold")
             for regime in ("cold", "warm")
             for how, fn in (("ms", lambda: gather_rows(src, idx)),
                             ("library_ms", lambda: torch.index_select(
                                 src, 0, idx_long)))}
        timed_shapes[f"K={K} row_bytes={row_bytes}"] = t
        log(f"gather_rows K={K} row_bytes={row_bytes} ms: cold kernel "
            f"{t['ms_cold']:.5f}, index_select {t['library_ms_cold']:.5f}; "
            f"warm kernel {t['ms_warm']:.5f}, index_select "
            f"{t['library_ms_warm']:.5f}")

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
            **bound("gather_rows", nbytes, 0), "library_ms": library_ms,
            "timed_shapes": timed_shapes}


def launch_floor(torch, timer) -> dict:
    """The fixed cost of a launch through the kernel library: an empty
    one-warp kernel in the same timer as the kernels, cold and warm."""
    from repro_torch.kernels import build

    lib = build.library()

    def empty():
        build.check(lib.empty_kernel_launch(
            torch.cuda.current_stream().cuda_stream), "empty_kernel")
    floor = {"cold_ms": timer(empty), "warm_ms": timer(empty, cold=False)}
    log(f"launch floor: empty kernel ms cold {floor['cold_ms']:.5f}, warm "
        f"{floor['warm_ms']:.5f}")
    return floor


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
    return {"name": "fused_gather_lstm_cell", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_gather_lstm_cell.cu",
            "replaces": "src/repro/kernels/fused_gather_cell.py:47",
            "shape": f"E=H={E}, B={B}, float32",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **bound("fused_gather_lstm_cell", nbytes, 2 * B * K * 4 * H,
                    "3xTF32 on the tensor cores"),
            "library_ms": None}


def check_fused_dense(torch, timer) -> dict:
    """The dense cell against its plain version (within 1e-4 of the largest
    |output|) at the path's, table5's, the reference tests' and ragged
    shapes, and composed with the row gather against the gather cell. Its
    launches are those of these checks: no model path launches it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_cell import fused_lstm_cell
    from repro_torch.kernels.fused_gather_cell import fused_gather_lstm_cell

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def inputs(B, K, H):
        return (torch.randn((B, K), generator=g, device="cuda"),
                0.05 * torch.randn((K, 4 * H), generator=g, device="cuda"),
                0.1 * torch.randn((4 * H,), generator=g, device="cuda"),
                torch.randn((B, H), generator=g, device="cuda"))

    cases = [  # (label, B, K, H)
        ("path", BATCH, 2 * MODEL_SIZE, MODEL_SIZE),
        *((f"table5 H={H}", 16, 2 * H, H) for H in (64, 128, 256)),
        *((f"reference B={B} K={K} H={H}", B, K, H)
          for B, K, H in ((8, 64, 32), (4, 32, 32), (16, 128, 64))),
        ("B=1", 1, 2 * MODEL_SIZE, MODEL_SIZE),
        ("ragged B=37 K=333 H=100", 37, 333, 100),
        ("ragged B=5 K=7 H=13", 5, 7, 13),
        ("K=1 H=1", 3, 1, 1),
    ]
    fused_lstm_cell.launches = 0
    worst = worst_rel = 0.0
    for label, B, K, H in cases:
        xh, w, b, c = inputs(B, K, H)
        h2, c2 = fused_lstm_cell(xh, w, b, c)
        hr, cr = ref.fused_lstm_cell_ref(xh, w, b, c)
        torch.cuda.synchronize()
        err = max(rel_err(h2, hr), rel_err(c2, cr))
        if not err <= 1e-4:
            fail(f"fused_lstm_cell {label}: relative err {err} > 1e-4")
        worst_rel = max(worst_rel, err)
        worst = max(worst, float((h2 - hr).abs().max()),
                    float((c2 - cr).abs().max()))
        log(f"fused_lstm_cell {label} (B={B}, K={K}, H={H}): relative err "
            f"{err:.3e}")

    # the dense cell on gathered rows is the gather cell
    E = H = MODEL_SIZE
    n = 2048
    x_src, h_src, c_src = (torch.randn((n, E), generator=g, device="cuda")
                           for _ in range(3))
    _, w, b, _ = inputs(1, E + H, H)
    ix, ih, ic = (torch.randint(-n, n, (BATCH,), generator=g, device="cuda",
                                dtype=torch.int32) for _ in range(3))
    xh = torch.cat([x_src[ix.long()], h_src[ih.long()]], dim=1)
    h2, c2 = fused_lstm_cell(xh, w, b, c_src[ic.long()].contiguous())
    h3, c3 = fused_gather_lstm_cell(x_src, h_src, c_src, ix, ih, ic, w, b)
    torch.cuda.synchronize()
    err = max(rel_err(h2, h3), rel_err(c2, c3))
    if not err <= 1e-4:
        fail(f"fused_lstm_cell on gathered rows vs fused_gather_lstm_cell: "
             f"relative err {err} > 1e-4")
    log(f"fused_lstm_cell on gathered rows vs fused_gather_lstm_cell: "
        f"relative err {err:.3e}")
    launches = fused_lstm_cell.launches

    B, K, H = BATCH, 2 * MODEL_SIZE, MODEL_SIZE
    xh, w, b, c = inputs(B, K, H)
    ms = timer(lambda: fused_lstm_cell(xh, w, b, c))
    plain_ms = timer(lambda: ref.fused_lstm_cell_ref(xh, w, b, c))
    # yardstick only, the port never calls it: nn.LSTMCell's own call, with
    # xh split at E = K - H and the bias in b_ih
    E = K - H
    x, h = xh[:, :E].contiguous(), xh[:, E:].contiguous()
    w_ih, w_hh = w[:E].t().contiguous(), w[E:].t().contiguous()
    b_hh = torch.zeros_like(b)
    h4, c4 = torch._VF.lstm_cell(x, (h, c), w_ih, w_hh, b, b_hh)
    hr, cr = ref.fused_lstm_cell_ref(xh, w, b, c)
    err = max(rel_err(h4, hr), rel_err(c4, cr))
    if not err <= 1e-4:
        fail(f"torch._VF.lstm_cell does not compute the cell: {err}")
    library_ms = timer(
        lambda: torch._VF.lstm_cell(x, (h, c), w_ih, w_hh, b, b_hh))
    for Bt in (1, 16, 32):
        xt, _, _, ct = inputs(Bt, K, H)
        log(f"fused_lstm_cell B={Bt} ms: cold "
            f"{timer(lambda: fused_lstm_cell(xt, w, b, ct)):.4f}, warm "
            f"(L2-resident) "
            f"{timer(lambda: fused_lstm_cell(xt, w, b, ct), cold=False):.4f}")
    nbytes = (B * K + K * 4 * H + 4 * H + 3 * B * H) * 4
    return {"name": "fused_lstm_cell", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_lstm_cell.cu",
            "replaces": "src/repro/kernels/fused_cell.py:53",
            "shape": f"B={B}, K={K}, H={H}, float32",
            "launches": launches, "max_abs_err": worst,
            "max_rel_err": worst_rel, "ms": ms, "plain_ms": plain_ms,
            **bound("fused_lstm_cell", nbytes, 2 * B * K * 4 * H,
                    "3xTF32 on the tensor cores"),
            "library_ms": library_ms}


def library_kernels(torch, fn) -> list:
    """Names of the device kernels one call of ``fn`` launches, from one
    profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA})


def check_flash(torch, timer) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cases = [  # (label, B, Sq, Skv, H, KV, D, causal, window)
        ("path S=96 B=2", 2, 96, 96, 14, 2, 64, True, 0),
        ("path S=32 B=1", 1, 32, 32, 14, 2, 64, True, 0),
        ("path S=48 B=4", 4, 48, 48, 14, 2, 64, True, 0),
        ("path S=96 B=4", 4, 96, 96, 14, 2, 64, True, 0),
        ("ragged S=100", 2, 100, 100, 14, 2, 64, True, 0),
        ("window 16, S=130", 1, 130, 130, 4, 2, 64, True, 16),
        ("cross Sq=40 Skv=77", 2, 40, 77, 6, 3, 64, False, 0),
        ("D=128 MHA", 1, 70, 70, 4, 4, 128, True, 0),
        # tile edges: a warp's 16 rows, an 8-column mma tile, a K/V tile
        ("P V relayout D=16 Skv=8", 1, 8, 8, 2, 1, 16, True, 0),
        ("Sq=1 Skv=77 D=16 G=7", 2, 1, 77, 14, 2, 16, True, 0),
        ("Sq=15 Skv=8 D=128 G=7", 2, 15, 8, 14, 2, 128, True, 0),
        ("cross Sq=17 Skv=9 D=32", 2, 17, 9, 2, 2, 32, False, 0),
        ("window 8 Sq=100 Skv=77", 1, 100, 77, 2, 2, 64, True, 8),
        ("window 4 Sq=17 Skv=9, rows with no key", 1, 17, 9, 14, 2, 16,
         True, 4),
    ]
    worst = 0.0
    for label, B, Sq, Skv, H, KV, D, causal, window in cases:
        q = torch.randn((B, Sq, H, D), generator=g, device="cuda")
        k = torch.randn((B, Skv, KV, D), generator=g, device="cuda")
        v = torch.randn((B, Skv, KV, D), generator=g, device="cuda")
        out = flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal, window)
        torch.cuda.synchronize()
        err = rel_err(out, want)
        if not err <= 1e-4:
            fail(f"flash_attention {label}: relative err {err} > 1e-4")
        worst = max(worst, float((out - want).abs().max()))
        log(f"flash_attention {label}: relative err {err:.3e}")

    H, KV, D = 14, 2, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    waves = {}
    for S, B in ((32, 2), (96, 4)):   # the Qwen2 wave's prefill shapes
        q = torch.randn((B, S, H, D), generator=g, device="cuda")
        k = torch.randn((B, S, KV, D), generator=g, device="cuda")
        v = torch.randn((B, S, KV, D), generator=g, device="cuda")
        # yardstick only: the port never calls it
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        waves[f"S={S} B={B}"] = {
            "ms": timer(lambda: flash_attention(q, k, v)),
            "library_ms": timer(lambda: sdpa(qt, kt, vt, is_causal=True)),
            "warm_ms": timer(lambda: flash_attention(q, k, v), cold=False)}
        log(f"flash_attention S={S} B={B} ms: cold kernel "
            f"{waves[f'S={S} B={B}']['ms']:.4f}, scaled_dot_product_attention "
            f"{waves[f'S={S} B={B}']['library_ms']:.4f}, warm kernel "
            f"{waves[f'S={S} B={B}']['warm_ms']:.4f}")
    # q, k, v, qt, kt, vt are the larger wave's from here on
    plain_ms = timer(lambda: ref.flash_attention_ref(q, k, v))
    log(f"scaled_dot_product_attention runs: "
        f"{library_kernels(torch, lambda: sdpa(qt, kt, vt, is_causal=True))}")
    pairs = B * H * S * (S + 1) // 2          # causal (row, column) pairs
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:65",
            "shape": f"q ({B}, {S}, {H}, {D}), k/v ({B}, {S}, {KV}, {D}) "
                     f"float32, causal",
            "max_abs_err": worst, "ms": waves[f"S={S} B={B}"]["ms"],
            "plain_ms": plain_ms,
            **bound("flash_attention",
                    (2 * B * S * H * D + 2 * B * S * KV * D) * 4,
                    4 * D * pairs, "3xTF32 on the tensor cores"),
            "library_ms": waves[f"S={S} B={B}"]["library_ms"],
            "waves": waves}


def ssd_flops(b: int, l: int, h: int, p: int, n: int) -> int:
    """The fewest FLOPs that compute the scan, whose result does not depend
    on the chunk size: the least over every chunk size q (a ragged last
    chunk allowed) of the chunked algorithm's count, and the sequential
    recurrence's. Per (batch, head) and chunk of m steps the chunked count
    is the masked C.B^T scores and the diagonal block over the m(m+1)/2
    causal pairs (2n + 2p each), the carried state's contribution and the
    state update (2np each per step) and the state's decay (np); the
    recurrence's is, per step and (p, n) state entry, a decay multiply and
    a multiply-add for the update and a multiply-add for C . state."""
    def chunk(m: int) -> int:
        return m * (m + 1) * (n + p) + 4 * m * n * p + n * p

    def chunked(q: int) -> int:
        full, rest = divmod(l, q)
        return full * chunk(q) + (chunk(rest) if rest else 0)

    least = min(min(chunked(q) for q in range(1, l + 1)), 5 * l * p * n)
    return b * h * least


def check_ssd(torch, timer) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def inputs(b, l, h, p, grp, n):
        return (torch.randn((b, l, h, p), generator=g, device="cuda"),
                torch.rand((b, l, h), generator=g, device="cuda") * 0.5,
                -torch.rand((h,), generator=g, device="cuda") * 0.5,
                torch.randn((b, l, grp, n), generator=g, device="cuda"),
                torch.randn((b, l, grp, n), generator=g, device="cuda"))

    def packed(b, l, h, p, grp, n):
        """x, B and C as views into one (b, l, 1 + h p + 2 grp n)
        projection at an odd offset: no row of x or B starts on a 16-byte
        boundary, so the kernel stages them 4 bytes at a time."""
        xbc = torch.randn((b, l, 1 + h * p + 2 * grp * n), generator=g,
                          device="cuda")
        o = 1 + h * p
        _, dt, A, _, _ = inputs(b, l, h, 1, 1, 1)
        return (xbc[..., 1:o].view(b, l, h, p), dt, A,
                xbc[..., o:o + grp * n].view(b, l, grp, n),
                xbc[..., o + grp * n:].view(b, l, grp, n))

    cases = [  # (label, b, l, h, p, groups, n, chunk, from a state)
        ("path l=128 B=1", 1, 128, 24, 64, 1, 128, 128, False),
        ("path l=256 B=3", 3, 256, 24, 64, 1, 128, 128, False),
        ("path l=256 B=4", 4, 256, 24, 64, 1, 128, 128, False),
        ("groups 2, chunk 16", 2, 64, 8, 16, 2, 16, 16, False),
        ("ragged p=24 n=40 chunk 32", 1, 96, 4, 24, 1, 40, 32, False),
        # tile edges: one 8-row tile, half a 16-row tile, 5 column tiles
        ("chunk 8 n=16 p=24 groups 2", 2, 24, 4, 24, 2, 16, 8, False),
        ("chunk 24 n=40 p=64", 2, 72, 4, 64, 1, 40, 24, False),
        ("chunk 24 n=128 p=24 groups 2", 1, 48, 4, 24, 2, 128, 24, False),
        ("init state, path l=256 B=3", 3, 256, 24, 64, 1, 128, 128, True),
        ("init state, ragged p=24 n=40 chunk 24", 2, 48, 4, 24, 2, 40, 24,
         True),
        # 4-byte staging: rows of B (n = 33) or x (p = 21, 37) that are not
        # whole 16-byte chunks, and a packed projection at an odd offset
        ("4-byte B n=33 p=20 chunk 24", 2, 48, 4, 20, 1, 33, 24, False),
        ("4-byte x n=32 p=21 chunk 24, init state", 2, 48, 4, 21, 1, 32, 24,
         True),
        ("4-byte B and x n=33 p=37 chunk 24 groups 2", 2, 48, 4, 37, 2, 33,
         24, False),
        ("4-byte B and x n=33 p=37 chunk 24 groups 2, init state", 2, 48, 4,
         37, 2, 33, 24, True),
        ("packed at an odd offset, path l=256 B=2", 2, 256, 24, 64, 1, 128,
         128, False),
        ("packed at an odd offset, path l=256 B=2, init state", 2, 256, 24,
         64, 1, 128, 128, True),
    ]
    worst = 0.0
    for label, b, l, h, p, grp, n, chunk, from_state in cases:
        make = packed if label.startswith("packed") else inputs
        x, dt, A, B, C = make(b, l, h, p, grp, n)
        s0 = (torch.randn((b, h, p, n), generator=g, device="cuda")
              if from_state else None)
        y, final = ssd_scan(x, dt, A, B, C, chunk, s0)
        y_ref, final_ref = ref.ssd_scan_ref(x, dt, A, B, C, chunk, s0)
        torch.cuda.synchronize()
        err = max(rel_err(y, y_ref), rel_err(final, final_ref))
        if not err <= 1e-4:
            fail(f"ssd_scan {label}: relative err {err} > 1e-4")
        worst = max(worst, float((y - y_ref).abs().max()),
                    float((final - final_ref).abs().max()))
        log(f"ssd_scan {label}: relative err (y, final state) {err:.3e}")

    h, p, n, q = 24, 64, 128, 128
    waves = {}
    for l, b in ((128, 3), (256, 3)):   # the Mamba2 wave's prefill shapes
        x, dt, A, B, C = inputs(b, l, h, p, 1, n)
        waves[f"l={l} B={b}"] = {
            "ms": timer(lambda: ssd_scan(x, dt, A, B, C, q)),
            "warm_ms": timer(lambda: ssd_scan(x, dt, A, B, C, q),
                             cold=False)}
        log(f"ssd_scan l={l} B={b} ms: cold {waves[f'l={l} B={b}']['ms']:.4f}"
            f", warm {waves[f'l={l} B={b}']['warm_ms']:.4f}")
    # x, dt, A, B, C are the longer wave's from here on
    plain_ms = timer(lambda: ref.ssd_scan_ref(x, dt, A, B, C, q))
    nbytes = 4 * (2 * b * l * h * p + b * l * h + h + 2 * b * l * n
                  + b * h * p * n)
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:64",
            "shape": f"x ({b}, {l}, {h}, {p}), B/C ({b}, {l}, 1, {n}), "
                     f"chunk {q}, float32",
            "max_abs_err": worst, "ms": waves[f"l={l} B={b}"]["ms"],
            "plain_ms": plain_ms,
            **bound("ssd_scan", nbytes, ssd_flops(b, l, h, p, n),
                    "3xTF32 on the tensor cores"),
            "library_ms": None, "waves": waves}


# -- phase 3 --------------------------------------------------------------


def y_logits(res):
    """Every output logit of a run, on the host in float64 (exact for a
    float32 run), and the number of y nodes."""
    ids = list(res.nodes_with_field("y"))
    return res.field("y", ids).double().cpu(), len(ids)


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
    own = {}
    for kernel, names in OWN_KERNELS.items():
        us = [e.time_range.elapsed_us() for e in events
              if any(n in e.name for n in names)]
        if us:
            own[kernel] = {"launches": len(us), "device_us": sum(us),
                           "share": sum(us) / device_us}
    return {"wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
            "busy_share": device_us / wall_us if events else None,
            "device_events": len(events), "top_events": top,
            "own_kernels": own}


# wrapper -> the names of its device kernels
OWN_KERNELS = {"gather_rows": ("gather_rows_kernel",),
               "fused_gather_lstm_cell": ("fused_gather_lstm_cell_kernel",),
               "fused_lstm_cell": ("fused_lstm_cell_kernel",),
               "flash_attention": ("flash_attention_kernel",),
               "ssd_scan": ("ssd_scan_kernel",)}


EXECUTORS = ("interpreted", "per_topology", "bucketed")


def run_slice(device: str, name: str = "BiLSTM-Tagger",
              model_size: int = MODEL_SIZE, batch: int = BATCH,
              n_fresh: int = N_FRESH, repeat: bool = True,
              executors: tuple[str, ...] = EXECUTORS, timed_reps: int = 5,
              graph_args: dict | None = None, rl_iters: int = 600,
              float64_reference: bool = False) -> dict:
    """The port's batched-execution path, as a user drives it: learn an
    FSM on small graphs of workload ``name``, then run minibatches of
    ``batch`` instances (drawn with ``graph_args``, the workload's own
    defaults if None; ``n_fresh`` topologies, then a repeat of the first)
    through ``executors`` and check that they agree. The first minibatch
    must also match the interpreted run of the same seed's workload on the
    CPU, where every kernel is its plain version.

    ``float64_reference`` is for a workload whose float32 result is not
    resolved to 1e-4 (MV-RNN at width 512). Its card and CPU runs are then
    held to each other in float64 (within 1e-9), and the card's float32
    run to the float64 result at least half as closely as the CPU's own
    float32 run, in place of the float32 card-vs-CPU bar."""
    import torch
    from repro_torch.core.batching import resolve_schedule
    from repro_torch.core.executor import DynamicExecutor, ExecStats
    from repro_torch.core.plan import BucketedPlanExecutor, PlanExecutor
    from repro_torch.core.rl import RLConfig, train_fsm
    from repro_torch.models.workloads import make_workload

    dev = torch.device(device)
    graph_args = graph_args or {}
    rng = random.Random(SEED)
    t0 = time.perf_counter()
    wl = make_workload(name, model_size, SEED, device=device)
    report = {"workload": name, "init_s": time.perf_counter() - t0}
    n_classes = wl.impls["O"].out_fields["y"][0]
    t0 = time.perf_counter()
    fsm = train_fsm([wl.sample_graph(rng, 2) for _ in range(3)],
                    RLConfig(max_iters=rl_iters, seed=SEED))
    report.update(rl_s=time.perf_counter() - t0, rl_iters=fsm.iters)
    policy = fsm.policy
    make = {
        "interpreted": lambda: DynamicExecutor(wl.impls, None, device=device),
        "per_topology": lambda: PlanExecutor(wl.impls, None, donate=True,
                                             device=device),
        "bucketed": lambda: BucketedPlanExecutor(wl.impls, None,
                                                 device=device),
    }
    execs = {k: make[k]() for k in executors}
    stats = {k: ExecStats() for k in executors}
    graphs = [wl.sample_graph(rng, batch, **graph_args)
              for _ in range(n_fresh)]
    if repeat:
        graphs.append(graphs[0])                 # one repeat topology
    worst = 0.0
    for gi, g in enumerate(graphs):
        ys = {}
        for ename, ex in execs.items():
            y, n_y = y_logits(ex.run(g, policy, stats[ename]))
            if tuple(y.shape) != (n_y, n_classes) or \
                    not torch.isfinite(y).all():
                fail(f"{name} {ename} on minibatch {gi}: bad y "
                     f"{tuple(y.shape)}")
            ys[ename] = y
        for ename in executors[1:]:
            err = float((ys[ename] - ys[executors[0]]).abs().max())
            worst = max(worst, err)
            if not err <= 1e-4:
                fail(f"{name} {ename} vs {executors[0]} on minibatch {gi}: "
                     f"max abs err {err} > 1e-4")
        if gi == 0:
            cpu_wl = make_workload(name, model_size, SEED, device="cpu")
            y_ref, _ = y_logits(DynamicExecutor(
                cpu_wl.impls, None, device="cpu").run(g, policy))
            errs = {k: float((y - y_ref).abs().max()) for k, y in ys.items()}
            report.update(max_abs_err_vs_cpu=errs[executors[0]],
                          max_abs_err_any_vs_cpu=max(errs.values()))
            if not float64_reference and not max(errs.values()) <= 1e-4:
                fail(f"{name} on {device} vs the CPU plain run: max abs err "
                     f"{errs}")
            y_first, y_cpu = ys, y_ref
        log(f"{name} minibatch {gi}: {len(g)} nodes, executors agree "
            f"(max abs err {worst:.3e})")
    report["max_abs_err_executors"] = worst
    report["lower_s"] = {k: st.lower_time for k, st in stats.items()}

    g = graphs[0]
    report["ms_per_run"] = {ename: timed(dev, lambda: ex.run(g, policy),
                                         timed_reps)
                            for ename, ex in execs.items()}
    if dev.type == "cuda":
        report["profile"] = {
            ename: profile_run(torch, lambda: ex.run(g, policy))
            for ename, ex in execs.items()}
    report["graph_nodes"] = len(g)
    report["n_batches"] = len(resolve_schedule(g, policy))
    report["batch_lower_bound"] = g.batch_lower_bound()
    if "per_topology" in execs:
        plan = execs["per_topology"].plan_for(g, policy)
        report["plan_stats"] = plan.stats.as_dict()
    if "bucketed" in execs:
        report["bucketed_stats"] = (execs["bucketed"].pack_for(g, policy)
                                    .stats.as_dict())
        report["bucket_compiles"] = execs["bucketed"].n_bucket_compiles
    if float64_reference:
        report["float64"] = check_float64(wl, cpu_wl, g, policy, execs,
                                          y_first, y_cpu)
    return report


def to_float64(wl) -> None:
    """Cast a tree workload's parameters to float64 in place, for a
    reference run: its floats all live in ``impl.params``, and its cells
    (``wl.cells``) then keep their state in float64."""
    import torch

    for impl in wl.impls.values():
        for k, t in impl.params.items():
            impl.params[k] = t.double()
    for cell in wl.cells.values():
        cell.dtype = torch.float64


def check_float64(wl, cpu_wl, g, policy, execs, ys, y_cpu) -> dict:
    """The first minibatch again in float64, on the card through every
    executor and on the CPU: the card must match the CPU within 1e-9, and
    the card's float32 logits ``ys`` must be no farther from the float64
    result than twice the CPU's float32 logits ``y_cpu`` are."""
    import torch
    from repro_torch.core.executor import DynamicExecutor

    to_float64(wl)
    to_float64(cpu_wl)
    y64, _ = y_logits(DynamicExecutor(cpu_wl.impls, None,
                                      device="cpu").run(g, policy))
    out = {"cpu32_vs_64": float((y_cpu - y64).abs().max())}
    for ename, ex in execs.items():
        res = ex.run(g, policy)
        arenas = res.bufs if hasattr(res, "bufs") else res.arenas
        if any(t.dtype != torch.float64 for t in arenas.values()):
            fail(f"{wl.name} {ename}: the float64 run kept a float32 buffer")
        y, _ = y_logits(res)
        out[f"{ename}64_vs_cpu64"] = float((y - y64).abs().max())
        out[f"{ename}32_vs_64"] = float((ys[ename] - y64).abs().max())
        if not out[f"{ename}64_vs_cpu64"] <= 1e-9:
            fail(f"{wl.name} {ename} in float64 vs the CPU: {out}")
        if not out[f"{ename}32_vs_64"] <= 2 * out["cpu32_vs_64"]:
            fail(f"{wl.name} {ename}: float32 on the card is farther from "
                 f"float64 than twice the CPU's float32: {out}")
    log(f"{wl.name} float64 reference: {out}")
    return out


# -- phase 4 --------------------------------------------------------------


# Full published width and depth; random weights from the seed.
LM_RUNS = {  # name: (prompt lengths to draw from, requests, max_new, cache)
    "qwen2-0.5b": ((32, 48, 96), 6, 8, 256),
    "mamba2-130m": ((128, 256), 6, 8, 256),
}
LOGIT_TOL = 2e-3    # prefill vs forward bar of the reference's own tests


def top2_margin(torch, model, params, prompt, prefix) -> tuple:
    """(top-1 minus top-2 logit, largest |logit|) of the step that follows
    ``prompt + prefix``, from a full forward pass."""
    toks = torch.tensor([list(prompt) + list(prefix)], device=model.device)
    with torch.no_grad():
        logits = model.forward(params, toks)[0][0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1]), float(logits.abs().max())


def lm_wave(name: str, wrappers: dict) -> dict:
    """One LM at full width through the port's wave server on the card:
    one counted wave (the kernels' launch counts are read around it), a
    timed repeat and a profiled one; then the same first wave on the CPU,
    where every kernel is its plain version, with the same weights. Tokens
    must match (a differing token is accepted only at a near-tie, top-2
    margin within the logit tolerance), and one prefill batch's logits
    must agree within 2e-3 of the largest |logit|."""
    import numpy as np
    import torch
    from repro_torch.arch.model import TransformerLM, tree_map
    from repro_torch.configs import get_config
    from repro_torch.core.device import block
    from repro_torch.serve.lm_wave import ServeEngine, ServeStats

    lengths, n_req, max_new, cache_len = LM_RUNS[name]
    cfg = get_config(name)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cpu_model = TransformerLM(cfg, device="cpu")
    cpu_params = cpu_model.init_params(torch.Generator().manual_seed(SEED))
    model = TransformerLM(cfg, device=dev)
    params = tree_map(lambda t: t.to(dev), cpu_params)
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    report = {"model": name, "n_layers": cfg.n_layers,
              "d_model": cfg.d_model, "n_params": sum(sizes),
              "init_s": time.perf_counter() - t0}
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, int(rng.choice(lengths))).tolist()
               for _ in range(n_req)]
    report["prompt_lengths"] = [len(p) for p in prompts]

    eng = ServeEngine(model, params, cache_len=cache_len, device=dev)
    for fn in wrappers.values():
        fn.launches = 0
    stats = ServeStats()
    outs, _ = eng.generate(prompts, max_new=max_new, stats=stats)
    block(dev)
    report["launches"] = {k: fn.launches for k, fn in wrappers.items()}
    report["first_wave_s"] = stats.wall_s
    if any(len(o) != max_new for o in outs):
        fail(f"{name}: a request did not get {max_new} tokens")

    warm = ServeStats()
    outs_again, _ = eng.generate(prompts, max_new=max_new, stats=warm)
    if outs_again != outs:
        fail(f"{name}: a repeat of the wave gave other tokens")
    report.update(tok_per_s=warm.tok_per_s, wave_ms=warm.wall_s * 1e3,
                  n_batches=warm.n_batches,
                  n_prefill_batches=warm.n_prefill_batches,
                  n_decode_batches=warm.n_decode_batches,
                  sched_cache_hits=warm.sched_cache_hits)

    # ms per prefill batch (each length bucket) and per decode wave
    by_len: dict[int, list] = {}
    for p in prompts:
        by_len.setdefault(len(p), []).append(p)
    with torch.no_grad():
        prefill_ms = {}
        for L_, group in sorted(by_len.items()):
            toks = torch.tensor(group, device=dev)
            prefill_ms[f"L={L_} B={len(group)}"] = timed(
                dev, lambda: model.prefill(params, toks, cache_len))
        caches = model.init_cache(n_req, cache_len)
        tok = torch.zeros(n_req, dtype=torch.int64, device=dev)
        pos = torch.full((n_req,), 100, dtype=torch.int64, device=dev)
        decode_ms = timed(dev, lambda: model.decode_step(params, tok, caches,
                                                         pos))
    report.update(prefill_ms=prefill_ms, decode_wave_ms=decode_ms)
    report["profile"] = profile_run(
        torch, lambda: eng.generate(prompts, max_new=max_new))

    # the same first wave on the CPU, plain versions only
    t0 = time.perf_counter()
    cpu_outs, cpu_stats = ServeEngine(cpu_model, cpu_params,
                                      cache_len=cache_len, device="cpu"
                                      ).generate(prompts, max_new=max_new)
    report["cpu_wave_s"] = time.perf_counter() - t0
    if (cpu_stats.n_prefill_batches, cpu_stats.n_decode_batches) != \
            (stats.n_prefill_batches, stats.n_decode_batches):
        fail(f"{name}: batch counts differ from the CPU run")
    flips = []
    for r, (got, want) in enumerate(zip(outs, cpu_outs)):
        if got == want:
            continue
        t = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        margin, scale = top2_margin(torch, cpu_model, cpu_params, prompts[r],
                                    want[:t])
        log(f"{name} request {r}: token {t} is {got[t]} on the card, "
            f"{want[t]} on the CPU; CPU top-2 margin {margin:.3e} "
            f"(tolerance {LOGIT_TOL * scale:.3e})")
        if margin > LOGIT_TOL * scale:
            fail(f"{name}: request {r} differs from the CPU run at token {t} "
                 f"beyond a near-tie")
        flips.append([r, t, margin])
    report["near_tie_flips"] = flips

    group = by_len[len(prompts[0])]
    with torch.no_grad():
        lg = model.prefill(params, torch.tensor(group, device=dev),
                           cache_len)[0].cpu()
        lg_cpu = cpu_model.prefill(cpu_params, torch.tensor(group),
                                   cache_len)[0]
    if tuple(lg.shape) != (len(group), cfg.vocab) or \
            not torch.isfinite(lg).all():
        fail(f"{name}: bad prefill logits {tuple(lg.shape)}")
    err = rel_err(lg, lg_cpu)
    report["prefill_logits_rel_err_vs_cpu"] = err
    if not err <= LOGIT_TOL:
        fail(f"{name}: prefill logits differ from the CPU run by {err} of "
             f"the largest |logit|")
    report["tokens_equal_cpu"] = not flips
    return report


# -- phase 5 --------------------------------------------------------------


# Workload: RL iterations (the reference's own tests: 600 for trees, 800 for
# lattices) and the run. The serve families' defaults take the tagger's
# full run; the other four one minibatch through two executors. Graphs are
# the workloads' own: 6-18 leaves per tree, 10-26 characters per lattice.
# MV-RNN's float32 logits are not resolved to 1e-4 at width 512: each node
# multiplies two 512 x 512 matrices into its children's, up to 17 levels
# deep, and the CPU's own float32 run differs from float64 by about 2e-4;
# so it is held to a float64 reference (see ``run_slice``).
FULL = dict(n_fresh=2, repeat=True, executors=EXECUTORS, timed_reps=3)
SHORT = dict(n_fresh=1, repeat=False, executors=("interpreted", "bucketed"),
             timed_reps=3)
TREES_LATTICES = {
    "TreeLSTM": (600, FULL), "LatticeLSTM": (800, FULL),
    "TreeGRU": (600, SHORT), "MV-RNN": (600, dict(SHORT,
                                                  float64_reference=True)),
    "TreeLSTM-2Type": (600, SHORT), "LatticeGRU": (800, SHORT),
}


def shape_histogram(shapes) -> list:
    """A gather's ``(K, row bytes)`` launch counts, most frequent first."""
    return [[k, row_bytes, n] for (k, row_bytes), n in
            sorted(shapes.items(), key=lambda t: (-t[1], t[0]))]


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5",
                    help="phases to run after phase 1 (comma-separated); "
                         "the result lines are printed only for all five")
    ap.add_argument("--workloads", default=",".join(TREES_LATTICES),
                    help="phase 5's workloads (comma-separated)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")} | {1}
    workloads = args.workloads.split(",")
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
    hmma = hmma_counts(("flash_attention_kernel", "ssd_scan_kernel",
                        "fused_gather_lstm_cell_kernel",
                        "fused_lstm_cell_kernel"))
    if hmma is None:
        log("HMMA instructions: not counted (no cuobjdump in the toolkit)")
    else:
        log(f"HMMA instructions in the SASS: {hmma}")
        if not all(hmma.values()):
            fail(f"a tensor-core kernel has no HMMA instruction: {hmma}")
    rows = []
    if 2 in phases:
        launch_floor(torch, timer)
        rows = [check_gather(torch, timer), check_fused(torch, timer),
                check_fused_dense(torch, timer), check_flash(torch, timer),
                check_ssd(torch, timer)]
        log(f"kernel checks done: {time.perf_counter() - t_start:.1f} s")

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_cell import fused_lstm_cell
    from repro_torch.kernels.fused_gather_cell import fused_gather_lstm_cell
    from repro_torch.kernels.gather_batch import gather_rows
    from repro_torch.kernels.ssd_scan import ssd_scan

    wrappers = {"gather_rows": gather_rows,
                "fused_gather_lstm_cell": fused_gather_lstm_cell,
                "fused_lstm_cell": fused_lstm_cell,
                "flash_attention": flash_attention, "ssd_scan": ssd_scan}

    def drive(fn):
        """Run ``fn`` with every launch count (and the gather's shape
        counts) set to 0 just before it; returns its result and the counts
        read just after."""
        for w in wrappers.values():
            w.launches = 0
        gather_rows.shapes.clear()
        out = fn()
        return out, {name: w.launches for name, w in wrappers.items()}

    launches = {"fused_lstm_cell": rows[2]["launches"]} if rows else {}
    if 3 in phases:
        report, slice_counts = drive(lambda: run_slice("cuda"))
        for name in ("gather_rows", "fused_gather_lstm_cell"):
            if slice_counts[name] <= 0:
                fail(f"{name} was not launched during the slice")
            launches[name] = slice_counts[name]
        log(f"slice: {json.dumps(report, default=str)}")
        log(f"slice ms per run: {report['ms_per_run']} ({card})")
        log(f"gather shapes BiLSTM-Tagger [K, row bytes, launches]: "
            f"{shape_histogram(gather_rows.shapes)}")
        prof = report["profile"]["bucketed"]
        log(f"tagger bucketed run device time: {prof['device_ms'] * 1e3:.2f} "
            f"us of {prof['wall_ms'] * 1e3:.1f} us wall; "
            + "; ".join(f"{k} {v['launches']} launches {v['device_us']:.2f} "
                        f"us, share {v['share']:.3f}"
                        for k, v in prof["own_kernels"].items())
            + f" ({card})")
        log(f"slice done: {time.perf_counter() - t_start:.1f} s")

    for name, kernel in (("qwen2-0.5b", "flash_attention"),
                         ("mamba2-130m", "ssd_scan")):
        if 4 not in phases:
            break
        lm = lm_wave(name, wrappers)
        if lm["launches"][kernel] <= 0:
            fail(f"{kernel} was not launched during the {name} wave")
        launches[kernel] = lm["launches"][kernel]
        log(f"lm wave {name}: {json.dumps(lm, default=str)}")
        log(f"lm wave {name}: {lm['tok_per_s']:.1f} tok/s, "
            f"{lm['wave_ms']:.1f} ms per wave of {lm['n_batches']} batches "
            f"({lm['n_prefill_batches']} prefill, {lm['n_decode_batches']} "
            f"decode), prefill ms {lm['prefill_ms']}, decode wave ms "
            f"{lm['decode_wave_ms']:.2f}, tokens equal the CPU run: "
            f"{lm['tokens_equal_cpu']} ({card})")
    log(f"lm waves done: {time.perf_counter() - t_start:.1f} s")

    for name, (rl_iters, run) in TREES_LATTICES.items():
        if 5 not in phases or name not in workloads:
            continue
        t0 = time.perf_counter()
        tl, counts = drive(lambda: run_slice("cuda", name, rl_iters=rl_iters,
                                             **run))
        tl["launches"] = counts
        needed = ["gather_rows"] + (["fused_gather_lstm_cell"]
                                    if name == "LatticeLSTM" else [])
        for kernel in needed:
            if counts[kernel] <= 0:
                fail(f"{kernel} was not launched during {name}")
        busy = tl["profile"]["bucketed"]["busy_share"]
        log(f"gather shapes {name} [K, row bytes, launches]: "
            f"{shape_histogram(gather_rows.shapes)}")
        log(f"workload {name}: {json.dumps(tl, default=str)}")
        log(f"workload {name}: {tl['graph_nodes']} nodes, "
            f"{tl['n_batches']} batches (lower bound "
            f"{tl['batch_lower_bound']}), ms per run {tl['ms_per_run']}, "
            f"lowering s {tl['lower_s']}, bucketed busy share {busy:.3f}, "
            f"launches {counts}, {time.perf_counter() - t0:.1f} s ({card})")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    if phases != {1, 2, 3, 4, 5} or set(workloads) != set(TREES_LATTICES):
        log(f"partial run (phases {sorted(phases)}, workloads {workloads}): "
            f"no result lines")
        return 0
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
