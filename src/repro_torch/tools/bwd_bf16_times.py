"""Cold times of the two bf16 backward kernels on the card, for comparing
two trees in one call.

    python src/repro_torch/tools/bwd_bf16_times.py [--src DIR] [--label L]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
so the same script times another tree's kernels (say, a parent commit
unpacked by ``git archive``), builds its kernels and prints one JSON line:
the median of 30 cold launches (:func:`cold_ms`) of
``flash_attention_backward`` at the bf16 trainer's shape (q/o/dO (8, 128,
14, 64), k/v (8, 128, 2, 64), causal) and at the vision model's cross
shape (q/o/dO (8, 128, 32, 128), k/v (8, 1024, 8, 128), non-causal), and
of ``ssd_scan_backward`` at the trainer's shape (x/dy (8, 128, 24, 64),
B/C (8, 128, 1, 128), one chunk of 128), all bfloat16 on inputs made from
a fixed seed. Needs a card; imports nothing of JAX. Run the trees in turns
(parent, change, change, parent) to read a difference past the card's
spread.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def cold_ms(torch, fn, n: int = 30) -> float:
    """Median ms of ``n`` launches of ``fn``, each with the L2 cache
    flushed first (128 MB written, then 128 MB read that is never written)
    and a spin kernel holding the stream while the host enqueues the call,
    so that the events bracket device time (``chip_smoke.ColdTimer``'s
    method)."""
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    clean = torch.zeros(32 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        clean.sum()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[n // 2]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the tree's src directory")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("bwd_bf16_times: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)
    from repro_torch.kernels.ssd_scan import ssd_scan_backward

    g = torch.Generator(device="cuda").manual_seed(29)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    out = {"label": args.label, "src": args.src,
           "device": torch.cuda.get_device_name(0)}
    for name, (B, Sq, Skv, H, KV, D, causal) in (
            ("attention_trainer", (8, 128, 128, 14, 2, 64, True)),
            ("attention_cross", (8, 128, 1024, 32, 8, 128, False))):
        q, k, v = randn(B, Sq, H, D), randn(B, Skv, KV, D), randn(B, Skv, KV, D)
        dout = randn(B, Sq, H, D)
        o, lse = flash_attention_forward(q, k, v, causal, 0, with_lse=True)
        out[name] = cold_ms(torch, lambda: flash_attention_backward(
            q, k, v, o, dout, lse, causal, 0))
    b, l, h, p, n = 8, 128, 24, 64, 128
    x, B, C, dy = randn(b, l, h, p), randn(b, l, 1, n), randn(b, l, 1, n), \
        randn(b, l, h, p)
    dt = (torch.rand((b, l, h), generator=g, device="cuda") * 0.5).bfloat16()
    A = -torch.rand((h,), generator=g, device="cuda") * 0.5
    out["scan_trainer"] = cold_ms(torch, lambda: ssd_scan_backward(
        x, dt, A, B, C, 128, None, dy))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
