"""The kernel wrappers' launch counters, read and added to together.

Each wrapper adds one to its ``launches`` (and the gather to its ``(K, row
bytes)`` ``shapes``) where it launches its kernel (:mod:`.counting`). A
captured CUDA graph launches the same kernels on every replay without
passing through the wrappers, so the thread that captures one takes the
counts of its capture (:func:`captured`), which move no count, and the
executor that replays it adds them on each replay (:func:`add`).
"""

from __future__ import annotations

import contextlib
from collections import Counter

from . import counting
from .flash_attention import flash_attention
from .fused_cell import fused_lstm_cell
from .fused_gather_cell import fused_gather_lstm_cell
from .gather_batch import gather_rows
from .ssd_scan import ssd_scan

WRAPPERS = {"gather_rows": gather_rows,
            "fused_gather_lstm_cell": fused_gather_lstm_cell,
            "fused_lstm_cell": fused_lstm_cell,
            "flash_attention": flash_attention, "ssd_scan": ssd_scan}


def snapshot() -> dict:
    """Every wrapper's count, and the gather's shape counts."""
    with counting.LOCK:
        counts = {name: fn.launches for name, fn in WRAPPERS.items()}
        counts["gather_shapes"] = Counter(gather_rows.shapes)
    return counts


def delta(before: dict, after: dict) -> dict:
    """What ran between two snapshots."""
    out = {name: after[name] - before[name] for name in WRAPPERS}
    out["gather_shapes"] = after["gather_shapes"] - before["gather_shapes"]
    return out


def restore(counts: dict) -> None:
    """Set every count back to a snapshot."""
    with counting.LOCK:
        for name, fn in WRAPPERS.items():
            fn.launches = counts[name]
        gather_rows.shapes.clear()
        gather_rows.shapes.update(counts["gather_shapes"])


def add(counts: dict) -> None:
    """Add a :func:`delta` to every count."""
    with counting.LOCK:
        for name, fn in WRAPPERS.items():
            fn.launches += counts[name]
        gather_rows.shapes.update(counts["gather_shapes"])


@contextlib.contextmanager
def captured():
    """The launches the calling thread queues inside the block, counted
    apart: no count moves, and the yielded dict holds them, in the form of
    a :func:`delta`, once the block ends."""
    out: dict = {}
    with counting.captured() as tally:
        try:
            yield out
        finally:
            out.update({name: tally[name] for name in WRAPPERS})
            out["gather_shapes"] = Counter(tally["gather_shapes"])
