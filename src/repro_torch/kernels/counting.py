"""Where a kernel wrapper counts a launch.

Each wrapper keeps ``launches`` (and the gather its ``(K, row bytes)``
``shapes``): the process-wide count of its kernel's launches that ran.
Work on the card may come from more than one thread (the serve engine's
background capture workers), so every update takes :data:`LOCK`. A thread
that captures a CUDA graph queues nothing that runs: inside
:func:`captured` its launches go to a tally of its own, which the capture
keeps as the counts each replay adds, and the process-wide counts do not
move. A backward captured with its forward runs on autograd's own thread
for the card, on the capturing stream: launches queued on that stream go
to the same tally.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter

import torch

LOCK = threading.Lock()
_local = threading.local()
_streams: dict[int, Counter] = {}   # capturing stream handle -> its tally


def count(fn, shape=None) -> None:
    """One launch of ``fn``'s kernel (``shape`` for the gather's
    ``shapes``): added to ``fn``'s counts, or to the capture tally of the
    calling thread or of the current stream inside :func:`captured`."""
    tally = getattr(_local, "tally", None)
    if tally is None and _streams:
        tally = _streams.get(torch.cuda.current_stream().cuda_stream)
    if tally is not None:
        tally[fn.__name__] += 1
        if shape is not None:
            tally["gather_shapes"][shape] += 1
        return
    with LOCK:
        fn.launches += 1
        if shape is not None:
            fn.shapes[shape] += 1


@contextlib.contextmanager
def captured(stream=None):
    """Route the calling thread's launch counts to a tally for the block,
    and any thread's launches on ``stream`` (a ``torch.cuda.Stream``) with
    them: yields a ``Counter`` of launches by wrapper name, with the
    gather's shape counts under ``"gather_shapes"``."""
    outer = getattr(_local, "tally", None)
    tally = Counter()
    tally["gather_shapes"] = Counter()
    _local.tally = tally
    if stream is not None:
        with LOCK:
            _streams[stream.cuda_stream] = tally
    try:
        yield tally
    finally:
        _local.tally = outer
        if stream is not None:
            with LOCK:
                del _streams[stream.cuda_stream]
