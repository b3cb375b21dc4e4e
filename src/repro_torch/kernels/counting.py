"""Where a kernel wrapper counts a launch.

Each wrapper keeps ``launches`` (and the gather its ``(K, row bytes)``
``shapes``): the process-wide count of its kernel's launches that ran.
Work on the card may come from more than one thread (the serve engine's
background capture workers), so every update takes :data:`LOCK`. A thread
that captures a CUDA graph queues nothing that runs: inside
:func:`captured` its launches go to a tally of its own, which the capture
keeps as the counts each replay adds, and the process-wide counts do not
move.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter

LOCK = threading.Lock()
_local = threading.local()


def count(fn, shape=None) -> None:
    """One launch of ``fn``'s kernel (``shape`` for the gather's
    ``shapes``): added to ``fn``'s counts, or to the calling thread's
    capture tally inside :func:`captured`."""
    tally = getattr(_local, "tally", None)
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
def captured():
    """Route the calling thread's launch counts to a tally for the block:
    yields a ``Counter`` of launches by wrapper name, with the gather's
    shape counts under ``"gather_shapes"``."""
    outer = getattr(_local, "tally", None)
    tally = Counter()
    tally["gather_shapes"] = Counter()
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = outer
