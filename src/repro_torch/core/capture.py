"""One program captured into a CUDA graph over static buffers, and
replayed: the rules every captured program of the port keeps.

The reference jits a program and dispatches it once a run. The port's
counterpart is a CUDA graph: captured once over buffers whose addresses
stay fixed, and replayed after each run has refilled its inputs. Four
programs are captured so: a bucket signature (``core/plan.py:_Bucket``,
``_ShardedBucket``), a per-topology plan (``core/plan.py:CompiledPlan``),
the LM wave's prefill and decode steps (``serve/lm_wave.py``) and the
train step (``train/loop.py``). Each keeps :class:`CapturedGraph`'s rules:

- **Static buffers.** A graph reads fixed addresses: its static input
  buffers, whatever its capture allocated (its outputs, ``out``), the
  tensors the caller threads in, and copies derived from weights before
  the capture (the fused cells' blocked and packed ``w``). The entry pins
  all of them (``pinned``), and records each buffer a derived copy came
  from with its version (``sources``): once one has changed in place the
  entry is stale (:meth:`CapturedGraph.current`) and must be built again.
- **A warm-up first.** The program runs once eagerly on a side stream, so
  that what is built once (the blocked and packed cell weights, cuBLAS's
  workspace for that stream, the kernels' attributes) is built there and
  not captured into every replay. The caller decides what the warm-up is:
  a throwaway run, or the first real run (the LM decode step and the train
  step, whose bodies update state in place).
- **One capture at a time.** Every capture in the process holds
  :func:`build_lock`: two threads never capture at once, and a serve
  worker that finds an entry built by another while it waited takes that
  one.
- **No graph freed during a capture.** Destroying a graph while a stream
  captures invalidates the capture, and Python's cyclic collector frees a
  graph held in a reference cycle whenever it runs, so the collector is
  off while a capture runs.
- **Room for a large graph's pool.** A capture allocates from a private
  pool of its own and cannot give cached memory back to the card
  meanwhile (``cudaFree`` synchronises). The programs that allocate
  gigabytes (the train step, the LM wave's steps) ask for ``reclaim``:
  unreachable objects are collected and the memory cached by the warm-up
  and by graphs freed earlier goes back to the card before the capture.
  The small ones (buckets, per-topology plans) skip it: it synchronises
  the card and makes the next allocations ``cudaMalloc`` again.
- **Capture without leaks.** ``capture_begin(capture_error_mode=
  "thread_local")`` and ``capture_end`` in the helper's own stream
  context, never ``torch.cuda.graph``, whose exit raises before it
  restores the current stream when the capture is invalidated. Only the
  calling thread is held to the capture's rules: another may replay, copy
  to the host or allocate meanwhile. A failed capture hands the card's
  random generator a state that is not in capture mode
  (:func:`release_generator`) and raises.
- **Launch counts.** The launches queued during the capture (by the
  calling thread, and by autograd's thread for a backward captured with
  its forward) ran nowhere: they go to a tally of their own, which each
  replay adds to the wrappers' counts (``kernels/launches.py``).
- **Streams.** The first replay on a stream marks what the graph reads as
  used there, so that memory freed with the entry (on another thread, say)
  is not handed out while a replay may still read it.
- **The entry's own card.** The warm-up, the capture and each replay run
  with the entry's card current (the current device is per thread, so a
  compile worker sets it too): the side stream, the capture's memory pool
  and the kernels' launches are that card's, and a failed capture hands
  back that card's random generator.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Any, Callable

import torch

from ..kernels import launches
from .device import on_card
from .executor import derived_copies


def tensors_of(x: Any) -> list[torch.Tensor]:
    """Every tensor in a nest of dicts, lists and tuples (dict keys in
    sorted order): what a graph captured over ``x`` reads, whose data
    pointers key it."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x, key=repr) for t in tensors_of(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors_of(v)]
    return []


# One build at a time in the process: two capture workers never capture at
# once, and a worker that finds the entry built by another while it waited
# takes that one. Lowering and packing run outside it, in parallel.
_BUILD_LOCK = threading.Lock()


@contextlib.contextmanager
def build_lock(abort_check: Callable[[], bool] | None = None):
    """Hold the process-wide build lock; a job abandoned while it waits (or
    once it has the lock) raises before it builds, so nothing is cached."""
    while not _BUILD_LOCK.acquire(timeout=0.05):
        if abort_check is not None and abort_check():
            raise RuntimeError("build aborted (job abandoned while waiting "
                               "for the build lock)")
    try:
        if abort_check is not None and abort_check():
            raise RuntimeError("build aborted (job abandoned before the "
                               "build)")
        yield
    finally:
        _BUILD_LOCK.release()


def release_generator(dev: torch.device) -> None:
    """A capture that fails inside its body ends without taking the card's
    default random generator out of capture mode, and the generator's next
    draw outside a capture raises. Give it a copy of its state, which is
    not in capture mode (no captured program draws random numbers)."""
    gen = torch.cuda.default_generators[
        dev.index if dev.index is not None else torch.cuda.current_device()]
    gen.graphsafe_set_state(gen.clone_state())


class CapturedGraph:
    """A program captured once over static buffers, then replayed.

    ``statics`` are the static input buffers each run refills and each
    replay reads; ``pinned`` the other tensors the graph reads in place
    (the caller adds the threaded tensors and weights, the capture adds
    the derived copies). ``graph`` is None until :meth:`capture_graph`
    (and for good where the caller does not capture: on the CPU, or with
    ``capture=False``), and the caller then runs its body eagerly over the
    same buffers."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: Any = None
        self.counts: dict | None = None   # launch counts of one replay
        self.statics: list[torch.Tensor] = []
        self.pinned: list[torch.Tensor] = []
        self.sources: list[tuple[torch.Tensor, int]] = []
        self.streams: set[int] = set()   # streams it was replayed on

    def current(self) -> bool:
        """False once a buffer that a copy read by the graph was derived
        from has been updated in place since the capture."""
        return all(t._version == v for t, v in self.sources)

    def capture_graph(self, warm: Callable[[], Any],
                      body: Callable[[Any], Any],
                      reclaim: bool = False) -> Any:
        """Run ``warm()`` eagerly on a side stream, then capture
        ``body(warm's result)`` on it into ``graph``, its result into
        ``out``; returns the warm-up's result, whose tensors are marked as
        used on the calling stream. The side stream has finished all of it
        when the method returns. ``reclaim``: collect garbage and empty
        the card's cache between the two. Raises (with the generator
        released) if the capture fails. The caller holds
        :func:`build_lock`."""
        with on_card(self.device):
            return self._capture_graph(warm, body, reclaim)

    def _capture_graph(self, warm, body, reclaim):
        dev = self.device
        caller = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(caller)
        with derived_copies() as found:
            with torch.cuda.stream(side):
                warmed = warm()
            side.synchronize()
            if reclaim:
                gc.collect()
                torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with launches.captured(side) as counts, \
                        torch.cuda.stream(side):
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        out = body(warmed)
                    finally:
                        graph.capture_end()
            except BaseException:
                release_generator(dev)
                raise
            finally:
                if collecting:
                    gc.enable()
        for t in tensors_of(warmed):
            t.record_stream(caller)
        # one entry a buffer: every step of both passes reports its copies
        for src, version, copies in {id(f[0]): f for f in found}.values():
            self.pinned.extend(copies)
            self.sources.append((src, version))
        self.counts = counts
        self.graph, self.out = graph, out
        return warmed

    def run_captured(self, body: Callable[[], Any],
                     reclaim: bool = False) -> Any:
        """One run of a program that updates its state in place: the first
        is ``body()`` as the warm-up of its capture (under the build lock,
        with ``reclaim`` as :meth:`capture_graph` takes it), whose result
        it returns; every later one is a replay, returning the graph's
        outputs (overwritten by the next replay)."""
        if self.graph is None:
            with build_lock():
                return self.capture_graph(body, lambda _: body(), reclaim)
        self.replay()
        return self.out

    def replay(self) -> None:
        """Replay the graph on the current stream and add its launch
        counts; the first replay on a stream marks what the graph reads as
        used there."""
        stream = torch.cuda.current_stream(self.device)
        if stream.cuda_stream not in self.streams:
            for t in self.pinned + self.statics:
                t.record_stream(stream)
            self.streams.add(stream.cuda_stream)
        with on_card(self.device):
            self.graph.replay()
        launches.add(self.counts)
