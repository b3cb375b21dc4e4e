"""Device resolution and host-side waits shared by the port's entry points.

Every entry point takes an explicit ``device``. ``None`` means the card:
the port never falls back to the CPU on its own, so a machine without CUDA
raises instead of quietly running the plain PyTorch versions.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; else ``device``. Raises when that is CUDA and
    CUDA is absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless told otherwise, and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return device


def block(device: torch.device) -> None:
    """Wait for all work queued on ``device``'s current stream."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def capturing(t: torch.Tensor) -> bool:
    """True while the calling thread's current stream on ``t``'s card is
    capturing a CUDA graph."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class Published:
    """Tensors queued for writing on one stream and read from any.

    A copy derived once and cached (a cell's blocked or packed weights) may
    be built on a capture worker's stream and read by the serve loop on
    another while the write is still queued. An event is recorded after the
    write; :meth:`get` makes the calling thread's current stream wait on it
    once, and marks the tensors as used there, so the allocator does not
    hand their memory out again while that stream may still read them. On
    the CPU it only holds the tensors."""

    __slots__ = ("tensors", "event", "streams")

    def __init__(self, *tensors: torch.Tensor):
        self.tensors = tensors
        self.event = None
        self.streams: set[int] = set()
        if tensors[0].is_cuda:
            stream = torch.cuda.current_stream(tensors[0].device)
            self.event = torch.cuda.Event()
            self.event.record(stream)
            self.streams.add(stream.cuda_stream)

    def get(self) -> tuple:
        """The tensors, once the current stream is ordered after their
        write."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensors[0].device)
            if stream.cuda_stream not in self.streams:
                stream.wait_event(self.event)
                for t in self.tensors:
                    t.record_stream(stream)
                self.streams.add(stream.cuda_stream)
        return self.tensors
