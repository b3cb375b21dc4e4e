"""Meshes: the serve engine's data mesh of K replicas, and the production
training meshes as shapes.

``make_data_mesh(k)`` is the data-mesh half of the reference's
``launch/mesh.py``: a 1-D ``("data",)`` mesh of ``k`` replicas, the mesh
the sharded bucketed-plan executor
(``core.plan.ShardedBucketedPlanExecutor``) runs under. It places them in
one of two ways (``DataMesh.placement``):

- ``"stacked"`` (the default): every replica lives on the one device the
  engine was given, as one row of a leading replica axis over the
  executor's static buffers and the engine's stacked slot pool, and one
  captured CUDA graph runs all of them. A replica id plays the part of
  the reference's device index: ``exclude`` holds ids treated as dead,
  and the mesh takes the first ``k`` surviving ids. Ids are not bounded
  by the number of cards.
- ``"cards"``: one replica a device, in one process, as the reference's
  ``shard_map`` places them: replica ``i`` on the ``i``-th surviving entry
  of ``devices`` (default every card, ``cuda:0 .. cuda:N-1``), each
  running the single-device program on its own card. ``exclude`` holds
  indices into ``devices``, the reference's device indices, and too few
  survivors raise the reference's ``RuntimeError``: a per-card mesh never
  falls back to stacking. A list may name a device more than once
  (``("cuda:0", "cuda:0")``): two placements of one card, each with its
  own buffers, graphs and slot pool, as two cards would have.

The production meshes (``make_production_mesh``): single pod 16 x 16 =
256 devices, axes ("data", "model"); multi-pod 2 x 16 x 16 = 512, axes
("pod", "data", "model"), the "pod" axis pure data parallelism across
pods. One card cannot hold them, so :func:`device_mesh` builds a
:class:`ShapeMesh` of placeholder ids, the counterpart of the reference's
forced host devices: the dry-run (``launch/dryrun.py``) and the
``Partitioner`` (``launch/sharding.py``) read only its shape and axis
names.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.device import resolve_device

PLACEMENTS = ("stacked", "cards")


class MeshError(RuntimeError):
    """Too few devices survive for a per-card mesh: the reference's
    ``RuntimeError``."""


@dataclass(frozen=True)
class DataMesh:
    """A 1-D mesh of replicas. ``replicas`` are their ids: replica ids on
    the one ``device`` when ``placement`` is ``"stacked"``, indices into
    ``listed`` (the devices the mesh was built over) when it is
    ``"cards"``. ``devices`` and ``axis_names`` answer what the
    reference's ``jax.sharding.Mesh`` answers (``mesh.devices.size`` is
    the replica count)."""

    replicas: tuple[int, ...]
    axis: str
    device: torch.device
    placement: str = "stacked"
    listed: tuple[torch.device, ...] = ()

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (self.axis,)

    @property
    def devices(self) -> np.ndarray:
        return np.asarray(self.replicas)

    @property
    def cards(self) -> tuple[torch.device, ...]:
        """The device of each replica, in shard order."""
        if self.placement == "stacked":
            return (self.device,) * len(self.replicas)
        return tuple(self.listed[i] for i in self.replicas)


def all_cards() -> tuple[torch.device, ...]:
    """Every CUDA device of the machine (none without CUDA)."""
    if not torch.cuda.is_available():
        return ()
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def concrete(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_data_mesh(n_devices: int | None = None, *, axis: str = "data",
                   exclude: tuple[int, ...] = (), device=None,
                   placement: str | None = None,
                   devices=None) -> DataMesh:
    """A 1-D pure data-parallel mesh of ``n_devices`` replicas — one
    replica of the bucketed plan program each.

    Stacked (the default): ``n_devices`` (default one) replica ids on
    ``device`` (``None`` = CUDA); ``exclude`` holds ids treated as dead and
    the mesh takes the first ``n_devices`` *surviving* ids. This is how
    the serve engine rebuilds its executor after a replica loss — the K-1
    mesh must not include the replica that died.

    Per card (``placement="cards"``, or ``devices`` given): replica ``i``
    on the ``i``-th entry of ``devices`` (default every card) whose index
    is not in ``exclude``; ``n_devices`` defaults to every survivor.
    Raises :class:`MeshError` (a ``RuntimeError``, as the reference
    raises) when fewer than ``n_devices`` survive."""
    if placement is None:
        placement = "stacked" if devices is None else "cards"
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got "
                         f"{placement!r}")
    dead = set(exclude)
    if placement == "cards":
        listed = tuple(concrete(d) for d in (
            all_cards() if devices is None else devices))
        alive = [i for i in range(len(listed)) if i not in dead]
        if n_devices is None:
            n_devices = len(alive)
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        if len(alive) < n_devices:
            if not dead:
                raise MeshError(
                    f"need {n_devices} devices for mesh "
                    f"{ {axis: n_devices} }, found {len(listed)}")
            raise MeshError(
                f"need {n_devices} devices for a 1-D {axis!r} mesh with "
                f"{sorted(dead)} excluded, but only {len(alive)} of "
                f"{len(listed)} local devices survive")
        return DataMesh(tuple(alive[:n_devices]), axis,
                        listed[alive[0]], "cards", listed)
    if devices is not None:
        raise ValueError("a stacked mesh lives on one device: pass device=, "
                         "not devices=")
    if n_devices is None:
        n_devices = 1
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    alive, i = [], 0
    while len(alive) < n_devices:
        if i not in dead:
            alive.append(i)
        i += 1
    return DataMesh(tuple(alive), axis, resolve_device(device))


@dataclass(frozen=True)
class ShapeMesh:
    """A mesh as shapes only: ``axis_names`` in order, ``shape`` (axis ->
    size, in axis order) and ``devices`` (placeholder ids ``0 .. n - 1``
    in the mesh's shape), what the reference's ``jax.sharding.Mesh``
    answers to the dry-run and the ``Partitioner``."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def devices(self) -> np.ndarray:
        return np.arange(int(np.prod(self.sizes))).reshape(self.sizes)


def device_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> ShapeMesh:
    """A mesh of ``prod(shape)`` placeholder devices with ``axes``."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    return ShapeMesh(tuple(int(n) for n in shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return device_mesh(shape, axes)


def batch_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (pod included when present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return mesh.shape["model"]


def data_parallel_size(mesh) -> int:
    out = 1
    for a in batch_axes(mesh):
        out *= mesh.shape[a]
    return out
