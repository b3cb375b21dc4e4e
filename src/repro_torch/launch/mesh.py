"""Meshes: the serve engine's data mesh of K replicas on one card, and
the production training meshes as shapes.

``make_data_mesh(k)`` is the data-mesh half of the reference's
``launch/mesh.py``: a 1-D ``("data",)`` mesh of ``k`` replicas, the mesh
the sharded bucketed-plan executor
(``core.plan.ShardedBucketedPlanExecutor``) runs under. The reference puts
one replica on each of ``k`` devices under ``shard_map``; here every
replica lives on the one device the engine was given, as one row of a
leading replica axis over the executor's static buffers and the engine's
stacked slot pool, and one captured CUDA graph runs all of them.

A replica id plays the part of the reference's device index: ``exclude``
holds ids treated as dead, and the mesh takes the first ``k`` surviving
ids, so the engine's ``excluded_devices`` (and the checkpoint field that
carries them) mean what they mean in the reference. Ids are not bounded by
the number of cards.

The production meshes (``make_production_mesh``): single pod 16 x 16 =
256 devices, axes ("data", "model"); multi-pod 2 x 16 x 16 = 512, axes
("pod", "data", "model"), the "pod" axis pure data parallelism across
pods. One card cannot hold them, so :func:`device_mesh` builds a
:class:`ShapeMesh` of placeholder ids, the counterpart of the reference's
forced host devices: the dry-run (``launch/dryrun.py``) and the
``Partitioner`` (``launch/sharding.py``) read only its shape and axis
names. Placing replicas on several cards (one process per card) is not
here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.device import resolve_device


@dataclass(frozen=True)
class DataMesh:
    """A 1-D mesh of replica ids on one device. ``devices`` and
    ``axis_names`` answer what the reference's ``jax.sharding.Mesh``
    answers (``mesh.devices.size`` is the replica count)."""

    replicas: tuple[int, ...]
    axis: str
    device: torch.device

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (self.axis,)

    @property
    def devices(self) -> np.ndarray:
        return np.asarray(self.replicas)


def make_data_mesh(n_devices: int | None = None, *, axis: str = "data",
                   exclude: tuple[int, ...] = (), device=None) -> DataMesh:
    """A 1-D pure data-parallel mesh of ``n_devices`` replicas (default:
    one) on ``device`` (``None`` = CUDA) — one replica of the bucketed plan
    program each.

    ``exclude`` holds replica ids treated as dead: the mesh takes the first
    ``n_devices`` *surviving* ids. This is how the serve engine rebuilds
    its executor after a replica loss — the K-1 mesh must not include the
    replica that died."""
    if n_devices is None:
        n_devices = 1
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    dead = set(exclude)
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
