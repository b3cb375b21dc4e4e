"""The serve engine's data mesh: K data-parallel replicas on one card.

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

Placing replicas on several cards (one process per card) and the training
meshes (``device_mesh``, ``make_production_mesh``) are not here.
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
