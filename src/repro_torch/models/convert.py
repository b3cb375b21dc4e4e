"""Install weights given as numpy arrays into a port workload.

The arrays are in the JAX package's own layout: each cell's packed
parameter buffer (ordered by ``CompiledCell.offsets``), the embedding
tables, and the output projection. They are keyed by
``(impl name, array name)`` with the array names the reference's impl
closures use: ``pbuf``, ``table``, ``wo`` and ``bo``.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(workload, arrays: dict[tuple[str, str], np.ndarray]
                      ) -> None:
    """Copy every ``arrays[(impl, name)]`` into the workload's tensor of that
    name, in place (device and dtype stay). Raises on an unknown key or a
    shape mismatch."""
    for (impl_name, key), arr in arrays.items():
        impl = workload.impls.get(impl_name)
        if impl is None or key not in impl.params:
            raise KeyError(f"workload {workload.name!r} has no parameter "
                           f"{key!r} on impl {impl_name!r}")
        dst = impl.params[key]
        src = torch.from_numpy(np.array(arr))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{impl_name}.{key}: shape {tuple(src.shape)} "
                             f"does not match {tuple(dst.shape)}")
        dst.copy_(src)
