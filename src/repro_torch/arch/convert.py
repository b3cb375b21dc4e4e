"""Install the reference's ``TransformerLM.init_params`` tree into the
port's parameters, and take the port's tree back out as numpy arrays.

The reference's tree, given as nested dicts and tuples of numpy arrays, has
the same structure, leaf shapes and dtypes as the port's (``embed``,
``blocks`` with one dict per pattern position and a leading repeat axis,
``final_norm``, ``lm_head``), so installing is a checked in-place copy.

numpy has no bfloat16 of its own. A bfloat16 leaf of the reference's tree
comes as an array of ``ml_dtypes``' type (dtype name ``bfloat16``), which
is read here by its bits without importing ``ml_dtypes``; the port hands
its bfloat16 tensors out as ``uint16`` arrays of their bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import tree_map


def install_params(params, tree, path: str = "params") -> None:
    """Copy every array of ``tree`` into the tensor at the same place in
    ``params``, in place (device and dtype stay). Raises ``KeyError`` on a
    key ``params`` lacks and ``ValueError`` on a structure or shape
    mismatch."""
    if isinstance(tree, dict):
        if not isinstance(params, dict):
            raise ValueError(f"{path}: a dict where the model has "
                             f"{type(params).__name__}")
        for key, sub in tree.items():
            if key not in params:
                raise KeyError(f"{path} has no parameter {key!r}")
            install_params(params[key], sub, f"{path}.{key}")
        return
    if isinstance(tree, (tuple, list)):
        if not isinstance(params, (tuple, list)) or len(params) != len(tree):
            raise ValueError(f"{path}: a sequence of {len(tree)} where the "
                             f"model has {type(params).__name__}")
        for i, (dst, sub) in enumerate(zip(params, tree)):
            install_params(dst, sub, f"{path}[{i}]")
        return
    if not isinstance(params, torch.Tensor):
        raise ValueError(f"{path}: an array where the model has "
                         f"{type(params).__name__}")
    src = _tensor(np.asarray(tree))
    if src.dtype != params.dtype:
        raise ValueError(f"{path}: a {src.dtype} leaf where the model has "
                         f"{params.dtype}")
    if tuple(src.shape) != tuple(params.shape):
        raise ValueError(f"{path}: shape {tuple(src.shape)} does not match "
                         f"{tuple(params.shape)}")
    params.copy_(src)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A leaf as a CPU tensor of its own dtype; a bfloat16 leaf (either
    form of the module docstring) by its bits."""
    if arr.dtype.name == "bfloat16" or arr.dtype == np.uint16:
        bits = np.array(arr).view(np.int16)   # a writable copy
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_to_numpy(params):
    """The port's parameter tree as nested dicts and tuples of numpy
    arrays, the form :func:`install_params` takes: a float32 tensor as a
    float32 array, a bfloat16 tensor as a ``uint16`` array of its bits
    (which :func:`install_params` takes back bit for bit)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    return tree_map(leaf, params)
