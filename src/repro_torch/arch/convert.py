"""Install the reference's ``TransformerLM.init_params`` tree into the
port's parameters, and take the port's tree back out as numpy arrays.

The reference's tree, given as nested dicts and tuples of numpy arrays, has
the same structure and leaf shapes as the port's (``embed``, ``blocks`` with
one dict per pattern position and a leading repeat axis, ``final_norm``,
``lm_head``), so installing is a checked in-place copy.
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
    src = torch.from_numpy(np.array(tree))
    if not isinstance(params, torch.Tensor):
        raise ValueError(f"{path}: an array where the model has "
                         f"{type(params).__name__}")
    if tuple(src.shape) != tuple(params.shape):
        raise ValueError(f"{path}: shape {tuple(src.shape)} does not match "
                         f"{tuple(params.shape)}")
    params.copy_(src)


def params_to_numpy(params):
    """The port's parameter tree as nested dicts and tuples of numpy
    arrays, the form :func:`install_params` takes."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
