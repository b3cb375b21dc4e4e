"""Flat-npz checkpoints of parameter and optimizer trees, in the
reference's format (``src/repro/train/checkpoint.py``): one array per leaf
under ``params/<path>`` and ``opt/<path>`` (dict keys sorted, sequence
items by index, ``/``-joined), ``__step__`` (int64) and ``__meta__`` (JSON
bytes). A file written by either package loads into the other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = (tree.detach().cpu().numpy()
                            if isinstance(tree, torch.Tensor)
                            else np.asarray(tree))
    return out


def save_checkpoint(path: str, params, opt_state=None, step: int = 0,
                    meta: dict | None = None) -> None:
    """Write ``params`` (and ``opt_state``) to ``path`` (an ``.npz``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten({"params": params})
    if opt_state is not None:
        flat.update(_flatten({"opt": opt_state}))
    np.savez(path, __step__=np.int64(step),
             __meta__=np.frombuffer(
                 json.dumps(meta or {}).encode(), dtype=np.uint8),
             **flat)


def load_checkpoint(path: str, params_template, opt_template=None):
    """Restore into the templates' structure, dtypes and devices. Returns
    ``(params, opt_state or None, step, meta)``."""
    with np.load(path) as z:
        step = int(z["__step__"])
        meta = (json.loads(bytes(z["__meta__"]).decode())
                if "__meta__" in z else {})

        def rebuild(template, prefix):
            if isinstance(template, dict):
                return {k: rebuild(v, f"{prefix}{k}/")
                        for k, v in template.items()}
            if isinstance(template, (tuple, list)):
                return type(template)(rebuild(v, f"{prefix}{i}/")
                                      for i, v in enumerate(template))
            arr = torch.from_numpy(np.array(z[prefix[:-1]]))
            return arr.to(device=template.device, dtype=template.dtype)

        params = rebuild(params_template, "params/")
        opt = (rebuild(opt_template, "opt/") if opt_template is not None
               else None)
    return params, opt, step, meta
