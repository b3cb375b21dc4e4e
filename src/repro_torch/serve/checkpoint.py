"""Versioned, fingerprinted serve-session snapshots (DESIGN.md §7).

A checkpoint is one JSON document wrapping an engine snapshot payload
(assembled by ``serve/resilience.py``) with two integrity fields:

- ``version`` — the snapshot schema version. ``read_checkpoint`` rejects
  unknown versions with a :class:`CheckpointError` instead of silently
  mis-decoding a future layout (same gating discipline as the policy
  registry).
- ``fingerprint`` — sha256 over the canonical (sorted-keys, no-whitespace)
  JSON encoding of the payload. A truncated write, a flipped bit, or a
  hand-edited file fails verification before any state is rebuilt.

Writes are atomic: the document lands in a same-directory temp file,
fsynced, then ``os.replace``d over the target — a crash mid-checkpoint
leaves the previous checkpoint intact, never a half-written one.

Arrays (slot-pool rows, single-shot logits) are encoded as base64 of the
raw buffer plus dtype/shape, so a restore round-trips them **bit-exactly**
— the restored-run output-equivalence gate in ``benchmarks/bench_chaos.py``
depends on it. Request graphs serialize as plain node lists (type, inputs,
op, attrs), reconstructed through ``Graph``'s own validating constructor.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import re
from typing import Any

import numpy as np

from repro_torch.core.graph import Graph, Node

from .queue import ServeRequest

CKPT_VERSION = 1

# Checkpoint files are named so lexicographic order == round order.
_CKPT_NAME = "ckpt_round_{round:08d}.json"
_CKPT_RE = re.compile(r"^ckpt_round_(\d+)\.json$")


class CheckpointError(RuntimeError):
    """A checkpoint could not be read, verified, or decoded."""


# -- primitive codecs ---------------------------------------------------------


def encode_array(a) -> dict:
    """Bit-exact array encoding: raw little-memory-order bytes + dtype/shape."""
    a = np.ascontiguousarray(a)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(d: dict) -> np.ndarray:
    buf = base64.b64decode(d["data"])
    arr = np.frombuffer(buf, dtype=np.dtype(d["dtype"]))
    return arr.reshape(d["shape"]).copy()


def encode_graph(g: Graph) -> list:
    """Node list in id order; ids are implicit (dense by construction)."""
    out = []
    for n in g.nodes:
        attrs = {str(k): (int(v) if isinstance(v, (int, np.integer)) else v)
                 for k, v in (n.attrs or {}).items()}
        out.append({"type": str(n.type), "inputs": [int(i) for i in n.inputs],
                    "op": n.op, "attrs": attrs})
    return out


def decode_graph(nodes: list) -> Graph:
    return Graph([Node(id=i, type=d["type"], inputs=tuple(d["inputs"]),
                       op=d.get("op", ""), attrs=dict(d.get("attrs") or {}))
                  for i, d in enumerate(nodes)])


def encode_request(req: ServeRequest) -> dict:
    """Full lifecycle snapshot of one request: identity, payload, status,
    partial tokens / feed progress, results, and any evacuated (parked)
    slot state."""
    return {
        "rid": int(req.rid),
        "family": req.family,
        "arrival": float(req.arrival),
        "prompt": ([int(t) for t in req.prompt]
                   if req.prompt is not None else None),
        "max_new": int(req.max_new),
        "graph": encode_graph(req.graph) if req.graph is not None else None,
        "deadline": req.deadline,
        "status": req.status,
        "error": req.error,
        "out": [int(t) for t in req.out],
        "feed": [int(t) for t in req.feed] if req.feed is not None else None,
        "n_fed": int(req.n_fed),
        "result": (encode_array(np.asarray(req.result))
                   if req.result is not None else None),
        "park": ({f: encode_array(np.asarray(v))
                  for f, v in req.park.items()}
                 if req.park else None),
        "admit_round": int(req.admit_round),
        "done_round": int(req.done_round),
        "t_admit": float(req.t_admit),
        "t_first": float(req.t_first),
        "t_done": float(req.t_done),
    }


def decode_request(d: dict) -> ServeRequest:
    """Rebuild without re-running ``__post_init__`` validation: a request
    that FAILED admission (e.g. a poisoned graph) must decode back to the
    same terminal record, not raise."""
    req = object.__new__(ServeRequest)
    req.family = d["family"]
    req.arrival = d["arrival"]
    req.prompt = list(d["prompt"]) if d["prompt"] is not None else None
    req.max_new = d["max_new"]
    req.graph = decode_graph(d["graph"]) if d["graph"] is not None else None
    req.deadline = d["deadline"]
    req.rid = d["rid"]
    req.status = d["status"]
    req.error = d["error"]
    req.out = list(d["out"])
    req.feed = list(d["feed"]) if d["feed"] is not None else None
    req.n_fed = d["n_fed"]
    req.result = (decode_array(d["result"])
                  if d["result"] is not None else None)
    req.park = ({f: decode_array(v) for f, v in d["park"].items()}
                if d["park"] else None)
    req.admit_round = d["admit_round"]
    req.done_round = d["done_round"]
    req.t_admit = d["t_admit"]
    req.t_first = d["t_first"]
    req.t_done = d["t_done"]
    return req


# -- document IO --------------------------------------------------------------


def fingerprint(payload: dict) -> str:
    canon = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()


def write_checkpoint(path: str, payload: dict) -> str:
    """Atomically write ``payload`` (version + fingerprint wrapped); returns
    the fingerprint. The temp file lives in the target directory so the
    final ``os.replace`` is a same-filesystem rename."""
    try:
        doc = {"version": CKPT_VERSION, "fingerprint": fingerprint(payload),
               "payload": payload}
    except TypeError as e:
        raise CheckpointError(
            f"snapshot payload is not JSON-serializable: {e}") from e
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return doc["fingerprint"]


def verify_payload(doc: dict, path: str = "<memory>") -> dict:
    """Version-gate and fingerprint-check a loaded document; returns the
    inner payload."""
    v = doc.get("version")
    if v != CKPT_VERSION:
        raise CheckpointError(
            f"checkpoint {path} has version {v!r}; this build reads only "
            f"version {CKPT_VERSION} — refusing to mis-decode it")
    payload = doc.get("payload")
    if not isinstance(payload, dict):
        raise CheckpointError(f"checkpoint {path} has no payload object")
    want = doc.get("fingerprint")
    got = fingerprint(payload)
    if got != want:
        raise CheckpointError(
            f"checkpoint {path} fingerprint mismatch (stored {want!r}, "
            f"recomputed {got!r}) — truncated or tampered snapshot")
    return payload


def read_checkpoint(path: str) -> dict:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"unreadable checkpoint {path}: {e}") from e
    if not isinstance(doc, dict):
        raise CheckpointError(f"checkpoint {path} is not a JSON object")
    return verify_payload(doc, path)


def checkpoint_path(dir_: str, round_: int) -> str:
    return os.path.join(dir_, _CKPT_NAME.format(round=int(round_)))


def list_checkpoints(dir_: str) -> list[tuple[int, str]]:
    """(round, path) pairs in round order; unreadable dirs give []."""
    try:
        names = os.listdir(dir_)
    except OSError:
        return []
    out = []
    for name in names:
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(dir_, name)))
    return sorted(out)


def latest_checkpoint(dir_: str) -> str | None:
    cks = list_checkpoints(dir_)
    return cks[-1][1] if cks else None
