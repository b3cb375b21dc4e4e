"""Persistent FSM policy registry: train once, serve forever.

Learned :class:`~repro_torch.core.batching.FSMPolicy` objects were ephemeral —
keyed by identity, dead on process exit. The registry persists them as JSON
payloads (full Q-table + state-encoding name, see
``FSMPolicy.to_payload``) under stable **content fingerprints**::

    <root>/<family>/<fingerprint>.json

    {"version": 1, "family": "tree", "encoding": "sort",
     "q": [...], "meta": {"best_batches": 38, "lower_bound": 38, ...}}

The fingerprint is a sha256 over the canonical payload, so the same trained
policy saved twice lands in the same file, and a reloaded policy's
schedule/plan cache entries are stable across process restarts
(``policy_cache_key`` returns the fingerprint for sealed policies).

``auto_select(family)`` picks the best saved policy for a topology family —
lowest recorded ``final_batches``-to-``lower_bound`` gap (what the
serialized Q-table actually reproduces), fingerprint order on ties so the
choice is deterministic — and is what the serve engine consults at
construction time.
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass

from repro_torch.core.batching import (PAYLOAD_VERSION, FSMPolicy,
                                 fingerprint_payload)
from repro_torch.core.rl import RLResult

# One constant for writer and readers: files carry the FSM payload version
# that FSMPolicy.to_payload stamps.
REGISTRY_VERSION = PAYLOAD_VERSION


@dataclass
class RegistryEntry:
    family: str
    fingerprint: str
    path: str
    meta: dict
    version: int | None = REGISTRY_VERSION


class PolicyRegistry:
    def __init__(self, root: str):
        self.root = root
        # Files skipped or rejected while scanning/loading, per family:
        # {family: [{"path": ..., "error": ...}, ...]}. A registry shared
        # by many engines accumulates here; callers (the launcher's
        # summary, tests) read it after auto_select to see what was
        # ignored and why — corruption is surfaced, never fatal.
        self.diagnostics: dict[str, list[dict]] = {}

    def _diag(self, family: str, path: str, error: str) -> None:
        self.diagnostics.setdefault(family, []).append(
            {"path": path, "error": error})
        warnings.warn(f"policy registry: skipping {path}: {error}",
                      stacklevel=3)

    def _family_dir(self, family: str) -> str:
        return os.path.join(self.root, family)

    def save(self, family: str, policy: FSMPolicy,
             meta: dict | None = None) -> str:
        """Persist ``policy`` for ``family``; returns the fingerprint.

        Also seals the policy (pins its content fingerprint) so subsequent
        schedule/plan cache entries key by content, matching what a reload
        in a fresh process will produce.
        """
        payload = policy.to_payload()
        fp = fingerprint_payload(payload)
        policy._fingerprint = fp          # seal: cache keys go content-based
        doc = dict(payload)
        doc["family"] = family
        doc["meta"] = dict(meta or {})
        d = self._family_dir(family)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{fp}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return fp

    def save_result(self, family: str, result: RLResult,
                    extra_meta: dict | None = None) -> str:
        """Persist a ``train_fsm`` result with its training metrics."""
        meta = {"best_batches": result.best_batches,
                "final_batches": result.final_batches,
                "lower_bound": result.lower_bound,
                "reached_lower_bound": result.reached_lower_bound,
                "iters": result.iters,
                "train_time_s": result.train_time_s}
        meta.update(extra_meta or {})
        return self.save(family, result.policy, meta)

    def entries(self, family: str) -> list[RegistryEntry]:
        """Scan the family dir. Corrupt or truncated payloads are skipped
        with a warning and recorded in ``diagnostics`` — a registry with
        one bad file must not take auto-select (or the engine building on
        it) down."""
        d = self._family_dir(family)
        if not os.path.isdir(d):
            return []
        out = []
        for fn in sorted(os.listdir(d)):
            if not fn.endswith(".json"):
                continue
            path = os.path.join(d, fn)
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError) as exc:
                self._diag(family, path, f"unreadable payload: {exc}")
                continue
            if not isinstance(doc, dict):
                self._diag(family, path,
                           f"payload is {type(doc).__name__}, expected an "
                           f"object")
                continue
            out.append(RegistryEntry(family=family,
                                     fingerprint=fn[:-len(".json")],
                                     path=path, meta=doc.get("meta", {}),
                                     version=doc.get("version")))
        return out

    def load(self, family: str, fingerprint: str) -> FSMPolicy:
        path = os.path.join(self._family_dir(family), f"{fingerprint}.json")
        with open(path) as f:
            doc = json.load(f)
        ver = doc.get("version")
        if ver != REGISTRY_VERSION:
            raise ValueError(
                f"registry file {path} has payload version {ver!r}; this "
                f"loader supports version {REGISTRY_VERSION} — retrain the "
                f"policy or upgrade the serving binary")
        policy = FSMPolicy.from_payload(doc)
        if policy.cache_key() != fingerprint:
            raise ValueError(
                f"registry file {path} fingerprint mismatch: content hashes "
                f"to {policy.cache_key()!r}; file is corrupt or renamed")
        return policy

    def auto_select(self, family: str) -> FSMPolicy | None:
        """Best saved policy for a family: smallest batches-over-lower-bound
        gap (missing metrics sort last), then lexicographically latest file
        so the choice is deterministic. Ranks by ``final_batches`` — the
        serialized Q-table *is* the final policy, so a run whose best
        checkpoint regressed before returning must not outrank a steadier
        one on the strength of a checkpoint it no longer embodies.

        Entries with an unknown payload version are skipped (a newer
        trainer's files must not crash an older server's auto-select);
        ``load`` of such a file raises instead."""
        entries = [e for e in self.entries(family)
                   if e.version == REGISTRY_VERSION]
        if not entries:
            return None

        def gap(e: RegistryEntry) -> float:
            batches = e.meta.get("final_batches", e.meta.get("best_batches"))
            lb = e.meta.get("lower_bound")
            return (batches - lb) if (batches is not None and lb is not None) \
                else float("inf")

        # Sort by fingerprint descending first: stable min then breaks gap
        # ties toward the lexicographically latest entry, deterministically.
        entries.sort(key=lambda e: e.fingerprint, reverse=True)
        # Best-first: an entry that scans clean but fails to *load*
        # (version drift between scan and open, fingerprint mismatch from
        # bit rot) is recorded and the next-best one is tried — only a
        # registry with no loadable entry at all returns None.
        for chosen in sorted(entries, key=gap):
            try:
                return self.load(family, chosen.fingerprint)
            except (OSError, ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as exc:
                self._diag(family, chosen.path, f"load failed: {exc}")
        return None
