"""The serve launcher's cache directory (``--cache-dir``).

The counterpart of the reference's ``launch/jaxcache.py``. There the
directory holds JAX's persistent compilation cache, so a restarted server
reads its executables back; a CUDA graph cannot outlive its process, so
here there is no such cache (the kernels' build cache is
``build/repro_torch/``, see ``kernels/build.py``), and the directory holds
only ``warmset.json``: the bucket signatures an engine has served,
persisted across restarts so the next launch can capture them again in the
background *before* the first request arrives. The functions below are the
reference's, unchanged.
"""

from __future__ import annotations

import json
import os
import warnings

QUARANTINE_SUBDIR = "_quarantine"
WARMSET_NAME = "warmset.json"


def warmset_path(cache_dir: str) -> str:
    return os.path.join(cache_dir, WARMSET_NAME)


def load_warmset(cache_dir: str) -> dict:
    """Read the warm-start descriptor set in the cache directory; a missing
    or corrupt file yields ``{}`` (cold start) — warm-start is a speedup,
    never a launch blocker."""
    path = warmset_path(cache_dir)
    try:
        with open(path) as f:
            ws = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:
        warnings.warn(f"ignoring corrupt warmset {path!r}: {e}",
                      RuntimeWarning, stacklevel=2)
        return {}
    if not isinstance(ws, dict):
        warnings.warn(f"ignoring malformed warmset {path!r} "
                      f"(expected an object)", RuntimeWarning, stacklevel=2)
        return {}
    return ws


def save_warmset(cache_dir: str, warmset: dict) -> str | None:
    """Atomically persist an engine's ``warmset()`` payload (tmp +
    ``os.replace``, same discipline as checkpoints — a crash mid-write must
    not leave a truncated file for ``load_warmset`` to trip on)."""
    if not cache_dir:
        return None
    try:
        os.makedirs(cache_dir, exist_ok=True)
        path = warmset_path(cache_dir)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(warmset, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path
    except OSError as e:
        warnings.warn(f"could not persist warmset in {cache_dir!r}: {e}",
                      RuntimeWarning, stacklevel=2)
        return None


def audit_cache_dir(cache_dir: str) -> list[str]:
    """Sweep a persistent cache directory for corrupt entries before the
    launcher reads them: zero-byte or unreadable files (the residue of a
    crash or a full disk mid-write) are moved into a ``_quarantine/``
    subdirectory —
    the entry is rebuilt fresh instead of poisoning the serve launcher.
    Returns the quarantined paths (empty on a healthy dir)."""
    quarantined: list[str] = []
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return quarantined   # missing dir: created on the first write
    qdir = os.path.join(cache_dir, QUARANTINE_SUBDIR)
    for name in names:
        path = os.path.join(cache_dir, name)
        if not os.path.isfile(path):
            continue
        bad = None
        try:
            if os.path.getsize(path) == 0:
                bad = "zero-byte entry"
            else:
                with open(path, "rb") as f:
                    f.read(1)
        except OSError as e:
            bad = f"unreadable entry ({e})"
        if bad is None:
            continue
        try:
            os.makedirs(qdir, exist_ok=True)
            dest = os.path.join(qdir, name)
            os.replace(path, dest)
            quarantined.append(dest)
            warnings.warn(
                f"quarantined corrupt XLA cache entry {path!r} ({bad}); "
                f"it will recompile fresh", RuntimeWarning, stacklevel=2)
        except OSError as e:
            warnings.warn(
                f"could not quarantine corrupt XLA cache entry {path!r}: "
                f"{e}", RuntimeWarning, stacklevel=2)
    return quarantined
