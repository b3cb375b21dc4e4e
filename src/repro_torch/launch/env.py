"""Tuned launcher environment: tcmalloc behind ``--perf-profile``.

The counterpart of the reference's ``launch/env.py``, without its XLA and
JAX settings. The serve loop allocates host memory for every round (index
packs, request graphs, token lists), so the profile puts tcmalloc in place
of glibc malloc:

- :func:`apply_perf_profile` sets tcmalloc's report threshold and, when a
  tcmalloc shared object exists on the host but is not yet preloaded,
  **re-execs the process once** with ``LD_PRELOAD`` pointing at it (an
  allocator cannot be swapped in after startup). The re-exec is guarded by
  a marker env var so it happens at most once, and is skipped entirely
  when tcmalloc is absent.
- :func:`active_profile` reports what is actually in effect, so a number
  measured under glibc malloc is distinguishable from one measured under
  tcmalloc.

All settings are ``setdefault`` — an operator's explicit environment
always wins over the profile.
"""

from __future__ import annotations

import os
import sys

__all__ = ["find_tcmalloc", "apply_perf_profile", "active_profile",
           "add_perf_profile_arg", "maybe_apply_perf_profile"]

# Marker guarding the one-shot re-exec (and recording that the profile ran).
_MARKER = "REPRO_TORCH_PERF_PROFILE"

# Where common distros put tcmalloc.
_TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
    "/usr/lib64/libtcmalloc.so.4",
)


def find_tcmalloc() -> str | None:
    """First tcmalloc shared object present on this host, or None."""
    for path in _TCMALLOC_CANDIDATES:
        if os.path.exists(path):
            return path
    return None


def _argv() -> list[str]:
    """The command line that started this process, as ``python -m`` named
    it when it did."""
    spec = getattr(sys.modules.get("__main__"), "__spec__", None)
    if spec is not None and spec.name:
        return [sys.executable, "-m", spec.name.removesuffix(".__main__")] \
            + sys.argv[1:]
    return [sys.executable] + sys.argv


def apply_perf_profile(reexec: bool = True) -> dict:
    """Apply the tuned launcher profile; returns :func:`active_profile`.

    When ``reexec`` is true and tcmalloc exists but is not preloaded, the
    process restarts itself once via ``os.execv`` with ``LD_PRELOAD`` set —
    this call then never returns in the first process."""
    env = os.environ
    # Silence tcmalloc's large-allocation warnings (arena pools trip the
    # default threshold constantly).
    env.setdefault("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "60000000000")
    tc = find_tcmalloc()
    already = env.get(_MARKER) == "1"
    preloaded = tc is not None and tc in env.get("LD_PRELOAD", "")
    if reexec and tc is not None and not preloaded and not already:
        env["LD_PRELOAD"] = ":".join(
            p for p in (env.get("LD_PRELOAD", ""), tc) if p)
        env[_MARKER] = "1"
        sys.stdout.flush()
        sys.stderr.flush()
        argv = _argv()
        os.execv(argv[0], argv)
    env[_MARKER] = "1"
    return active_profile()


def active_profile() -> dict:
    """What is in effect *now* (honest even when the profile never ran)."""
    ld = os.environ.get("LD_PRELOAD", "")
    return {
        "applied": os.environ.get(_MARKER) == "1",
        "tcmalloc": "tcmalloc" in ld,
        "ld_preload": ld,
        "tcmalloc_large_alloc_report_threshold":
            os.environ.get("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", ""),
    }


def add_perf_profile_arg(ap) -> None:
    """``--perf-profile``: opt into the tuned environment."""
    ap.add_argument("--perf-profile", action="store_true",
                    help="apply the tuned launcher environment before "
                         "serving: tcmalloc LD_PRELOAD (one-shot re-exec "
                         "when the library exists)")


def maybe_apply_perf_profile(args) -> None:
    if getattr(args, "perf_profile", False):
        apply_perf_profile()
