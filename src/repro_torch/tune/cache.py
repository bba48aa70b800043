"""Persistent launch-plan cache for the kernel autotuner. Port of
``repro/tune/cache.py``.

One JSON file maps ``kernel|shape|dtype|platform`` keys to winning launch
plans (``{"chunk": 4096, ...}`` plus provenance). The file is shared state
between tuning runs (``python -m repro_torch.tune``) and launch-time
consumers (``kernels/adam_step.py::chunk_size``), so every access is
defensive:

* a missing, corrupt, or truncated file is an EMPTY cache, never an error —
  tuning is a performance hint, not a correctness dependency;
* entries under a different schema version (or with non-dict values) are
  ignored on read and dropped on the next write — stale keys from an old
  layout can never feed a current launch;
* writes merge into whatever is on disk at write time (last writer wins per
  key) and commit via temp-file + ``os.replace`` — concurrent tuners on one
  host cannot leave a torn file.

The schema, the variable and the path are the port's own: the JAX package's
cache (``REPRO_TUNE_CACHE``, ``~/.cache/repro/tune.json``, schema
``repro-tune/v1``) holds Pallas block plans, which are no launch shapes
here, and since a write drops every entry under another schema, sharing
its file would erase them. The location is ``$REPRO_TORCH_TUNE_CACHE``
when set, else ``~/.cache/repro_torch/tune.json``. Launch-time lookups go
through the memoised ``lookup`` so a training run touches the file at most
once per process.
"""
from __future__ import annotations

import functools
import json
import os
import tempfile
from typing import Any, Dict, Optional, Sequence

SCHEMA = "repro-torch-tune/v1"

_ENV_VAR = "REPRO_TORCH_TUNE_CACHE"


def cache_path(path: Optional[str] = None) -> str:
    if path:
        return path
    env = os.environ.get(_ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "tune.json")


def make_key(kernel: str, shape: Sequence[int], dtype: str, platform: str) -> str:
    dims = "x".join(str(int(d)) for d in shape)
    return f"{kernel}|{dims}|{dtype}|{platform}"


def load_cache(path: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """Entries of the on-disk cache; {} for missing/corrupt/foreign files."""
    p = cache_path(path)
    try:
        with open(p) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(raw, dict) or raw.get("schema") != SCHEMA:
        return {}  # stale or foreign layout: every key under it is untrusted
    entries = raw.get("entries")
    if not isinstance(entries, dict):
        return {}
    return {k: v for k, v in entries.items() if isinstance(k, str) and isinstance(v, dict)}


def save_entries(entries: Dict[str, Dict[str, Any]], path: Optional[str] = None) -> str:
    """Merge ``entries`` into the cache file atomically; returns the path."""
    p = cache_path(path)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    merged = load_cache(p)
    merged.update(entries)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p) or ".", suffix=".tune.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump({"schema": SCHEMA, "entries": merged}, f, indent=2, sort_keys=True)
        os.replace(tmp, p)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    clear_memo()
    return p


@functools.lru_cache(maxsize=None)
def _cached_entries(path: str) -> tuple:
    return tuple(sorted(load_cache(path).items()))


@functools.lru_cache(maxsize=None)
def lookup(kernel: str, shape: tuple, dtype: str, platform: str,
           path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """Launch-time plan lookup (memoised; at most one disk read per path)."""
    entries = dict(_cached_entries(cache_path(path)))
    return entries.get(make_key(kernel, shape, dtype, platform))


def clear_memo() -> None:
    """Drop the in-process memo (tests; after external cache edits)."""
    lookup.cache_clear()
    _cached_entries.cache_clear()
