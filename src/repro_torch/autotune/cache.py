"""Persistent tuned-config cache: one JSON file, atomic writes.

The reference's cache (``autotune/cache.py``) with its schema unchanged, so
a file written by either package reads in the other.  Entries are keyed by
everything that shifts the optimum — ``(device_kind, n, bw, dtype,
compute_uv, backend)`` — and hold the tuned knobs ``(tw, fuse,
max_batch)`` plus their provenance (measured and predicted times, the
model's rank, a timestamp).  ``PipelineConfig.resolve(autotune=True)``
looks entries up and keeps the analytic defaults on a miss;
``python -m repro_torch.autotune`` writes them.

The cache location is ``$REPRO_TORCH_AUTOTUNE_CACHE`` when set, else
``~/.cache/repro-torch-autotune/cache.json`` (``$XDG_CACHE_HOME``
honored).
Writes are atomic (tempfile + ``os.replace`` in the destination directory)
and read-modify-write merges, so concurrent tuners lose at worst one
entry, never the file.  A corrupt or truncated cache file reads as empty —
tuning degrades to the analytic defaults instead of crashing the caller.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

__all__ = ["ENV_VAR", "SCHEMA_VERSION", "cache_path", "make_key",
           "load", "lookup", "store", "crossover_key", "lookup_crossover",
           "store_crossover", "stage3_key", "lookup_stage3", "store_stage3"]

ENV_VAR = "REPRO_TORCH_AUTOTUNE_CACHE"
SCHEMA_VERSION = 1


def cache_path(path: str | None = None) -> str:
    """Resolve the cache file path: explicit arg > env var > XDG default."""
    if path:
        return path
    env = os.environ.get(ENV_VAR, "")
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro-torch-autotune", "cache.json")


def make_key(*, device_kind: str, n: int, bw: int, dtype: str,
             compute_uv: bool, backend: str) -> str:
    """Flat string key (JSON objects can't key on tuples)."""
    return (f"device={device_kind}|n={int(n)}|bw={int(bw)}|dtype={dtype}"
            f"|uv={int(bool(compute_uv))}|backend={backend}")


def load(path: str | None = None) -> dict:
    """The whole cache as a dict (``{"version": .., "entries": {key: ..}}``);
    missing, corrupt, or schema-mismatched files read as empty."""
    p = cache_path(path)
    try:
        with open(p) as f:
            doc = json.load(f)
        if (not isinstance(doc, dict)
                or not isinstance(doc.get("entries"), dict)
                or doc.get("version") != SCHEMA_VERSION):
            return {"version": SCHEMA_VERSION, "entries": {}}
        return doc
    except (OSError, ValueError):
        return {"version": SCHEMA_VERSION, "entries": {}}


def lookup(*, device_kind: str, n: int, bw: int, dtype: str,
           compute_uv: bool, backend: str, path: str | None = None
           ) -> dict | None:
    """The tuned entry for a pipeline key, or None (fall back to defaults).

    Entries missing either kernel knob (``tw``, ``fuse``) are treated as
    corrupt (None) so a half-written record can never half-configure a
    pipeline.  ``max_batch`` is OPTIONAL — the search only persists it
    when the batch axis was actually explored; when present it must be a
    valid int >= 1 or the whole entry is rejected.
    """
    entry = load(path)["entries"].get(make_key(
        device_kind=device_kind, n=n, bw=bw, dtype=dtype,
        compute_uv=compute_uv, backend=backend))
    if not isinstance(entry, dict):
        return None
    if not all(isinstance(entry.get(k), int) and entry[k] >= 1
               for k in ("tw", "fuse")):
        return None
    if "max_batch" in entry and not (isinstance(entry["max_batch"], int)
                                     and entry["max_batch"] >= 1):
        return None
    return entry


def _merge(key: str, entry: dict, path: str | None) -> str:
    """Merge one entry into the cache under ``key``, atomically; returns
    the path.  Read-modify-write: entries under other keys survive.  The
    temp file lives in the destination directory so ``os.replace`` stays
    on one filesystem (atomic rename)."""
    p = cache_path(path)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    doc = load(p)
    entry = dict(entry)
    entry.setdefault("tuned_at_unix", int(time.time()))
    doc["entries"][key] = entry
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p) or ".",
                               prefix=".cache-", suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return p


def store(entry: dict, *, device_kind: str, n: int, bw: int, dtype: str,
          compute_uv: bool, backend: str, path: str | None = None) -> str:
    """Merge one tuned entry into the cache, atomically; returns the
    path."""
    return _merge(make_key(device_kind=device_kind, n=n, bw=bw, dtype=dtype,
                           compute_uv=compute_uv, backend=backend),
                  entry, path)


# ---------------------------------------------------------------------------
# Fused-tier crossover entries
# ---------------------------------------------------------------------------
#
# The fused-vs-staged crossover is a property of (device, dtype, uv[, bw]),
# not of one (n, bw) shape, so it gets its own key family in the SAME
# entries dict ("crossover|..." never collides with make_key's "device=..."
# namespace, and the per-shape ``lookup`` validation — which demands tw/fuse
# — never sees these entries).

def crossover_key(*, device_kind: str, dtype: str, compute_uv: bool,
                  bw: int | None = None) -> str:
    key = (f"crossover|device={device_kind}|dtype={dtype}"
           f"|uv={int(bool(compute_uv))}")
    if bw is not None:
        key += f"|bw={int(bw)}"
    return key


def lookup_crossover(*, device_kind: str, dtype: str, compute_uv: bool,
                     bw: int | None = None, path: str | None = None
                     ) -> int | None:
    """The tuned fused-tier crossover n, or None (use the static default).

    Looks for the bw-specific entry first, then the device/dtype-wide one —
    a tuner run with ``--fused-crossover`` stores under the exact bw it
    measured AND the wide key, so callers at other bandwidths still get a
    measured figure.
    """
    entries = load(path)["entries"]
    keys = []
    if bw is not None:
        keys.append(crossover_key(device_kind=device_kind, dtype=dtype,
                                  compute_uv=compute_uv, bw=bw))
    keys.append(crossover_key(device_kind=device_kind, dtype=dtype,
                              compute_uv=compute_uv))
    for key in keys:
        entry = entries.get(key)
        if (isinstance(entry, dict)
                and isinstance(entry.get("fused_n_max"), int)
                and entry["fused_n_max"] >= 0):
            return entry["fused_n_max"]
    return None


def store_crossover(entry: dict, *, device_kind: str, dtype: str,
                    compute_uv: bool, bw: int | None = None,
                    path: str | None = None) -> str:
    """Merge one crossover entry (``{"fused_n_max": int, ...}``) into the
    cache, atomically, under the (optionally bw-specific) crossover key."""
    if not isinstance(entry.get("fused_n_max"), int):
        raise ValueError(f"a crossover entry needs an int fused_n_max: "
                         f"{entry}")
    return _merge(crossover_key(device_kind=device_kind, dtype=dtype,
                                compute_uv=compute_uv, bw=bw), entry, path)


# ---------------------------------------------------------------------------
# Stage-3 solver crossover entries
# ---------------------------------------------------------------------------
#
# The bisect-vs-dc crossover of the bidiagonal solve is a property of
# (device, dtype, uv): stage 3 never sees the band, so there is no bw axis.
# Same entries dict, its own "stage3|..." prefix.

def stage3_key(*, device_kind: str, dtype: str, compute_uv: bool) -> str:
    return (f"stage3|device={device_kind}|dtype={dtype}"
            f"|uv={int(bool(compute_uv))}")


def lookup_stage3(*, device_kind: str, dtype: str, compute_uv: bool,
                  path: str | None = None) -> int | None:
    """The measured dc crossover ``dc_n_min`` (the smallest n from which
    the divide-and-conquer stage 3 beat bisection on this device), or None
    (use ``core.bidiag_dc.DEFAULT_DC_N_MIN``).  A tuner that saw dc lose at
    every n stores a beyond-any-n sentinel, so "never" reads back as a
    (large) threshold rather than a miss."""
    entry = load(path)["entries"].get(stage3_key(
        device_kind=device_kind, dtype=dtype, compute_uv=compute_uv))
    if (isinstance(entry, dict) and isinstance(entry.get("dc_n_min"), int)
            and entry["dc_n_min"] >= 1):
        return entry["dc_n_min"]
    return None


def store_stage3(entry: dict, *, device_kind: str, dtype: str,
                 compute_uv: bool, path: str | None = None) -> str:
    """Merge one stage-3 crossover entry (``{"dc_n_min": int, ...}``) into
    the cache, atomically, under the (device, dtype, uv) stage3 key."""
    if not isinstance(entry.get("dc_n_min"), int):
        raise ValueError(f"a stage-3 entry needs an int dc_n_min: {entry}")
    return _merge(stage3_key(device_kind=device_kind, dtype=dtype,
                             compute_uv=compute_uv), entry, path)
