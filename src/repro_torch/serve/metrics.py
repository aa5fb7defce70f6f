"""Per-engine serving metrics, the reference's ``serve/metrics.py`` on this
package's ``obs.hist``.

One :class:`ServeMetrics` instance lives on every SVD engine (sync and
async).  Counters are plain monotonic totals guarded by one lock — cheap
enough to update on every submit/dispatch, and a consistent ``snapshot()``
is what ``launch/serve.py --svd``, ``chip_smoke.py``'s ``svd_serve`` phase
and operators read.

Glossary (all derivable from the raw counters, but pre-computed in the
snapshot because every consumer wants them):

* ``queue_depth``      — requests admitted but not yet dispatched (gauge).
* ``batch_fill_ratio`` — served requests / dispatched slots: 1.0 means
  every batched call was full, low values mean the bucket capacity (or the
  micro-batch window) is mis-sized and padding rows dominate.
* ``bucket_hit_rate``  — submits that landed in an already-resolved bucket
  key / total submits: the fraction of traffic that paid ZERO config
  resolution.

Backend attribution: dispatches are ALSO tallied per execution tier — ``"fused"`` (the one-dispatch fused_small backend),
``"staged"`` (the three-stage pipeline with the bisection stage 3),
``"staged-dc"`` (staged with the divide-and-conquer stage 3 for large-n
buckets), or ``"degraded-ref"`` (the fault-tolerance fallback) — via
:meth:`add_tier`, and every bucket records which tier its resolved config routed it to
(:meth:`set_bucket_tier`).  The snapshot exposes both: ``"tiers"`` holds
per-tier batches/served_slots/padded_slots (+ fill ratio), and
``"bucket_tiers"`` maps the bucket key to ``{"tier", "n", "backend"}`` —
sliceable proof of WHERE each size class actually ran, which the serve
smoke gate asserts on.

Failure taxonomy: ``retried`` / ``quarantined`` / ``degraded`` /
``sharded_retries`` count the fault-tolerance layer's
interventions, ``set_bucket_error`` keeps the LAST error (+ a running
count) per bucket key, ``set_bucket_quarantined`` tracks which buckets
are circuit-broken right now, and :meth:`health` condenses it all into
the one dict an operator (or ``launch/serve.py --svd``) wants to read.
"""

from __future__ import annotations

import threading

from repro_torch.obs.hist import StreamingHistogram

__all__ = ["ServeMetrics", "bucket_key_str"]


def bucket_key_str(key) -> str:
    """Canonical string form of a bucket key.

    Engine bucket keys are the 5-tuple ``(n, bw, dtype, banded,
    compute_uv)`` (``SVDRequest.key()``); the historical ``str(key)``
    rendering was fragile (whitespace/quoting of ``repr``) and could
    collide with user-supplied string keys.  Tuples map to the stable
    ``n=..,bw=..,dtype=..,banded=..,uv=..`` form — which no ``str(tuple)``
    can equal — strings pass through unchanged, and anything else falls
    back to ``repr``.  Used by every keyed surface on
    :class:`ServeMetrics` (``bucket_tiers``, ``bucket_errors``,
    quarantine membership, per-bucket latency histograms).
    """
    if isinstance(key, str):
        return key
    if isinstance(key, tuple) and len(key) == 5:
        n, bw, dtype, banded, uv = key
        return (f"n={n},bw={bw},dtype={dtype},"
                f"banded={int(bool(banded))},uv={int(bool(uv))}")
    return repr(key)


class ServeMetrics:
    """Thread-safe monotonic counters + gauges for one serving engine."""

    _COUNTERS = (
        "submitted",          # requests accepted into a bucket
        "completed",          # requests finished with a result
        "failed",             # requests finished with req.error set
        "timed_out",          # requests dropped at dispatch: deadline passed
        "rejected",           # requests refused at admission (queue full)
        "batches",            # batched pipeline dispatches
        "sharded_batches",    # dispatches that went through the mesh path
        "served_slots",       # sum of len(reqs) over dispatches
        "padded_slots",       # sum of (capacity - len(reqs)) over dispatches
        "bucket_hits",        # submits into an already-seen bucket key
        # --- failure taxonomy ---
        "retried",            # primary-path retry attempts (backoff ladder)
        "quarantined",        # bucket circuit-breaker trips (not requests)
        "degraded",           # requests served on the degraded ref tier
        "sharded_retries",    # mesh shards re-dispatched after a loss
    )

    # per-tier slice of the dispatch counters ("fused" vs "staged")
    _TIER_COUNTERS = ("batches", "served_slots", "padded_slots")

    # per-host slice for the multi-host router: where each
    # request was dispatched, where it completed/failed, and which
    # SURVIVING host absorbed a dead host's requeued work
    _HOST_COUNTERS = ("dispatched", "completed", "failed", "requeued")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        for name in self._COUNTERS:
            setattr(self, name, 0)
        self.queue_depth = 0                  # gauge, set by the engine
        self._tiers: dict[str, dict[str, int]] = {}
        self._hosts: dict[str, dict[str, int]] = {}
        self._bucket_tiers: dict[str, dict] = {}
        self._bucket_errors: dict[str, dict] = {}   # key -> last_error+count
        self._quarantined: set[str] = set()         # keys circuit-broken now
        # Latency/queue-age histograms: fixed-log-bucket,
        # bounded memory — no raw samples are ever buffered here.
        self._tier_lat: dict[str, StreamingHistogram] = {}
        self._bucket_lat: dict[str, StreamingHistogram] = {}
        self._queue_age = StreamingHistogram()

    def add(self, **deltas: int) -> None:
        """Atomically bump counters: ``metrics.add(submitted=1, ...)``."""
        with self._lock:
            for name, delta in deltas.items():
                assert name in self._COUNTERS, name
                setattr(self, name, getattr(self, name) + int(delta))

    def add_tier(self, tier: str, **deltas: int) -> None:
        """Bump the per-tier dispatch slice: ``add_tier("fused", batches=1,
        served_slots=3, padded_slots=1)``.  Tiers are created on first use
        so a fused-disabled engine reports no empty "fused" row."""
        with self._lock:
            row = self._tiers.setdefault(
                tier, {name: 0 for name in self._TIER_COUNTERS})
            for name, delta in deltas.items():
                assert name in self._TIER_COUNTERS, name
                row[name] += int(delta)

    def add_host(self, host: str, **deltas: int) -> None:
        """Bump the per-host attribution slice (router-side): ``add_host("w0", dispatched=1)``.  Hosts are created on
        first use, like tiers."""
        with self._lock:
            row = self._hosts.setdefault(
                str(host), {name: 0 for name in self._HOST_COUNTERS})
            for name, delta in deltas.items():
                assert name in self._HOST_COUNTERS, name
                row[name] += int(delta)

    def set_bucket_tier(self, key, tier: str, *, n: int,
                        backend: str) -> None:
        """Record which tier a bucket's resolved config routed it to.

        Keyed by :func:`bucket_key_str` (snapshots must stay
        JSON-serializable).  Idempotent per bucket — the engine calls this
        once at config-resolution time."""
        with self._lock:
            self._bucket_tiers[bucket_key_str(key)] = {
                "tier": tier, "n": int(n), "backend": backend}

    def set_bucket_error(self, key, exc: BaseException) -> None:
        """Record the latest failure for a bucket key:
        ``last_error`` is the repr of the most recent exception, ``count``
        the number of recorded failures for that key since engine start."""
        with self._lock:
            row = self._bucket_errors.setdefault(
                bucket_key_str(key), {"last_error": "", "count": 0})
            row["last_error"] = repr(exc)
            row["count"] += 1

    def set_bucket_quarantined(self, key, active: bool) -> None:
        """Track circuit-breaker membership: ``active=True`` when a bucket
        trips OPEN, ``False`` when a primary-path success recovers it."""
        with self._lock:
            if active:
                self._quarantined.add(bucket_key_str(key))
            else:
                self._quarantined.discard(bucket_key_str(key))

    # ------------------------------------------------------------------
    # latency histograms

    def tier_of_bucket(self, key) -> str:
        """Resolved tier for a bucket key, or ``"unknown"`` pre-resolution."""
        with self._lock:
            row = self._bucket_tiers.get(bucket_key_str(key))
        return row["tier"] if row else "unknown"

    def observe_latency(self, tier: str, key, seconds: float) -> None:
        """Record one request's client-view latency into the per-tier AND
        per-bucket streaming histograms.  O(1) memory per tier/bucket —
        the engines call this at completion time for every served
        request."""
        kstr = bucket_key_str(key)
        with self._lock:
            th = self._tier_lat.setdefault(tier, StreamingHistogram())
            bh = self._bucket_lat.setdefault(kstr, StreamingHistogram())
        th.add(seconds)
        bh.add(seconds)

    def observe_queue_age(self, seconds: float) -> None:
        """Record a request's age at dispatch (admission -> launch)."""
        self._queue_age.add(seconds)

    def histograms(self) -> dict:
        """Live histogram objects for exposition (``repro_torch.obs.prom``):
        ``{"tiers": {...}, "buckets": {...}, "queue_age": hist}``."""
        with self._lock:
            return {"tiers": dict(self._tier_lat),
                    "buckets": dict(self._bucket_lat),
                    "queue_age": self._queue_age}

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = int(depth)

    def snapshot(self) -> dict:
        """Consistent point-in-time view: raw counters + derived ratios."""
        with self._lock:
            snap = {name: getattr(self, name) for name in self._COUNTERS}
            snap["queue_depth"] = self.queue_depth
            tiers = {t: dict(row) for t, row in self._tiers.items()}
            snap["bucket_tiers"] = {k: dict(v)
                                    for k, v in self._bucket_tiers.items()}
            snap["bucket_errors"] = {k: dict(v)
                                     for k, v in self._bucket_errors.items()}
            snap["quarantined_buckets"] = sorted(self._quarantined)
            snap["hosts"] = {h: dict(row) for h, row in self._hosts.items()}
            tier_lat = dict(self._tier_lat)
            bucket_lat = dict(self._bucket_lat)
        snap["latency"] = {
            "tiers": {t: h.summary() for t, h in tier_lat.items()},
            "buckets": {k: h.summary() for k, h in bucket_lat.items()},
            "queue_age": self._queue_age.summary(),
        }
        slots = snap["served_slots"] + snap["padded_slots"]
        snap["batch_fill_ratio"] = (snap["served_slots"] / slots
                                    if slots else 0.0)
        snap["bucket_hit_rate"] = (snap["bucket_hits"] / snap["submitted"]
                                   if snap["submitted"] else 0.0)
        for row in tiers.values():
            tslots = row["served_slots"] + row["padded_slots"]
            row["batch_fill_ratio"] = (row["served_slots"] / tslots
                                       if tslots else 0.0)
        snap["tiers"] = tiers
        return snap

    def health(self) -> dict:
        """Operator-facing condensed view of the failure taxonomy.
        ``status`` is the headline:

        * ``"ok"``       — no client-visible failures, no open quarantines,
          no degraded traffic (retries may have happened and healed).
        * ``"degraded"`` — everyone is still getting answers, but some
          through the ref fallback tier and/or with buckets circuit-broken.
        * ``"failing"``  — requests have surfaced errors to clients.
        """
        snap = self.snapshot()
        finished = snap["completed"] + snap["failed"] + snap["timed_out"]
        if snap["failed"]:
            status = "failing"
        elif snap["degraded"] or snap["quarantined_buckets"]:
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            "submitted": snap["submitted"],
            "completed": snap["completed"],
            "client_error_rate": ((snap["failed"] + snap["timed_out"])
                                  / finished if finished else 0.0),
            "retried": snap["retried"],
            "degraded": snap["degraded"],
            "quarantined": snap["quarantined"],
            "sharded_retries": snap["sharded_retries"],
            "timed_out": snap["timed_out"],
            "rejected": snap["rejected"],
            "quarantined_buckets": snap["quarantined_buckets"],
            "bucket_errors": snap["bucket_errors"],
            "latency_p99_ms": {
                t: row.get("p99_ms")
                for t, row in snap["latency"]["tiers"].items()},
        }

    def __repr__(self) -> str:
        snap = self.snapshot()
        body = ", ".join(f"{k}={v:.3g}" if isinstance(v, float)
                         else f"{k}={v}" for k, v in sorted(snap.items()))
        return f"ServeMetrics({body})"
