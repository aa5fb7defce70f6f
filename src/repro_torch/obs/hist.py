"""Mergeable fixed-log-bucket streaming histograms, the reference's
``obs/hist.py`` unchanged (numpy only).

The serve tier and the load harness used to keep EVERY per-request latency
sample in a Python list and hand it to ``np.percentile`` at the end — O(N)
memory for an open-loop workload whose whole point is sustained traffic.
:class:`StreamingHistogram` replaces that with a fixed array of
logarithmically spaced buckets: O(1) memory per stream, O(buckets) per
percentile query, and exact ``count/sum/min/max`` tracked on the side so
the summary stays honest at the distribution edges.

Bucket scheme: ``buckets_per_decade`` buckets per power of ten between
``lo`` and ``hi`` — bucket ``i`` covers ``(lo*r^i, lo*r^(i+1)]`` with
``r = 10^(1/buckets_per_decade)``.  The default (1 µs .. 10 000 s at 10
buckets/decade = 100 buckets) makes every bucket ~26% wide in relative
terms, so any reported percentile is within ONE bucket width (a factor of
``r``) of the exact sample percentile — the invariant the serve smoke gate
asserts.  Values outside ``[lo, hi]`` clamp into the edge buckets; the
exact min/max keeps the summary truthful anyway.

Histograms with identical bucket schemes merge by adding count arrays —
cross-thread and cross-engine aggregation is one vector add, which is why
the load harness keeps one histogram per worker thread and merges at the
end instead of sharing a lock on the hot path.
"""

from __future__ import annotations

import math
import threading

import numpy as np

__all__ = ["StreamingHistogram"]


class StreamingHistogram:
    """Bounded-memory log-bucket histogram with mergeable counts.

    Thread-safe: ``add``/``merge``/queries take an internal lock.  For
    hot loops prefer one histogram per thread plus a final ``merge`` —
    the lock exists so shared instances (e.g. on :class:`ServeMetrics`)
    are safe, not to make contention free.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e4,
                 buckets_per_decade: int = 10) -> None:
        if not (0.0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if buckets_per_decade < 1:
            raise ValueError("buckets_per_decade must be >= 1")
        self.lo = float(lo)
        self.hi = float(hi)
        self.buckets_per_decade = int(buckets_per_decade)
        decades = math.log10(self.hi / self.lo)
        self._nbuckets = max(1, int(math.ceil(
            decades * self.buckets_per_decade - 1e-9)))
        # Upper edge of bucket i is lo * r^(i+1); the last edge is >= hi.
        self._log_lo = math.log10(self.lo)
        self._inv_log_r = float(self.buckets_per_decade)  # 1/log10(r)
        self._counts = np.zeros(self._nbuckets, dtype=np.int64)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # bucket geometry

    @property
    def num_buckets(self) -> int:
        return self._nbuckets

    def bucket_width_ratio(self) -> float:
        """Multiplicative width ``r`` of one bucket: ``10^(1/bpd)``."""
        return 10.0 ** (1.0 / self.buckets_per_decade)

    def upper_edges(self) -> np.ndarray:
        """Upper bucket edges (ascending), length ``num_buckets``."""
        i = np.arange(1, self._nbuckets + 1, dtype=np.float64)
        return 10.0 ** (self._log_lo + i / self.buckets_per_decade)

    def _index(self, value: float) -> int:
        if value <= self.lo:
            return 0
        idx = int(math.ceil(
            (math.log10(value) - self._log_lo) * self._inv_log_r - 1e-12)) - 1
        return min(max(idx, 0), self._nbuckets - 1)

    # ------------------------------------------------------------------
    # ingestion

    def add(self, value: float) -> None:
        value = float(value)
        idx = self._index(value) if value > 0.0 else 0
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    def extend(self, values) -> None:
        """Vectorized ``add`` for a batch of samples."""
        arr = np.asarray(list(values) if not hasattr(values, "__len__")
                         else values, dtype=np.float64)
        if arr.size == 0:
            return
        clipped = np.clip(arr, self.lo * (1.0 + 1e-15), None)
        idx = np.ceil((np.log10(clipped) - self._log_lo)
                      * self._inv_log_r - 1e-12).astype(np.int64) - 1
        idx = np.clip(idx, 0, self._nbuckets - 1)
        binned = np.bincount(idx, minlength=self._nbuckets)
        with self._lock:
            self._counts += binned
            self._count += int(arr.size)
            self._sum += float(arr.sum())
            self._min = min(self._min, float(arr.min()))
            self._max = max(self._max, float(arr.max()))

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """Fold ``other`` into ``self`` (schemes must match). Returns self."""
        if (other.lo, other.hi, other.buckets_per_decade) != (
                self.lo, self.hi, self.buckets_per_decade):
            raise ValueError(
                "cannot merge histograms with different bucket schemes: "
                f"({self.lo},{self.hi},{self.buckets_per_decade}) vs "
                f"({other.lo},{other.hi},{other.buckets_per_decade})")
        with other._lock:
            counts = other._counts.copy()
            count, total = other._count, other._sum
            omin, omax = other._min, other._max
        with self._lock:
            self._counts += counts
            self._count += count
            self._sum += total
            self._min = min(self._min, omin)
            self._max = max(self._max, omax)
        return self

    @classmethod
    def merged(cls, items) -> "StreamingHistogram":
        """Fold an iterable of histograms and/or :meth:`to_dict` payloads
        into one fresh histogram (the cross-host aggregation primitive:
        workers ship dicts over the wire, a router holds live objects —
        both merge here).  An empty iterable yields an
        empty default-scheme histogram; mixed schemes raise, as in
        :meth:`merge`."""
        out = None
        for item in items:
            h = cls.from_dict(item) if isinstance(item, dict) else item
            if out is None:
                out = cls(lo=h.lo, hi=h.hi,
                          buckets_per_decade=h.buckets_per_decade)
            out.merge(h)
        return out if out is not None else cls()

    # ------------------------------------------------------------------
    # queries

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> float:
        return self._min if self._count else math.nan

    @property
    def max(self) -> float:
        return self._max if self._count else math.nan

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else math.nan

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]).

        Returns the geometric midpoint of the bucket holding the q-th
        sample, clamped to the exact observed [min, max] so edge
        percentiles never over/under-shoot the data.
        """
        with self._lock:
            count = self._count
            if count == 0:
                return math.nan
            counts = self._counts.copy()
            lo_exact, hi_exact = self._min, self._max
        rank = q / 100.0 * (count - 1) + 1.0  # 1-based rank, linear-ish
        cum = np.cumsum(counts)
        idx = int(np.searchsorted(cum, math.ceil(rank - 1e-9)))
        idx = min(idx, self._nbuckets - 1)
        # geometric midpoint of bucket idx: lo * r^(idx+0.5)
        mid = 10.0 ** (self._log_lo + (idx + 0.5) / self.buckets_per_decade)
        return float(min(max(mid, lo_exact), hi_exact))

    def counts(self) -> np.ndarray:
        """Copy of the per-bucket counts (length ``num_buckets``)."""
        with self._lock:
            return self._counts.copy()

    def cumulative(self) -> np.ndarray:
        """Cumulative counts per upper edge — Prometheus ``le`` series."""
        return np.cumsum(self.counts())

    def summary(self, unit_scale: float = 1e3) -> dict:
        """JSON-safe summary.  ``unit_scale=1e3`` reports seconds as ms."""
        if self._count == 0:
            return {"count": 0}
        return {
            "count": int(self._count),
            "mean_ms": float(self.mean * unit_scale),
            "min_ms": float(self.min * unit_scale),
            "max_ms": float(self.max * unit_scale),
            "p50_ms": float(self.percentile(50) * unit_scale),
            "p95_ms": float(self.percentile(95) * unit_scale),
            "p99_ms": float(self.percentile(99) * unit_scale),
        }

    # ------------------------------------------------------------------
    # serialization (JSONL traces, cross-process aggregation)

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "lo": self.lo,
                "hi": self.hi,
                "buckets_per_decade": self.buckets_per_decade,
                "count": int(self._count),
                "sum": float(self._sum),
                "min": float(self._min) if self._count else None,
                "max": float(self._max) if self._count else None,
                "counts": self._counts.tolist(),
            }

    @classmethod
    def from_dict(cls, d: dict) -> "StreamingHistogram":
        h = cls(lo=d["lo"], hi=d["hi"],
                buckets_per_decade=d["buckets_per_decade"])
        counts = np.asarray(d["counts"], dtype=np.int64)
        if counts.shape != h._counts.shape:
            raise ValueError("counts length does not match bucket scheme")
        h._counts = counts
        h._count = int(d["count"])
        h._sum = float(d["sum"])
        h._min = float(d["min"]) if d.get("min") is not None else math.inf
        h._max = float(d["max"]) if d.get("max") is not None else -math.inf
        return h

    def __repr__(self) -> str:
        return (f"StreamingHistogram(count={self._count}, "
                f"buckets={self._nbuckets}, "
                f"p50={self.percentile(50):.3g})" if self._count else
                f"StreamingHistogram(count=0, buckets={self._nbuckets})")
