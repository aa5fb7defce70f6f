"""Fault-tolerance primitives for the serve fabric, the reference's
``serve/faults.py``: the same fields and the same seeded draw order, so a
given ``(seed, ordinal)`` injects the same fault in both packages.

Three pieces, shared by both engines and the sharded dispatch path:

* :class:`FaultPlan` — a deterministic, seedable fault-injection harness.
  Production failure modes (a dispatch that raises, a device that stalls,
  a chase that returns NaN sigma, a mesh shard that drops) are rare and
  hardware-bound; the plan makes every one of them reproducible on a
  laptop.  Engines accept ``faults=`` and consult the plan's hooks around
  every *primary-path* dispatch; the reference's sharded dispatch consults
  :meth:`FaultPlan.lost_shards` (its port comes with multi-GPU sharding).
  Degraded-tier (ref fallback) dispatches are never injected — the
  degraded tier models the known-good path the fabric falls back TO, so
  injecting there would make "graceful degradation" untestable.

* :class:`RetryPolicy` — how failures are absorbed: bounded attempts,
  exponential backoff with a cap, and *deadline-awareness* (a backoff
  sleep that would land past a request's deadline is never taken — the
  request degrades or fails immediately instead of burning its budget
  asleep).  :class:`~repro_torch.core.svd.NumericalFault` gets its own
  (lower) attempt bound: a numerically-poisoned bucket rarely heals on replay,
  so it is retried once and then degraded.

* :class:`BucketQuarantine` — a per-bucket-key circuit breaker.  After
  ``threshold`` consecutive primary-path failures a ``(n, bw, dtype,
  banded, compute_uv)`` bucket is OPEN: its traffic routes straight to
  the degraded ref tier (no primary attempts, no backoff) until
  ``cooldown_s`` elapses; the first primary trial after cooldown
  (HALF-OPEN) either closes the breaker or re-trips it.

Everything here is plain Python (no torch import at module scope): the
harness must be importable and runnable even where the accelerator stack
is broken — that is the point.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

__all__ = ["FaultPlan", "RetryPolicy", "BucketQuarantine",
           "InjectedFault", "InjectedDispatchError", "InjectedDeviceLoss"]


class InjectedFault(RuntimeError):
    """Base marker for every exception raised by a :class:`FaultPlan` —
    lets tests and accounting distinguish injected failures from real
    ones (production code must NOT special-case it: to the retry layer an
    injected fault is indistinguishable from the failure it simulates)."""


class InjectedDispatchError(InjectedFault):
    """Simulated transient dispatch failure (XLA launch error, OOM retry,
    preempted kernel).  Retryable: the next attempt usually succeeds."""


class InjectedDeviceLoss(InjectedFault):
    """Simulated loss of the device under a whole dispatch (unplugged
    accelerator, dead host process).  The retry ladder treats it like any
    other dispatch failure; the sharded path re-dispatches per shard."""


@dataclasses.dataclass
class FaultPlan:
    """Deterministic, seedable fault injection for the serve stack.

    Probabilistic knobs (``*_rate``) draw from one seeded
    ``numpy.random.Generator`` under a lock — the i-th dispatch sees the
    i-th draw, so a given ``(seed, dispatch ordinal)`` always injects the
    same fault.  Scripted knobs (``*_at``) name exact ordinals and fire
    regardless of the rates — use them when a test (or the CI chaos gate)
    must be *guaranteed* to exercise a path at least once.

    Hooks (all thread-safe):

    * :meth:`before_dispatch` — called by engines before every primary
      pipeline dispatch; may sleep (``latency_s``) and may raise
      :class:`InjectedDispatchError` / :class:`InjectedDeviceLoss`.
    * :meth:`corrupt_sigma`   — called on the freshly-computed sigma
      block; may overwrite entries with NaN/Inf (returns a corrupted
      copy; the input is never mutated).
    * :meth:`lost_shards`     — called by ``sharded_pipeline_dispatch``;
      returns the shard indices "lost" under the current dispatch.

    ``max_faults`` bounds the TOTAL number of injections (scripted ones
    included) so a high-rate plan cannot starve a retry ladder forever.
    ``injected`` is a running tally per fault kind for reporting.
    """

    seed: int = 0
    dispatch_error_rate: float = 0.0     # InjectedDispatchError before dispatch
    device_loss_rate: float = 0.0        # InjectedDeviceLoss before dispatch
    nan_rate: float = 0.0                # one sigma entry -> NaN per result
    inf_rate: float = 0.0                # one sigma entry -> Inf per result
    latency_rate: float = 0.0            # sleep latency_s before dispatch
    latency_s: float = 0.0
    shard_loss_rate: float = 0.0         # per-shard loss in sharded dispatch
    host_loss_rate: float = 0.0          # whole-host loss per heartbeat tick
    dispatch_errors_at: tuple = ()       # scripted dispatch ordinals (0-based)
    device_loss_at: tuple = ()
    nan_at: tuple = ()                   # scripted result ordinals
    shard_loss_at: tuple = ()            # scripted sharded-dispatch ordinals
    host_loss_at: tuple = ()             # scripted heartbeat-tick ordinals
    max_faults: int | None = None

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(self.seed)
        self._dispatches = 0             # before_dispatch ordinal
        self._results = 0                # corrupt_sigma ordinal
        self._sharded = 0                # lost_shards ordinal
        self._host_ticks = 0             # lose_host ordinal (heartbeats)
        self.injected: dict[str, int] = {
            "dispatch_error": 0, "device_loss": 0, "nan": 0, "inf": 0,
            "latency": 0, "shard_loss": 0, "host_loss": 0}

    # ------------------------------------------------------------------

    def _budget_left(self) -> bool:
        return (self.max_faults is None
                or sum(self.injected.values()) < self.max_faults)

    def _count(self, kind: str) -> None:
        self.injected[kind] += 1

    def before_dispatch(self, key=None) -> None:
        """May sleep (latency fault) and/or raise an injected dispatch
        exception.  Exactly three uniform draws are consumed per call, so
        the stream stays aligned whatever the configured rates."""
        with self._lock:
            i = self._dispatches
            self._dispatches += 1
            u_lat, u_err, u_loss = self._rng.uniform(size=3)
            if not self._budget_left():
                return
            sleep_s = 0.0
            if self.latency_s > 0 and u_lat < self.latency_rate:
                self._count("latency")
                sleep_s = self.latency_s
            exc = None
            if i in self.device_loss_at or u_loss < self.device_loss_rate:
                self._count("device_loss")
                exc = InjectedDeviceLoss(
                    f"injected device loss at dispatch {i} (key={key})")
            elif i in self.dispatch_errors_at or u_err < self.dispatch_error_rate:
                self._count("dispatch_error")
                exc = InjectedDispatchError(
                    f"injected dispatch error at dispatch {i} (key={key})")
        if sleep_s:
            time.sleep(sleep_s)          # outside the lock
        if exc is not None:
            raise exc

    def corrupt_sigma(self, sig: np.ndarray) -> np.ndarray:
        """Possibly overwrite one entry of ``sig`` with NaN/Inf; returns a
        (corrupted) copy, never mutating the input.  One flat index draw
        plus two uniforms per call, seed-deterministic."""
        sig = np.asarray(sig)
        with self._lock:
            i = self._results
            self._results += 1
            u_nan, u_inf = self._rng.uniform(size=2)
            flat = int(self._rng.integers(max(sig.size, 1)))
            if sig.size == 0 or not self._budget_left():
                return sig
            val = None
            if i in self.nan_at or u_nan < self.nan_rate:
                self._count("nan")
                val = np.nan
            elif u_inf < self.inf_rate:
                self._count("inf")
                val = np.inf
            if val is None:
                return sig
        out = sig.copy()
        out.flat[flat] = val
        return out

    def lost_shards(self, shards: int) -> list[int]:
        """Shard indices lost under the current sharded dispatch (possibly
        empty).  Scripted ordinals lose shard ``ordinal % shards``."""
        with self._lock:
            i = self._sharded
            self._sharded += 1
            draws = self._rng.uniform(size=max(shards, 1))
            if not self._budget_left():
                return []
            lost = [j for j in range(shards)
                    if draws[j] < self.shard_loss_rate]
            if i in self.shard_loss_at and (i % shards) not in lost:
                lost.append(i % shards)
            for _ in lost:
                self._count("shard_loss")
            return sorted(lost)

    def lose_host(self, host_ids) -> str | None:
        """Host id to drop at this heartbeat tick, or ``None``
        (consulted by a multi-host router once per tick).  Exactly one
        uniform plus one integer draw per call keeps the stream aligned whatever fires; scripted
        ``host_loss_at`` ordinals index heartbeat TICKS, and the victim
        is chosen by the integer draw over the alive set."""
        host_ids = list(host_ids)
        with self._lock:
            i = self._host_ticks
            self._host_ticks += 1
            u = float(self._rng.uniform())
            j = int(self._rng.integers(max(len(host_ids), 1)))
            if not host_ids or not self._budget_left():
                return None
            if i in self.host_loss_at or u < self.host_loss_rate:
                self._count("host_loss")
                return host_ids[j % len(host_ids)]
            return None

    def snapshot(self) -> dict:
        """Tally of injections so far (for reports and gate assertions)."""
        with self._lock:
            return {"dispatches": self._dispatches, "results": self._results,
                    "sharded": self._sharded,
                    "host_ticks": self._host_ticks, **dict(self.injected)}


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How the serve fabric absorbs a failed dispatch .

    ``max_attempts`` bounds TOTAL primary-path attempts per request (the
    first dispatch counts); ``numerical_max_attempts`` is the tighter
    bound applied when the latest failure is a
    :class:`~repro_torch.core.svd.NumericalFault` — retry once, then degrade
    (a poisoned spectrum rarely heals on replay, and the ref tier is the
    trustworthy answer).  Backoff before retry k (k = failures so far) is
    ``backoff_base_s * backoff_factor**(k-1)`` capped at
    ``backoff_max_s`` — and is *deadline-aware*: a sleep that would end
    past the request's deadline is never taken (see :meth:`backoff_for`).

    The quarantine knobs parameterize the per-bucket circuit breaker the
    engine builds from this policy (:class:`BucketQuarantine`).
    """

    max_attempts: int = 3
    numerical_max_attempts: int = 2
    backoff_base_s: float = 0.002
    backoff_factor: float = 2.0
    backoff_max_s: float = 0.100
    quarantine_threshold: int = 3
    quarantine_cooldown_s: float = 30.0

    def attempts_for(self, exc: BaseException) -> int:
        """Attempt bound given the latest failure's type."""
        from repro_torch.core.svd import NumericalFault
        if isinstance(exc, NumericalFault):
            return max(int(self.numerical_max_attempts), 1)
        return max(int(self.max_attempts), 1)

    def backoff_for(self, failures: int, *, deadline: float | None,
                    now: float) -> float | None:
        """Backoff sleep before the next attempt, or ``None`` when no
        further attempt is allowed to sleep: the delay would land at or
        past ``deadline`` (an absolute ``time.monotonic`` instant).
        ``failures`` is the number of failed attempts so far (>= 1)."""
        delay = min(self.backoff_base_s
                    * self.backoff_factor ** max(failures - 1, 0),
                    self.backoff_max_s)
        if deadline is not None and now + delay >= deadline:
            return None
        return max(delay, 0.0)


class BucketQuarantine:
    """Per-bucket-key circuit breaker: CLOSED -> OPEN -> HALF-OPEN.

    ``record_failure`` counts *consecutive* primary-path failures per
    key; at ``threshold`` the key trips OPEN (``active`` -> True) for
    ``cooldown_s``.  While OPEN the engine routes the bucket straight to
    the degraded tier.  After cooldown ``active`` returns False again
    (HALF-OPEN): the next primary trial either closes the breaker
    (``record_success``) or re-trips it for another full cooldown.
    Thread-safe; ``clock`` is injectable for tests.
    """

    def __init__(self, *, threshold: int = 3, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures: dict = {}        # key -> consecutive failure count
        self._open_at: dict = {}         # key -> trip instant (monotonic)

    def record_failure(self, key) -> bool:
        """One primary-path failure; True iff the key newly tripped OPEN
        (a HALF-OPEN trial failure re-arms the cooldown, not reported as
        a new trip)."""
        with self._lock:
            self._failures[key] = self._failures.get(key, 0) + 1
            if key in self._open_at:                 # HALF-OPEN trial failed
                self._open_at[key] = self._clock()
                return False
            if self._failures[key] >= self.threshold:
                self._open_at[key] = self._clock()
                return True
            return False

    def record_success(self, key) -> bool:
        """One primary-path success; resets the key to CLOSED.  True iff
        the key was OPEN/HALF-OPEN (i.e. this success RECOVERED it)."""
        with self._lock:
            self._failures.pop(key, None)
            return self._open_at.pop(key, None) is not None

    def active(self, key) -> bool:
        """True while the key is OPEN (inside its cooldown window).  After
        cooldown the key is HALF-OPEN: this returns False so ONE primary
        trial flows; the trial's outcome closes or re-trips."""
        with self._lock:
            t = self._open_at.get(key)
            if t is None:
                return False
            return (self._clock() - t) < self.cooldown_s

    def open_keys(self) -> list:
        """Keys currently OPEN or HALF-OPEN (tripped, not yet recovered)."""
        with self._lock:
            return list(self._open_at)
