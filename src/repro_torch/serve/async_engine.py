"""Asynchronous micro-batching SVD serving tier, after the reference's
``serve/async_engine.py``.

The synchronous :class:`~repro_torch.serve.engine.SVDEngine` batches only
as fast as one thread submits-then-steps; under live traffic the batch axis
would sit empty.  :class:`AsyncSVDEngine` puts a thread-safe queue and a
background dispatcher between callers and the batched pipeline:

* ``submit() -> concurrent.futures.Future`` — callers never block on other
  requests; the resolved value is the completed :class:`SVDRequest`, its
  results already on the host.  ``submit_async()`` wraps the same future
  for ``await``-style callers (asyncio bridge).
* **Micro-batching window** — a bucket is dispatched the moment it reaches
  its capacity (``max_batch`` of the bucket's config), or once its oldest
  request has waited ``batch_window_s``: bounded added latency, maximal
  batch fill under load.
* **Deadline-aware admission** — per-request (or engine-default) timeouts
  become absolute deadlines; a request still queued past its deadline is
  failed with :class:`TimeoutError` *before* dispatch.  A full queue
  (``max_pending``) refuses admission with :class:`QueueFullError`.
* **Oversize splitting** — a burst larger than a bucket's capacity is
  served as back-to-back full batches, FIFO.
* **Dispatch across devices** — with a ``mesh`` (see
  ``repro_torch.launch.mesh.serve_mesh``), every bucket is split over the
  mesh's devices through ``core.distributed.sharded_pipeline_dispatch``.
* **Fault tolerance** — inherited from the sync engine: the numerical
  guard on every result, the retry ladder, the per-bucket quarantine and
  the degraded ref tier.  Deadlines are re-checked at COMPLETION too (a
  request finished past its deadline resolves with :class:`TimeoutError`,
  counted ``timed_out``; the late results stay on the request), and
  backoff sleeps run on the dispatcher thread, capped by
  ``RetryPolicy.backoff_max_s``.

The dispatcher is the ONE consumer of the buckets and the one thread that
launches kernels (with a mesh, through one thread a shard); the compute
happens outside the engine lock, so admission keeps flowing while a batch
is on the device.  Do not mix the inherited
synchronous ``step()``/``run()`` with a started async engine.
"""

from __future__ import annotations

import asyncio
import collections
import threading
import time
from concurrent.futures import CancelledError, Future

from repro_torch.serve.engine import SVDEngine, SVDRequest

__all__ = ["AsyncSVDEngine", "QueueFullError"]


class QueueFullError(RuntimeError):
    """Admission refused: the engine already holds ``max_pending`` requests."""


class AsyncSVDEngine(SVDEngine):
    """Thread-safe, micro-batching, future-returning SVD serving engine.

    >>> with AsyncSVDEngine(device="cpu", batch_window_s=0.005) as eng:
    ...     futs = [eng.submit(SVDRequest(uid=i, matrix=a, bw=8))
    ...             for i, a in enumerate(mats)]
    ...     sigmas = [f.result(timeout=60).sigma for f in futs]

    Construction kwargs extend :class:`SVDEngine` (config / backend /
    device / autotune / mesh) with the serving knobs: ``batch_window_s``
    (max extra latency a lone request pays waiting for co-batchable traffic),
    ``default_timeout_s`` (deadline applied to requests submitted without
    one; ``None`` = wait forever), and ``max_pending`` (admission bound).

    Results are delivered through futures, so — unlike the sync engine,
    whose callers consume ``run()``'s return — nobody drains
    ``finished``; it is therefore a BOUNDED deque here
    (``finished_history`` most recent completions, for inspection), not
    an unbounded ledger that would leak one matrix per request in a
    long-running service.
    """

    def __init__(self, config=None, *, backend: str = "auto",
                 device: str | None = None, max_batch: int | None = None,
                 autotune: bool = False, autotune_cache: str | None = None,
                 batch_window_s: float = 0.01,
                 default_timeout_s: float | None = None,
                 max_pending: int = 4096, finished_history: int = 1024,
                 fused_n_max: int | None = None,
                 dc_n_min: int | None = None,
                 faults=None, retry=None, residual_check: bool = False,
                 tracer=None, mesh=None):
        super().__init__(config, backend=backend, device=device,
                         max_batch=max_batch, autotune=autotune,
                         autotune_cache=autotune_cache,
                         fused_n_max=fused_n_max, dc_n_min=dc_n_min,
                         faults=faults, retry=retry,
                         residual_check=residual_check, tracer=tracer,
                         mesh=mesh)
        self.finished = collections.deque(maxlen=int(finished_history))
        self.batch_window_s = float(batch_window_s)
        self.default_timeout_s = default_timeout_s
        self.max_pending = int(max_pending)
        self._cond = threading.Condition()
        self._thread: threading.Thread | None = None
        self._stopping = False

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, req: SVDRequest, *, timeout_s: float | None = None
               ) -> Future:
        """Enqueue one request; returns a future resolving to the completed
        request.  Refusals (stopped engine, full queue, non-square input)
        are delivered through the future too — an open-loop caller never
        has to try/except the submit path itself."""
        fut: Future = Future()
        req.future = fut
        now = time.monotonic()
        req.arrived = now
        t = timeout_s if timeout_s is not None else self.default_timeout_s
        if t is not None and req.deadline is None:
            req.deadline = now + float(t)
        m = req.matrix
        if not (hasattr(m, "ndim") and m.ndim == 2 and m.shape[0] == m.shape[1]):
            self.metrics.add(rejected=1)
            fut.set_exception(ValueError(
                f"SVDRequest.matrix must be square 2-D, got shape "
                f"{getattr(m, 'shape', None)}"))
            return fut
        with self._cond:
            if self._stopping:
                self.metrics.add(rejected=1)
                fut.set_exception(RuntimeError("engine is stopped"))
                return fut
            if self.pending() >= self.max_pending:
                self.metrics.add(rejected=1)
                fut.set_exception(QueueFullError(
                    f"{self.max_pending} requests already pending"))
                return fut
            SVDEngine.submit(self, req)
            if self._thread is None:
                self._start_locked()
            self._cond.notify()
        return fut

    def submit_async(self, req: SVDRequest, *, timeout_s: float | None = None):
        """``await``-able variant: the same future bridged into the calling
        asyncio event loop (``asyncio.wrap_future``)."""
        return asyncio.wrap_future(self.submit(req, timeout_s=timeout_s))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "AsyncSVDEngine":
        """Start the dispatcher now (otherwise the first submit starts it)."""
        with self._cond:
            if self._thread is None and not self._stopping:
                self._start_locked()
        return self

    def stop(self, *, drain: bool = True, timeout: float | None = None) -> None:
        """Stop the dispatcher.  ``drain=True`` (default) serves everything
        still queued first — without the micro-batch wait; ``drain=False``
        fails queued requests with :class:`CancelledError`."""
        cancelled = []
        with self._cond:
            self._stopping = True
            if not drain:
                for key in list(self.buckets):
                    cancelled += self._pop(key, len(self.buckets[key]))
            self._cond.notify_all()
            t = self._thread
        for r in cancelled:                      # futures resolve OUTSIDE
            self._finish(r, error=CancelledError(  # the lock (callbacks!)
                "engine stopped before dispatch"))
        if t is not None:
            t.join(timeout)

    def __enter__(self) -> "AsyncSVDEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _start_locked(self) -> None:
        self._thread = threading.Thread(target=self._worker,
                                        name="AsyncSVDEngine", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # dispatcher
    # ------------------------------------------------------------------

    def _expire_locked(self, now: float) -> list:
        """Dequeue every request whose deadline has already passed; the
        CALLER fails them outside the lock (futures run user callbacks)."""
        expired = []
        for key in list(self.buckets):
            if any(r.deadline is not None and now >= r.deadline
                   for r in self.buckets[key]):
                alive = []
                for r in self._pop(key, len(self.buckets[key])):
                    (expired if r.deadline is not None and now >= r.deadline
                     else alive).append(r)
                if alive:
                    self.buckets[key] = alive + self.buckets.get(key, [])
                    self.metrics.set_queue_depth(self.pending())
        return expired

    def _admit_locked(self, now: float):
        """Pick what to dispatch: ``(key, cfg, reqs, delay, to_fail)``.
        ``reqs`` non-None -> serve now; otherwise sleep ``delay`` until the
        next edge (window expiry or nearest deadline).  ``to_fail`` are
        ``(request, error)`` pairs the caller completes OUTSIDE the lock —
        resolving a future runs arbitrary user callbacks, which must never
        execute while the engine lock is held."""
        to_fail = [(r, TimeoutError(
            f"request {r.uid} expired after "
            f"{now - (r.arrived or now):.3f}s in queue"))
            for r in self._expire_locked(now)]
        cfgs = {}
        for key in list(self.buckets):
            try:
                cfgs[key] = self._cfg_for(key)
            except Exception as exc:             # noqa: BLE001 — per-bucket
                to_fail += [(r, exc)
                            for r in self._pop(key, len(self.buckets[key]))]
        if not self.buckets:
            return None, None, None, None, to_fail
        # Window bound FIRST: when the globally oldest head has waited past
        # batch_window_s, its bucket dispatches even if another bucket is
        # full — a continuously-refilled hot bucket must not starve a lone
        # request elsewhere past the documented latency bound.
        oldest = min(self.buckets,
                     key=lambda k: self.buckets[k][0].arrived or now)
        head = self.buckets[oldest][0]
        ripe_at = (head.arrived or now) + self.batch_window_s
        if self._stopping or now >= ripe_at:
            return (oldest, cfgs[oldest],
                    self._pop(oldest, cfgs[oldest].max_batch), 0.0, to_fail)
        # Fresh traffic: any bucket at capacity dispatches immediately.
        for key in list(self.buckets):
            if len(self.buckets[key]) >= cfgs[key].max_batch:
                return (key, cfgs[key], self._pop(key, cfgs[key].max_batch),
                        0.0, to_fail)
        deadlines = [r.deadline for rs in self.buckets.values() for r in rs
                     if r.deadline is not None]
        wake_at = min([ripe_at] + deadlines)
        return None, None, None, max(wake_at - now, 1e-4), to_fail

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self.buckets and not self._stopping:
                    self._cond.wait()
                if not self.buckets and self._stopping:
                    return
                key, cfg, reqs, delay, to_fail = self._admit_locked(
                    time.monotonic())
                if reqs is None and not to_fail and delay is not None:
                    self._cond.wait(timeout=delay)
                    continue
            # Everything below runs OUTSIDE the lock: admission keeps
            # flowing while a batch is on device, and future callbacks
            # (user code) never execute under the engine lock.
            for r, exc in to_fail:
                self._finish(r, error=exc)
            if reqs:
                # Async queue age (admission -> dispatch) is observed here —
                # the inherited step() path is unused on a started engine.
                now = time.monotonic()
                for r in reqs:
                    if r.arrived is not None:
                        self.metrics.observe_queue_age(now - r.arrived)
                self._serve_batch(key, cfg, reqs)
