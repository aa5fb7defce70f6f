"""Serve router across processes: the front end of the SVD serving fabric,
after the reference's ``serve/router.py``.

:class:`SVDRouter` owns ADMISSION for a fleet of worker hosts
(``serve/worker.py``, each wrapping one
:class:`~repro_torch.serve.AsyncSVDEngine`): clients call
``submit() -> Future`` exactly as on the single-host engine, and the
router shards traffic across hosts by *bucket key* — rendezvous
(highest-random-weight) hashing of ``sha256(f"{host}|{bucket_key_str(key)}")``
pins every ``(n, bw, dtype, banded, compute_uv)`` key to one owner host,
the one the reference's router picks for the same host ids, so a bucket's
traffic keeps aggregating in one engine's micro-batch window instead of
being diluted round-robin across the fleet.  Ownership is recomputed over
the *alive* set only, so a host drop moves each orphaned bucket wholesale
to one survivor and every other bucket stays put.

Host-drop handling is the single-host fault ladder lifted one level:

* **Detection** — each worker connection has a dedicated reader thread
  (a broken socket is an immediate drop signal) plus a heartbeat
  ping/pong with a staleness bound (a hung-but-connected worker is a
  drop too).  A seeded :class:`~repro_torch.serve.faults.FaultPlan` with
  ``host_loss_rate``/``host_loss_at`` injects drops deterministically at
  heartbeat ticks.
* **Quarantine** — dead hosts go through a
  :class:`~repro_torch.serve.faults.BucketQuarantine` keyed by host id
  (``threshold=1``: one detected death trips immediately; a reconnect
  under the same host id is the HALF-OPEN recovery).
* **Requeue** — the dropped host's in-flight requests are re-dispatched
  to the surviving owners through the same future plumbing; every
  client future resolves EXACTLY once (a global in-flight table popped
  under the router lock makes late duplicate results unresolvable), and
  the retries are attributed to the surviving host in the metrics.

Observability across hosts: the router keeps the fleet-level
:class:`~repro_torch.serve.ServeMetrics` (client-view counters, per-host
dispatch/completion/requeue attribution via ``add_host``, and per-host
client-view latency histograms whose
:meth:`~repro_torch.obs.StreamingHistogram.merged` is the fleet
histogram); workers ship their own engine snapshots and histograms over
``stats`` frames.

The router itself never touches a device — all compute lives in the
workers; it runs in a process with no card.  A request's matrix may be a
numpy array or a tensor; it goes on the wire from host memory.
"""

from __future__ import annotations

import copy
import hashlib
import itertools
import threading
import time
from concurrent.futures import CancelledError, Future

from repro_torch.obs.hist import StreamingHistogram
from repro_torch.serve.async_engine import QueueFullError
from repro_torch.serve.faults import BucketQuarantine
from repro_torch.serve.metrics import ServeMetrics, bucket_key_str
from repro_torch.serve.wire import WireClosed, recv_msg, send_msg

__all__ = ["SVDRouter", "HostDownError"]


class HostDownError(ConnectionError):
    """A dispatch raced a host death (internal: always requeued, never
    surfaced to a client while any host survives)."""


class _Host:
    __slots__ = ("host_id", "sock", "send_lock", "alive", "last_seen",
                 "info", "pending_hint", "health", "reader", "stats")

    def __init__(self, host_id: str, sock, info: dict):
        self.host_id = host_id
        self.sock = sock
        self.send_lock = threading.Lock()
        self.alive = True
        self.last_seen = time.monotonic()
        self.info = info                      # hello payload (pid, devices…)
        self.pending_hint = 0                 # from the latest pong
        self.health = "unknown"
        self.reader: threading.Thread | None = None
        self.stats: dict | None = None        # latest stats_res payload


class _Pending:
    __slots__ = ("rid", "req", "future", "deadline", "host", "arrived",
                 "requeues", "resolved")

    def __init__(self, rid: int, req, future: Future,
                 deadline: float | None):
        self.rid = rid
        self.req = req
        self.future = future
        self.deadline = deadline
        self.host: str | None = None
        self.arrived = time.monotonic()
        self.requeues = 0
        self.resolved = False


class SVDRouter:
    """Admission front end sharding shape-buckets across worker hosts.

    >>> router = SVDRouter()
    >>> procs = [spawn_worker_process(router.address, f"w{i}")
    ...          for i in range(2)]
    >>> router.wait_for_hosts(2)
    >>> sigma = router.submit(SVDRequest(uid=0, matrix=a, bw=8)).result().sigma

    Admission mirrors :class:`~repro_torch.serve.AsyncSVDEngine.submit`
    exactly — refusals (stopped router, ``max_pending`` exceeded,
    non-square input) resolve the returned future, never raise — so the
    a client's accounting works unchanged against either tier.  ``heartbeat_s``/``heartbeat_timeout_s`` bound drop-detection
    latency; ``faults`` injects host loss (heartbeat-tick granularity).
    """

    def __init__(self, *, listen=("127.0.0.1", 0),
                 default_timeout_s: float | None = None,
                 max_pending: int = 4096,
                 heartbeat_s: float = 0.25,
                 heartbeat_timeout_s: float = 3.0,
                 faults=None, metrics: ServeMetrics | None = None):
        import socket
        self.default_timeout_s = default_timeout_s
        self.max_pending = int(max_pending)
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.faults = faults
        self.metrics = metrics if metrics is not None else ServeMetrics()
        # Host-granularity circuit breaker (the engines' breaker, per host):
        # threshold=1 — one detected death is definitive, unlike a flaky
        # bucket dispatch; cooldown only gates how soon a same-id
        # reconnect is trusted again.
        self.quarantine = BucketQuarantine(
            threshold=1, cooldown_s=self.heartbeat_timeout_s)
        self._lock = threading.RLock()
        self._host_seen = threading.Condition(self._lock)
        self._hosts: dict[str, _Host] = {}
        self._inflight: dict[int, _Pending] = {}
        self._unrouted: list[_Pending] = []
        self._host_lat: dict[str, StreamingHistogram] = {}
        self._seen_keys: set = set()
        self._rid = itertools.count(1)
        self._stats_waits: dict[int, tuple[threading.Event, dict]] = {}
        self._stats_token = itertools.count(1)
        self._stopping = False
        self._listener = socket.create_server(listen)
        self.address = self._listener.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="SVDRouter-accept", daemon=True)
        self._accept_thread.start()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="SVDRouter-heartbeat",
            daemon=True)
        self._hb_thread.start()

    # ------------------------------------------------------------------
    # topology
    # ------------------------------------------------------------------

    def alive_hosts(self) -> list[str]:
        with self._lock:
            return sorted(h for h, st in self._hosts.items() if st.alive)

    def wait_for_hosts(self, n: int, timeout: float = 60.0) -> bool:
        """Block until ``n`` hosts are alive (True) or ``timeout`` (False)."""
        deadline = time.monotonic() + timeout
        with self._host_seen:
            while len([h for h in self._hosts.values() if h.alive]) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._host_seen.wait(timeout=left)
        return True

    def owner_of(self, key) -> str | None:
        """The alive host owning ``key`` under rendezvous hashing (stable:
        removing a host only moves THAT host's buckets)."""
        with self._lock:
            return self._owner_locked(key)

    def _owner_locked(self, key) -> str | None:
        kstr = bucket_key_str(key)
        best, best_w = None, b""
        for hid, st in self._hosts.items():
            if not st.alive:
                continue
            w = hashlib.sha256(f"{hid}|{kstr}".encode()).digest()
            if best is None or w > best_w:
                best, best_w = hid, w
        return best

    # ------------------------------------------------------------------
    # admission (mirrors AsyncSVDEngine.submit)
    # ------------------------------------------------------------------

    def submit(self, req, *, timeout_s: float | None = None) -> Future:
        """Enqueue one request fleet-wide; returns a future resolving to
        the completed request.  Refusals resolve the future, never raise."""
        fut: Future = Future()
        req.future = fut
        now = time.monotonic()
        req.arrived = now
        t = timeout_s if timeout_s is not None else self.default_timeout_s
        if t is not None and req.deadline is None:
            req.deadline = now + float(t)
        m = req.matrix
        if not (hasattr(m, "ndim") and m.ndim == 2
                and m.shape[0] == m.shape[1]):
            self.metrics.add(rejected=1)
            fut.set_exception(ValueError(
                f"SVDRequest.matrix must be square 2-D, got shape "
                f"{getattr(m, 'shape', None)}"))
            return fut
        with self._lock:
            if self._stopping:
                self.metrics.add(rejected=1)
                fut.set_exception(RuntimeError("router is stopped"))
                return fut
            if len(self._inflight) + len(self._unrouted) >= self.max_pending:
                self.metrics.add(rejected=1)
                fut.set_exception(QueueFullError(
                    f"{self.max_pending} requests already pending "
                    f"fleet-wide"))
                return fut
            key = req.key()
            self.metrics.add(submitted=1,
                             bucket_hits=int(key in self._seen_keys))
            self._seen_keys.add(key)
            p = _Pending(next(self._rid), req, fut, req.deadline)
            host = self._owner_locked(key)
            if host is None:
                self._unrouted.append(p)     # no host yet: parked, the
                return fut                   # heartbeat loop re-routes
            self._inflight[p.rid] = p
            p.host = host
        self._forward(p, host)
        return fut

    def submit_to(self, host_id: str, req, *,
                  timeout_s: float | None = None) -> Future:
        """Pin one request to a specific host, bypassing rendezvous
        routing — used by :meth:`warm` to warm every bucket on every host
        (so a post-drop requeue never pays a kernel build under a
        deadline) and by tests."""
        fut: Future = Future()
        req.future = fut
        req.arrived = time.monotonic()
        if timeout_s is not None and req.deadline is None:
            req.deadline = req.arrived + float(timeout_s)
        with self._lock:
            if self._stopping or host_id not in self._hosts \
                    or not self._hosts[host_id].alive:
                fut.set_exception(RuntimeError(
                    f"host {host_id!r} is not alive"))
                return fut
            self._seen_keys.add(req.key())
            p = _Pending(next(self._rid), req, fut, req.deadline)
            self._inflight[p.rid] = p
            p.host = host_id
        self._forward(p, host_id)
        return fut

    def warm(self, reqs, timeout: float = 300.0) -> None:
        """Broadcast ``reqs`` (one per bucket key, e.g. the load
        harness's mix cover) to EVERY alive host and wait: each host
        warms each bucket exactly once, outside any deadline."""
        futs = []
        for hid in self.alive_hosts():
            for r in reqs:
                futs.append(self.submit_to(hid, copy.copy(r)))
        for f in futs:
            f.result(timeout=timeout)

    # ------------------------------------------------------------------
    # dispatch / completion
    # ------------------------------------------------------------------

    def _forward(self, p: _Pending, host_id: str) -> None:
        """Send one request frame to ``host_id``; a send failure is a
        host-down signal, and the request rides the requeue path."""
        with self._lock:
            st = self._hosts.get(host_id)
        req = p.req
        header = {"type": "req", "rid": p.rid, "uid": req.uid,
                  "bw": req.bw, "banded": req.banded,
                  "compute_uv": req.compute_uv}
        if p.deadline is not None:
            remaining = p.deadline - time.monotonic()
            if remaining <= 0:
                if self._pop_pending(p.rid) is not None:
                    self._resolve_error(p, TimeoutError(
                        f"request {req.uid} expired before dispatch"))
                return
            header["timeout_s"] = remaining
        ok = st is not None and st.alive
        if ok:
            try:
                with st.send_lock:
                    send_msg(st.sock, header, {"matrix": req.matrix})
            except (OSError, WireClosed):
                ok = False
        if ok:
            self.metrics.add_host(host_id, dispatched=1)
        else:
            self._host_down(host_id, "send failed")

    def _pop_pending(self, rid: int) -> _Pending | None:
        """Claim one in-flight entry — the exactly-once gate: whichever
        of result-arrival and host-drop-requeue pops the rid first owns
        the request; the loser finds nothing and drops its copy."""
        with self._lock:
            return self._inflight.pop(rid, None)

    def _on_result(self, host_id: str, header: dict, arrays: dict) -> None:
        p = self._pop_pending(int(header["rid"]))
        if p is None:
            return                            # late duplicate: requeued
        req = p.req
        if header.get("ok"):
            req.sigma = arrays.get("sigma")
            if req.compute_uv:
                req.u, req.vt = arrays.get("u"), arrays.get("vt")
            now = time.monotonic()
            if p.deadline is not None and now > p.deadline:
                self._resolve_error(p, TimeoutError(
                    f"request {req.uid} completed after its deadline; "
                    f"late results remain on the request"))
                return
            req.done = True
            self.metrics.add(completed=1)
            self.metrics.add_host(host_id, completed=1)
            lat = now - p.arrived
            tier = header.get("tier") or "unknown"
            self.metrics.observe_latency(tier, req.key(), lat)
            with self._lock:
                h = self._host_lat.setdefault(host_id, StreamingHistogram())
            h.add(lat)
            try:
                p.future.set_result(req)
            except Exception:                # noqa: BLE001 — cancelled
                pass
            return
        # Worker-side refusal/failure past its own fault ladder.
        etype = header.get("error_type", "")
        msg = f"[host {host_id}] {header.get('error', 'unknown error')}"
        exc: Exception
        if etype == "TimeoutError":
            exc = TimeoutError(msg)
        elif etype == "QueueFullError":
            exc = QueueFullError(msg)
        else:
            exc = RuntimeError(f"{etype}: {msg}" if etype else msg)
        self.metrics.add_host(host_id, failed=1)
        self._resolve_error(p, exc)

    def _resolve_error(self, p: _Pending, exc: Exception) -> None:
        p.req.error = exc
        p.req.done = True
        if isinstance(exc, TimeoutError):
            self.metrics.add(timed_out=1)
        else:
            self.metrics.add(failed=1)
        try:
            p.future.set_exception(exc)
        except Exception:                    # noqa: BLE001 — cancelled
            pass

    # ------------------------------------------------------------------
    # host lifecycle
    # ------------------------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return                       # listener closed by stop()
            threading.Thread(target=self._handshake, args=(sock,),
                             name="SVDRouter-handshake", daemon=True).start()

    def _handshake(self, sock) -> None:
        try:
            header, _ = recv_msg(sock)
        except WireClosed:
            sock.close()
            return
        if header.get("type") != "hello" or "host_id" not in header:
            sock.close()
            return
        hid = str(header["host_id"])
        st = _Host(hid, sock, {k: v for k, v in header.items()
                               if k not in ("type", "host_id")})
        with self._host_seen:
            old = self._hosts.get(hid)
            if old is not None and old.alive:
                old.alive = False            # same-id replacement wins
                try:
                    old.sock.close()
                except OSError:
                    pass
            self._hosts[hid] = st
            # A reconnect under a quarantined id is the HALF-OPEN
            # recovery trial succeeding (the breaker's semantics per host).
            if self.quarantine.record_success(hid):
                self.metrics.set_bucket_quarantined(f"host:{hid}", False)
            self._host_seen.notify_all()
        st.reader = threading.Thread(
            target=self._reader_loop, args=(st,),
            name=f"SVDRouter-reader-{hid}", daemon=True)
        st.reader.start()
        self._drain_unrouted()

    def _reader_loop(self, st: _Host) -> None:
        while True:
            try:
                header, arrays = recv_msg(st.sock)
            except WireClosed:
                if st.alive:
                    self._host_down(st.host_id, "connection lost")
                return
            t = header.get("type")
            if t == "res":
                self._on_result(st.host_id, header, arrays)
            elif t == "pong":
                with self._lock:
                    st.last_seen = time.monotonic()
                    st.pending_hint = int(header.get("pending", 0))
                    st.health = header.get("health", "unknown")
            elif t == "stats_res":
                with self._lock:
                    st.stats = header
                    wait = self._stats_waits.get(int(header.get("token", 0)))
                if wait is not None:
                    ev, out = wait
                    out[st.host_id] = header
                    ev.set()

    def _host_down(self, host_id: str, reason: str) -> None:
        """Quarantine a dead host and requeue its in-flight requests to
        the surviving owners — zero client-visible failures while any
        host survives."""
        with self._lock:
            st = self._hosts.get(host_id)
            if st is None or not st.alive:
                return                       # already handled
            st.alive = False
            orphans = [p for p in self._inflight.values()
                       if p.host == host_id]
            for p in orphans:
                del self._inflight[p.rid]
        try:
            st.sock.close()                  # wakes the reader thread too
        except OSError:
            pass
        if self.quarantine.record_failure(host_id):
            self.metrics.add(quarantined=1)
            self.metrics.set_bucket_quarantined(f"host:{host_id}", True)
        self.metrics.set_bucket_error(
            f"host:{host_id}", HostDownError(reason))
        for p in orphans:
            self._requeue(p)

    def _requeue(self, p: _Pending) -> None:
        """Re-dispatch one orphaned request under a FRESH rid (the old
        rid is gone from the in-flight table, so a late result from the
        dead host can never double-resolve the future)."""
        if p.deadline is not None and time.monotonic() >= p.deadline:
            self._resolve_error(p, TimeoutError(
                f"request {p.req.uid} expired while host "
                f"{p.host!r} was being replaced"))
            return
        with self._lock:
            host = self._owner_locked(p.req.key())
            if host is None:
                p.host = None
                self._unrouted.append(p)     # whole fleet down: parked
                return
            p.rid = next(self._rid)
            p.requeues += 1
            p.host = host
            self._inflight[p.rid] = p
        # Retry attribution (the engines' taxonomy at fleet scope): the requeue is
        # counted on the SURVIVING host that absorbs the work.
        self.metrics.add(retried=1)
        self.metrics.add_host(host, requeued=1)
        self._forward(p, host)

    def _drain_unrouted(self) -> None:
        with self._lock:
            parked, self._unrouted = self._unrouted, []
        for p in parked:
            with self._lock:
                host = self._owner_locked(p.req.key())
                if host is None:
                    self._unrouted.append(p)
                    continue
                p.rid = next(self._rid)
                p.host = host
                self._inflight[p.rid] = p
            self._forward(p, host)

    def _heartbeat_loop(self) -> None:
        seq = 0
        while not self._stopping:
            time.sleep(self.heartbeat_s)
            if self._stopping:
                return
            seq += 1
            self._heartbeat_tick(seq)

    def _heartbeat_tick(self, seq: int = 0) -> None:
        """One heartbeat round: fault consultation, staleness detection,
        pings, parked-request expiry.  Split from the loop so tests can
        fire a deterministic tick without racing wall-clock sleeps."""
        now = time.monotonic()
        with self._lock:
            alive = [(hid, st) for hid, st in self._hosts.items()
                     if st.alive]
        if self.faults is not None and alive:
            victim = self.faults.lose_host([hid for hid, _ in alive])
            if victim is not None:
                self._host_down(victim, "injected host loss")
                with self._lock:
                    alive = [(h, s) for h, s in alive if s.alive]
        for hid, st in alive:
            if now - st.last_seen > self.heartbeat_timeout_s:
                self._host_down(hid, "heartbeat timeout")
                continue
            try:
                with st.send_lock:
                    send_msg(st.sock, {"type": "ping", "seq": seq})
            except (OSError, WireClosed):
                self._host_down(hid, "ping send failed")
        # Expire parked requests whose deadline passed while no host
        # could take them; re-route the rest if hosts (re)appeared.
        with self._lock:
            expired = [p for p in self._unrouted
                       if p.deadline is not None and now >= p.deadline]
            self._unrouted = [p for p in self._unrouted
                              if p not in expired]
        for p in expired:
            self._resolve_error(p, TimeoutError(
                f"request {p.req.uid} expired with no host available"))
        if self.alive_hosts():
            self._drain_unrouted()

    # ------------------------------------------------------------------
    # observability across hosts
    # ------------------------------------------------------------------

    def collect_host_stats(self, timeout: float = 10.0) -> dict:
        """Request each alive worker's full engine snapshot + histogram
        dicts (``stats`` frames); returns ``{host_id: payload}`` for the
        hosts that answered in time."""
        token = next(self._stats_token)
        ev = threading.Event()
        out: dict[str, dict] = {}
        with self._lock:
            alive = [(hid, st) for hid, st in self._hosts.items()
                     if st.alive]
            self._stats_waits[token] = (ev, out)
        try:
            for _hid, st in alive:
                try:
                    with st.send_lock:
                        send_msg(st.sock, {"type": "stats", "token": token})
                except (OSError, WireClosed):
                    pass
            deadline = time.monotonic() + timeout
            while len(out) < len(alive) and time.monotonic() < deadline:
                ev.wait(timeout=0.05)
                ev.clear()
        finally:
            with self._lock:
                self._stats_waits.pop(token, None)
        return dict(out)

    def host_latency_histograms(self) -> dict[str, StreamingHistogram]:
        """Per-host client-view latency histograms (router-observed)."""
        with self._lock:
            return dict(self._host_lat)

    def reset_stats(self) -> None:
        """Fresh counters + latency histograms.  Harness hook: measure the
        timed window, not the warm-up (mirrors the engines'
        ``eng.metrics = ServeMetrics()`` reset).  Quarantine state is NOT
        reset — an unhealthy host stays unhealthy across the boundary."""
        with self._lock:
            self.metrics = ServeMetrics()
            self._host_lat = {}

    def fleet(self) -> dict:
        """The fleet-level view: router counters, per-host status +
        attribution, and the per-host/merged latency histograms (the
        cross-host ``merge()`` invariant: the merged histogram's counts
        are exactly the sum of the per-host counts, so its percentiles
        stay within one log-bucket width of the pooled exact samples)."""
        snap = self.metrics.snapshot()
        now = time.monotonic()
        with self._lock:
            hosts = {
                hid: {"alive": st.alive,
                      "last_seen_age_s": now - st.last_seen,
                      "pending_hint": st.pending_hint,
                      "health": st.health, **st.info,
                      **snap.get("hosts", {}).get(hid, {})}
                for hid, st in self._hosts.items()}
            lat = dict(self._host_lat)
        merged = StreamingHistogram.merged(lat.values())
        return {
            "alive_hosts": sorted(h for h, v in hosts.items() if v["alive"]),
            "dead_hosts": sorted(h for h, v in hosts.items()
                                 if not v["alive"]),
            "hosts": hosts,
            "router": snap,
            "latency": {
                "per_host": {h: hh.to_dict() for h, hh in lat.items()},
                "per_host_summary": {h: hh.summary()
                                     for h, hh in lat.items()},
                "merged": merged.to_dict(),
                "merged_summary": merged.summary(),
                "bucket_ratio": merged.bucket_width_ratio(),
            },
        }

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return len(self._inflight) + len(self._unrouted)

    def stop(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the fleet: optionally wait for in-flight work, tell every
        worker to drain-and-exit, fail whatever is left with
        :class:`CancelledError`, and close the fabric."""
        with self._lock:
            self._stopping = True
        if drain:
            deadline = time.monotonic() + timeout
            while self.pending() and time.monotonic() < deadline:
                time.sleep(0.01)
        with self._lock:
            leftovers = list(self._inflight.values()) + self._unrouted
            self._inflight.clear()
            self._unrouted = []
            hosts = list(self._hosts.values())
        for p in leftovers:
            self._resolve_error(p, CancelledError(
                "router stopped before completion"))
        for st in hosts:
            if st.alive:
                try:
                    with st.send_lock:
                        send_msg(st.sock, {"type": "stop"})
                except (OSError, WireClosed):
                    pass
        try:
            self._listener.close()
        except OSError:
            pass
        for st in hosts:
            try:
                st.sock.close()
            except OSError:
                pass
