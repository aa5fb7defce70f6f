"""The port's serving tier against the reference's
``tests/test_serve_async.py``, on the CPU: admission edges and FIFO/error
regressions of the sync ``SVDEngine``, and the async ``AsyncSVDEngine``
(futures, deadlines, thread safety, queue bounds, the asyncio bridge, the
micro-batch window), and the mesh plumbing: ``shard_pad``,
``serve_mesh``, and both engines dispatching over a mesh of CPU shards
(the reference's mesh cases run on 8 fake XLA devices; a CPU mesh repeats
one device, built by hand).  Every wait is bounded."""

import asyncio
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.tuning import PipelineConfig
from repro_torch.serve import (AsyncSVDEngine, QueueFullError, SVDEngine,
                               SVDRequest)

torch.set_num_threads(2)


def cfg4(max_batch=4):
    return PipelineConfig.resolve(bw=4, tw=2, backend="ref",
                                  dtype=torch.float64, max_batch=max_batch,
                                  device="cpu")


def dense(seed, n=16):
    return np.random.default_rng(seed).standard_normal((n, n))


def check_sigma(req, atol_scale=1e-10):
    s0 = np.linalg.svd(req.matrix, compute_uv=False)
    np.testing.assert_allclose(req.sigma, s0, atol=atol_scale * s0[0])


# ---------------------------------------------------------------------------
# sync engine: admission edges + FIFO/error regressions
# ---------------------------------------------------------------------------

def test_empty_step_is_noop():
    eng = SVDEngine(cfg4())
    assert eng.step() == 0
    assert eng.calls == 0 and eng.finished == []
    assert eng.metrics.snapshot()["batches"] == 0


def test_oversize_bucket_splits_at_max_batch():
    eng = SVDEngine(cfg4(max_batch=4))
    for i in range(10):
        eng.submit(SVDRequest(uid=i, matrix=dense(i), bw=4))
    done = eng.run()
    assert len(done) == 10 and eng.calls == 3          # 4 + 4 + 2
    snap = eng.metrics.snapshot()
    assert snap["served_slots"] == 10 and snap["padded_slots"] == 2
    for r in done:
        check_sigma(r)


def test_fifo_completion_order_within_bucket():
    """Regression: results complete in submission order, across splits."""
    eng = SVDEngine(cfg4(max_batch=4))
    for i in range(9):
        eng.submit(SVDRequest(uid=i, matrix=dense(i), bw=4))
    done = eng.run()
    assert [r.uid for r in done] == list(range(9))


def test_mixed_dtype_requests_never_share_a_bucket():
    eng = SVDEngine(cfg4(max_batch=8))
    for i in range(2):
        eng.submit(SVDRequest(uid=i, matrix=dense(i), bw=4))
    for i in range(2, 4):
        eng.submit(SVDRequest(uid=i, matrix=dense(i).astype(np.float32),
                              bw=4))
    assert len(eng.buckets) == 2                      # dtype splits the key
    done = eng.run()
    assert eng.calls == 2 and len(done) == 4          # one flush per dtype
    for r in done:
        assert r.sigma.dtype == r.matrix.dtype
        check_sigma(r, atol_scale=1e-10 if r.matrix.dtype == np.float64
                    else 1e-5)


def test_per_request_error_surfaces_on_request_not_step():
    """Regression: an un-servable bucket must fail its OWN requests via
    ``req.error`` — never raise out of step()/run() or poison other
    buckets, and never silently drop requests.  The reference's bucket is
    one whose chase window does not fit its fast memory; the port's chase
    block at (4096, tw 2) fits shared memory, so here the bucket is one of
    a dtype the pipeline has no path for (float16)."""
    eng = SVDEngine(cfg4())
    bad = SVDRequest(uid=7, matrix=np.zeros((16, 16), np.float16), bw=4)
    eng.submit(SVDRequest(uid=0, matrix=dense(0), bw=4))
    eng.submit(bad)
    eng.submit(SVDRequest(uid=1, matrix=dense(1), bw=4))
    done = eng.run()
    assert len(done) == 3 and eng.pending() == 0
    assert bad.done and isinstance(bad.error, ValueError)
    assert bad.sigma is None
    good = [r for r in done if r.error is None]
    assert [r.uid for r in good] == [0, 1]            # FIFO kept around error
    for r in good:
        check_sigma(r)
    snap = eng.metrics.snapshot()
    assert snap["completed"] == 2 and snap["failed"] == 1


# ---------------------------------------------------------------------------
# async engine
# ---------------------------------------------------------------------------

def test_async_burst_all_futures_resolve():
    with AsyncSVDEngine(cfg4(), batch_window_s=0.003) as eng:
        futs = [eng.submit(SVDRequest(uid=i, matrix=dense(i), bw=4))
                for i in range(9)]
        done = [f.result(timeout=300) for f in futs]
    for r in done:
        assert r.done and r.error is None
        check_sigma(r)
    snap = eng.metrics.snapshot()
    assert snap["completed"] == 9 and snap["queue_depth"] == 0


def test_async_submit_from_many_threads_exactly_once():
    """Thread-safety + exactly-once delivery: every future resolves with
    its own request, and completion callbacks fire once per future."""
    eng = AsyncSVDEngine(cfg4(), batch_window_s=0.002)
    nthreads, per = 6, 5
    futs = {}
    fired = []
    lock = threading.Lock()

    def client(t):
        for j in range(per):
            uid = t * per + j
            f = eng.submit(SVDRequest(uid=uid, matrix=dense(uid), bw=4))
            f.add_done_callback(lambda _f: fired.append(1))
            with lock:
                futs[uid] = f

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(nthreads)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    assert not any(t.is_alive() for t in threads)
    done = {uid: f.result(timeout=300) for uid, f in futs.items()}
    eng.stop()
    assert len(done) == nthreads * per
    for uid, r in done.items():
        assert r.uid == uid and r.error is None       # own request came back
        check_sigma(r)
    assert len(fired) == nthreads * per               # one callback per future
    snap = eng.metrics.snapshot()
    assert snap["submitted"] == nthreads * per
    assert snap["completed"] == nthreads * per
    assert snap["failed"] == snap["timed_out"] == snap["rejected"] == 0
    assert snap["served_slots"] == nthreads * per


def test_async_deadline_times_out_queued_request():
    eng = AsyncSVDEngine(cfg4(), batch_window_s=30.0)   # never ripe
    fut = eng.submit(SVDRequest(uid=0, matrix=dense(0), bw=4),
                     timeout_s=0.05)
    with pytest.raises(TimeoutError):
        fut.result(timeout=60)
    eng.stop()
    req_done = eng.finished[0]
    assert isinstance(req_done.error, TimeoutError) and req_done.done
    snap = eng.metrics.snapshot()
    assert snap["timed_out"] == 1 and snap["completed"] == 0
    assert snap["failed"] == 0                          # timeout != failure


def test_async_queue_full_rejects_at_admission():
    eng = AsyncSVDEngine(cfg4(max_batch=8), batch_window_s=30.0,
                         max_pending=2)
    f1 = eng.submit(SVDRequest(uid=0, matrix=dense(0), bw=4))
    f2 = eng.submit(SVDRequest(uid=1, matrix=dense(1), bw=4))
    f3 = eng.submit(SVDRequest(uid=2, matrix=dense(2), bw=4))
    with pytest.raises(QueueFullError):
        f3.result(timeout=60)
    eng.stop(drain=True)                                # serves the queue
    assert f1.result(timeout=60).error is None
    assert f2.result(timeout=60).error is None
    assert eng.metrics.snapshot()["rejected"] == 1


def test_async_nonsquare_rejected_via_future():
    eng = AsyncSVDEngine(cfg4())
    fut = eng.submit(SVDRequest(uid=0, matrix=np.zeros((4, 6)), bw=2))
    with pytest.raises(ValueError, match="square"):
        fut.result(timeout=60)
    eng.stop()


def test_async_stop_without_drain_cancels_pending():
    eng = AsyncSVDEngine(cfg4(), batch_window_s=30.0)
    fut = eng.submit(SVDRequest(uid=0, matrix=dense(0), bw=4))
    eng.stop(drain=False)
    with pytest.raises(Exception):                      # CancelledError
        fut.result(timeout=60)
    f2 = eng.submit(SVDRequest(uid=1, matrix=dense(1), bw=4))
    with pytest.raises(RuntimeError, match="stopped"):
        f2.result(timeout=60)


def test_async_asyncio_bridge():
    async def drive():
        with AsyncSVDEngine(cfg4(), batch_window_s=0.002) as eng:
            aws = [eng.submit_async(SVDRequest(uid=i, matrix=dense(i), bw=4))
                   for i in range(5)]
            return await asyncio.wait_for(asyncio.gather(*aws), 300)

    done = asyncio.run(drive())
    assert len(done) == 5
    for r in done:
        check_sigma(r)


def test_async_window_expired_bucket_beats_full_bucket():
    """Fairness: a request past its batch_window_s dispatches before a
    continuously-full hot bucket — the window is a latency BOUND, not a
    hint (no worker started: _admit_locked is exercised directly)."""
    eng = AsyncSVDEngine(cfg4(max_batch=4), batch_window_s=0.2)
    now = time.monotonic()
    lone = SVDRequest(uid=99, matrix=dense(99, n=24), bw=4)
    lone.arrived = now - 1.0                    # long past the window
    SVDEngine.submit(eng, lone)
    for i in range(4):                          # hot bucket at capacity
        r = SVDRequest(uid=i, matrix=dense(i), bw=4)
        r.arrived = now
        SVDEngine.submit(eng, r)
    key, _cfg, reqs, _delay, to_fail = eng._admit_locked(now)
    assert reqs is not None and [r.uid for r in reqs] == [99], (key, reqs)
    assert not to_fail


def test_async_micro_batch_window_aggregates():
    """Requests trickling in faster than the window flushes co-batch: far
    fewer pipeline calls than requests."""
    eng = AsyncSVDEngine(cfg4(max_batch=8), batch_window_s=0.25)
    futs = []
    for i in range(8):
        futs.append(eng.submit(SVDRequest(uid=i, matrix=dense(i), bw=4)))
        time.sleep(0.005)
    [f.result(timeout=300) for f in futs]
    eng.stop()
    snap = eng.metrics.snapshot()
    assert snap["batches"] <= 3                         # not 8 serial calls
    assert snap["batch_fill_ratio"] >= 0.3


def test_async_many_threads_stress_no_lost_update():
    """More submitting threads than cores and a short switch interval: every
    request is counted once and completes once (a lost update in the
    engine's bucket or counter bookkeeping would break the totals)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng = AsyncSVDEngine(cfg4(max_batch=8), batch_window_s=0.002)
        nthreads, per = 12, 3
        futs, lock = [], threading.Lock()

        def client(t):
            for j in range(per):
                uid = t * per + j
                f = eng.submit(SVDRequest(uid=uid, matrix=dense(uid % 5),
                                          bw=4))
                with lock:
                    futs.append(f)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(nthreads)]
        [t.start() for t in threads]
        [t.join(timeout=60) for t in threads]
        assert not any(t.is_alive() for t in threads)
        done = [f.result(timeout=300) for f in futs]
        eng.stop(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert sorted(r.uid for r in done) == list(range(nthreads * per))
    snap = eng.metrics.snapshot()
    assert snap["submitted"] == snap["completed"] == nthreads * per
    assert snap["served_slots"] == nthreads * per
    assert snap["queue_depth"] == 0 and eng.pending() == 0


# ---------------------------------------------------------------------------
# mesh plumbing
# ---------------------------------------------------------------------------

def test_shard_pad():
    from repro_torch.core.distributed import shard_pad
    assert shard_pad(8, 4) == 0
    assert shard_pad(9, 4) == 3
    assert shard_pad(1, 8) == 7
    assert shard_pad(5, 1) == 0


def test_serve_mesh_unset_or_single_device_is_none(monkeypatch):
    from repro_torch.launch.mesh import serve_mesh
    monkeypatch.delenv("REPRO_SERVE_MESH", raising=False)
    assert serve_mesh() is None
    monkeypatch.setenv("REPRO_SERVE_MESH", "1")
    assert serve_mesh() is None
    monkeypatch.setenv("REPRO_SERVE_MESH", "")
    assert serve_mesh() is None


def test_async_sharded_dispatch_on_a_cpu_mesh():
    """Full buckets split over 4 CPU shards: results match the oracle and,
    bit for bit, an engine without a mesh; padding to shard divisibility
    is sliced off; the metrics record the mesh path."""
    from repro_torch.launch.mesh import DeviceMesh
    mesh = DeviceMesh(["cpu"] * 4)
    mats = [dense(i) for i in range(6)]
    # 6 requests -> pad 2 for 4 shards
    with AsyncSVDEngine(cfg4(max_batch=6), mesh=mesh,
                        batch_window_s=0.005) as eng:
        futs = [eng.submit(SVDRequest(uid=i, matrix=m, bw=4))
                for i, m in enumerate(mats)]
        done = [f.result(timeout=300) for f in futs]
    for r in done:
        check_sigma(r)
    snap = eng.metrics.snapshot()
    assert snap["sharded_batches"] >= 1
    assert snap["sharded_batches"] == snap["batches"]
    plain = SVDEngine(cfg4(max_batch=6))
    for i, m in enumerate(mats):
        plain.submit(SVDRequest(uid=i, matrix=m, bw=4))
    ref = {r.uid: r.sigma for r in plain.run()}
    for r in done:
        assert np.array_equal(r.sigma, ref[r.uid])
    with pytest.raises(ValueError, match="device type"):
        SVDEngine(cfg4(), mesh=DeviceMesh(["cuda:0", "cuda:1"]))
