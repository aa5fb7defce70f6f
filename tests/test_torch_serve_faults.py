"""The port's fault tolerance against the reference's
``tests/test_serve_faults.py``, on the CPU: the FaultPlan / RetryPolicy /
BucketQuarantine primitives (and that the port's FaultPlan injects the
reference's faults at the same ordinals), the numerical guards of
``core.svd``, the engines' retry / degrade / quarantine ladder, and the
sharded dispatch's shard-loss re-dispatch (bit for bit the clean run) on a
mesh of CPU shards built by hand."""

import time

import numpy as np
import pytest
import torch

from repro_torch.core import svd as svdmod
from repro_torch.core.svd import NumericalFault
from repro_torch.core.tuning import PipelineConfig
from repro_torch.serve import (AsyncSVDEngine, BucketQuarantine, FaultPlan,
                               InjectedDispatchError, RetryPolicy, SVDEngine,
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


FAST = RetryPolicy(backoff_base_s=1e-4, backoff_max_s=1e-3)


# ---------------------------------------------------------------------------
# FaultPlan: determinism, scripting, budget
# ---------------------------------------------------------------------------

def test_fault_plan_deterministic_across_instances():
    """Same seed + knobs -> the i-th hook call injects the same fault (and
    corrupts the same sigma entry) on every instantiation."""
    def drive(plan):
        events = []
        for i in range(40):
            try:
                plan.before_dispatch(key=("k", i))
                events.append("ok")
            except InjectedDispatchError:
                events.append("err")
            sig = plan.corrupt_sigma(np.linspace(9.0, 1.0, 5))
            events.append(tuple(np.where(~np.isfinite(sig))[0]))
        return events, plan.snapshot()

    def mk():
        return FaultPlan(seed=7, dispatch_error_rate=0.3, nan_rate=0.25,
                         inf_rate=0.1)

    ev1, snap1 = drive(mk())
    ev2, snap2 = drive(mk())
    assert ev1 == ev2 and snap1 == snap2
    assert snap1["dispatch_error"] > 0 and snap1["nan"] + snap1["inf"] > 0


def test_fault_plan_scripted_ordinals_fire_regardless_of_rates():
    plan = FaultPlan(seed=0, dispatch_errors_at=(2,), nan_at=(1,))
    plan.before_dispatch()                        # ordinal 0: clean
    plan.before_dispatch()                        # ordinal 1: clean
    with pytest.raises(InjectedDispatchError, match="dispatch 2"):
        plan.before_dispatch()                    # ordinal 2: scripted
    s0 = plan.corrupt_sigma(np.array([3.0, 2.0, 1.0]))
    assert np.isfinite(s0).all()                  # result ordinal 0: clean
    s1 = plan.corrupt_sigma(np.array([3.0, 2.0, 1.0]))
    assert np.isnan(s1).sum() == 1                # result ordinal 1: scripted
    assert plan.snapshot()["nan"] == 1


def test_fault_plan_max_faults_budget():
    plan = FaultPlan(seed=0, dispatch_error_rate=1.0, max_faults=2)
    for _ in range(2):
        with pytest.raises(InjectedDispatchError):
            plan.before_dispatch()
    for _ in range(5):                            # budget exhausted: clean
        plan.before_dispatch()
    assert plan.snapshot()["dispatch_error"] == 2


def test_fault_plan_corrupt_never_mutates_input():
    plan = FaultPlan(seed=0, nan_rate=1.0)
    sig = np.array([3.0, 2.0, 1.0])
    out = plan.corrupt_sigma(sig)
    assert np.isfinite(sig).all() and np.isnan(out).sum() == 1


# ---------------------------------------------------------------------------
# RetryPolicy + BucketQuarantine state machines
# ---------------------------------------------------------------------------

def test_retry_policy_backoff_caps_and_respects_deadline():
    pol = RetryPolicy(backoff_base_s=0.01, backoff_factor=4.0,
                      backoff_max_s=0.05)
    assert pol.backoff_for(1, deadline=None, now=0.0) == 0.01
    assert pol.backoff_for(2, deadline=None, now=0.0) == 0.04
    assert pol.backoff_for(3, deadline=None, now=0.0) == 0.05   # capped
    # Deadline-aware: a sleep landing at/past the deadline is refused.
    assert pol.backoff_for(1, deadline=100.02, now=100.0) == 0.01
    assert pol.backoff_for(2, deadline=100.02, now=100.0) is None


def test_retry_policy_numerical_faults_get_fewer_attempts():
    pol = RetryPolicy(max_attempts=4, numerical_max_attempts=2)
    assert pol.attempts_for(RuntimeError("x")) == 4
    assert pol.attempts_for(NumericalFault("nan sigma")) == 2


def test_quarantine_trip_cooldown_halfopen_recover():
    t = [0.0]
    q = BucketQuarantine(threshold=3, cooldown_s=10.0, clock=lambda: t[0])
    key = ("bucket",)
    assert not q.record_failure(key) and not q.record_failure(key)
    assert not q.active(key)
    assert q.record_failure(key)                  # third failure: trips OPEN
    assert q.active(key) and q.open_keys() == [key]
    t[0] = 5.0
    assert q.active(key)                          # still cooling down
    t[0] = 11.0
    assert not q.active(key)                      # HALF-OPEN: one trial flows
    assert not q.record_failure(key)              # trial failed: re-arm, not
    assert q.active(key)                          # a "new" trip
    t[0] = 22.0
    assert not q.active(key)
    assert q.record_success(key)                  # trial succeeded: recovered
    assert not q.active(key) and q.open_keys() == []
    assert not q.record_success(key)              # already CLOSED


def test_quarantine_success_resets_consecutive_count():
    q = BucketQuarantine(threshold=3, cooldown_s=10.0)
    key = "k"
    q.record_failure(key)
    q.record_failure(key)
    q.record_success(key)                         # streak broken
    assert not q.record_failure(key)              # 1, not 3
    assert not q.active(key)


# ---------------------------------------------------------------------------
# numerical-health guards (core.svd)
# ---------------------------------------------------------------------------

def test_validate_sigma_accepts_clean_rejects_poisoned():
    good = np.array([[5.0, 3.0, 1.0, 0.0]])
    svdmod.validate_sigma(good)                   # no raise
    with pytest.raises(NumericalFault, match="non-finite"):
        svdmod.validate_sigma(np.array([5.0, np.nan, 1.0]))
    with pytest.raises(NumericalFault, match="non-finite"):
        svdmod.validate_sigma(np.array([np.inf, 3.0, 1.0]))
    with pytest.raises(NumericalFault, match="negative"):
        svdmod.validate_sigma(np.array([5.0, 3.0, -1.0]))
    with pytest.raises(NumericalFault, match="descending"):
        svdmod.validate_sigma(np.array([3.0, 5.0, 1.0]))
    # tolerance slack: tiny negative / tiny inversions are rounding, not rot
    eps = np.finfo(np.float64).eps
    svdmod.validate_sigma(np.array([5.0, 3.0, -eps]))


def test_svd_check_flag_passes_clean_input():
    a = np.random.default_rng(0).standard_normal((2, 16, 16))
    sig = svdmod.svd_batched(a, config=cfg4(), check=True)
    s0 = np.linalg.svd(a, compute_uv=False)
    np.testing.assert_allclose(sig.numpy(), s0, atol=1e-10 * s0.max())


def test_spot_check_svd_catches_wrong_factors():
    a = np.random.default_rng(1).standard_normal((16, 16))
    u, s, vt = np.linalg.svd(a)
    svdmod.spot_check_svd(a[None], u[None], s[None], vt[None])   # no raise
    with pytest.raises(NumericalFault, match="residual"):
        svdmod.spot_check_svd(a[None], np.roll(u, 3, axis=1)[None],
                              s[None], vt[None])


# ---------------------------------------------------------------------------
# engine ladder: retry -> degrade -> quarantine (sync)
# ---------------------------------------------------------------------------

def test_dispatch_error_retried_to_success():
    plan = FaultPlan(seed=0, dispatch_errors_at=(0,))
    eng = SVDEngine(cfg4(), faults=plan, retry=FAST)
    eng.submit(SVDRequest(uid=0, matrix=dense(0), bw=4))
    (r,) = eng.run()
    assert r.error is None
    check_sigma(r)
    snap = eng.metrics.snapshot()
    assert snap["completed"] == 1 and snap["failed"] == 0
    assert snap["retried"] >= 1 and snap["degraded"] == 0
    assert plan.snapshot()["dispatch_error"] == 1
    assert snap["bucket_errors"]                  # last_error attribution


def test_batch_fault_isolates_per_request_and_all_succeed():
    """A failed BATCH dispatch splits per-request; every request completes
    with the right answer through its own retry ladder, FIFO order kept."""
    plan = FaultPlan(seed=0, dispatch_errors_at=(0,))
    eng = SVDEngine(cfg4(max_batch=4), faults=plan, retry=FAST)
    for i in range(4):
        eng.submit(SVDRequest(uid=i, matrix=dense(i), bw=4))
    done = eng.run()
    assert [r.uid for r in done] == [0, 1, 2, 3]
    for r in done:
        assert r.error is None
        check_sigma(r)
    assert eng.metrics.snapshot()["completed"] == 4


def test_nan_corruption_retries_once_then_succeeds():
    plan = FaultPlan(seed=0, nan_at=(0,))
    eng = SVDEngine(cfg4(), faults=plan, retry=FAST)
    eng.submit(SVDRequest(uid=0, matrix=dense(0), bw=4))
    (r,) = eng.run()
    assert r.error is None
    check_sigma(r)
    snap = eng.metrics.snapshot()
    assert snap["retried"] == 1 and snap["degraded"] == 0
    (err_row,) = snap["bucket_errors"].values()
    assert "NumericalFault" in err_row["last_error"]


def test_persistent_nan_degrades_to_ref_tier():
    """NumericalFault is retried ONCE (numerical_max_attempts=2); a second
    poisoned result routes the request to the degraded ref tier, which
    still returns the correct spectrum."""
    plan = FaultPlan(seed=0, nan_at=(0, 1))
    eng = SVDEngine(cfg4(), faults=plan, retry=FAST)
    eng.submit(SVDRequest(uid=0, matrix=dense(0), bw=4))
    (r,) = eng.run()
    assert r.error is None
    check_sigma(r)
    snap = eng.metrics.snapshot()
    assert snap["degraded"] == 1
    assert snap["tiers"]["degraded-ref"]["batches"] == 1
    assert plan.snapshot()["nan"] == 2            # degraded path not injected


def test_quarantine_trips_routes_degraded_and_recovers():
    plan = FaultPlan(seed=0, dispatch_errors_at=(0, 1, 2))
    policy = RetryPolicy(max_attempts=1, backoff_base_s=1e-4,
                         quarantine_threshold=3)
    eng = SVDEngine(cfg4(), faults=plan, retry=policy)
    t = [0.0]
    eng.quarantine = BucketQuarantine(threshold=3, cooldown_s=30.0,
                                      clock=lambda: t[0])
    for i in range(3):                            # each: 1 failure -> degrade
        eng.submit(SVDRequest(uid=i, matrix=dense(i), bw=4))
        eng.run()
    snap = eng.metrics.snapshot()
    assert snap["quarantined"] == 1               # tripped exactly once
    assert snap["quarantined_buckets"]
    assert snap["degraded"] == 3
    assert eng.metrics.health()["status"] == "degraded"
    # OPEN: traffic routes straight to the degraded tier, primary path
    # untouched (the plan's dispatch ordinal must not advance).
    before = plan.snapshot()["dispatches"]
    eng.submit(SVDRequest(uid=10, matrix=dense(10), bw=4))
    (r,) = eng.run()[-1:]
    assert r.error is None
    check_sigma(r)
    assert plan.snapshot()["dispatches"] == before
    # Cooldown elapses -> HALF-OPEN: one primary trial (no fault scripted
    # anymore) succeeds and CLOSES the breaker.
    t[0] = 31.0
    eng.submit(SVDRequest(uid=11, matrix=dense(11), bw=4))
    (r,) = eng.run()[-1:]
    assert r.error is None
    check_sigma(r)
    snap = eng.metrics.snapshot()
    assert snap["quarantined_buckets"] == []
    assert plan.snapshot()["dispatches"] == before + 1
    assert eng.quarantine.open_keys() == []
    for req in eng.finished:
        assert req.error is None                  # zero client-visible fails


def test_backoff_never_sleeps_past_deadline():
    """A retry backoff that would outlive the request's deadline is skipped
    entirely: the request degrades immediately instead of burning its
    budget asleep (the 300 s base backoff would time the test out)."""
    plan = FaultPlan(seed=0, dispatch_errors_at=(0,))
    policy = RetryPolicy(max_attempts=3, backoff_base_s=300.0,
                         backoff_max_s=300.0)
    eng = SVDEngine(cfg4(), faults=plan, retry=policy)
    req = SVDRequest(uid=0, matrix=dense(0), bw=4)
    eng.submit(req)
    req.deadline = time.monotonic() + 30.0
    t0 = time.monotonic()
    (r,) = eng.run()
    elapsed = time.monotonic() - t0
    assert elapsed < 30.0                         # never slept the backoff
    assert r.error is None                        # served (degraded), on time
    check_sigma(r)
    snap = eng.metrics.snapshot()
    assert snap["retried"] == 0 and snap["degraded"] == 1


def test_deadline_rechecked_at_completion_sync():
    """Satellite regression: a request admitted in time but COMPLETED past
    its deadline resolves as TimeoutError (counted timed_out), with the
    late results kept on the request object."""
    eng = SVDEngine(cfg4())
    warm = SVDRequest(uid=-1, matrix=dense(99), bw=4)
    eng.submit(warm)
    eng.run()                                     # compile outside the test
    req = SVDRequest(uid=0, matrix=dense(0), bw=4)
    req.deadline = time.monotonic()               # already passed
    eng.submit(req)
    eng.run()
    assert isinstance(req.error, TimeoutError) and req.done
    assert req.sigma is not None                  # late answer preserved
    snap = eng.metrics.snapshot()
    assert snap["timed_out"] == 1 and snap["failed"] == 0


# ---------------------------------------------------------------------------
# async engine under injected faults
# ---------------------------------------------------------------------------

def test_async_burst_absorbs_dispatch_and_nan_faults():
    plan = FaultPlan(seed=0, dispatch_errors_at=(0,), nan_at=(1,))
    with AsyncSVDEngine(cfg4(), batch_window_s=0.003, faults=plan,
                        retry=FAST) as eng:
        futs = [eng.submit(SVDRequest(uid=i, matrix=dense(i), bw=4))
                for i in range(6)]
        done = [f.result(timeout=300) for f in futs]
    for r in done:
        assert r.error is None
        check_sigma(r)
    snap = eng.metrics.snapshot()
    assert snap["completed"] == 6 and snap["failed"] == 0
    assert snap["retried"] + snap["degraded"] >= 1
    fired = plan.snapshot()
    assert fired["dispatch_error"] >= 1 and fired["nan"] >= 1
    assert eng.metrics.health()["client_error_rate"] == 0.0


def test_async_deadline_rechecked_at_completion():
    """A request whose deadline expires while its batch is ON DEVICE gets
    TimeoutError at completion — not a silent late success."""
    plan = FaultPlan(seed=0, latency_rate=1.0, latency_s=0.3)
    eng = AsyncSVDEngine(cfg4(), batch_window_s=0.001, faults=plan,
                         retry=FAST)
    warm = eng.submit(SVDRequest(uid=-1, matrix=dense(99), bw=4),
                      timeout_s=float("inf"))
    warm.result(timeout=300)                      # compiled; 0.3s > 0.1s now
    fut = eng.submit(SVDRequest(uid=0, matrix=dense(0), bw=4),
                     timeout_s=0.1)
    with pytest.raises(TimeoutError):
        fut.result(timeout=300)
    eng.stop()
    late = [r for r in eng.finished if r.uid == 0][0]
    assert late.sigma is not None                 # late answer preserved
    assert eng.metrics.snapshot()["timed_out"] == 1


# ---------------------------------------------------------------------------
# metrics health view
# ---------------------------------------------------------------------------

def test_health_status_transitions():
    from repro_torch.serve import ServeMetrics
    m = ServeMetrics()
    assert m.health()["status"] == "ok"
    m.add(submitted=2, completed=1, retried=1)
    assert m.health()["status"] == "ok"           # healed retries stay ok
    m.add(degraded=1)
    assert m.health()["status"] == "degraded"
    m.add(failed=1)
    h = m.health()
    assert h["status"] == "failing"
    assert h["client_error_rate"] == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# the same plan in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fields", [
    dict(seed=7, dispatch_error_rate=0.3, nan_rate=0.25, inf_rate=0.1),
    dict(seed=3, device_loss_rate=0.2, dispatch_error_rate=0.2,
         latency_rate=0.5, latency_s=1e-4, nan_at=(2, 5), max_faults=9),
    dict(seed=11, shard_loss_rate=0.3, host_loss_rate=0.2,
         dispatch_errors_at=(1,), shard_loss_at=(4,), host_loss_at=(0,)),
])
def test_fault_plan_matches_the_reference(fields):
    """The port's FaultPlan and the reference's, built from the same
    fields, inject the same faults at the same ordinals of every hook."""
    from repro.serve.faults import FaultPlan as JPlan

    def drive(plan):
        events = []
        for i in range(30):
            try:
                plan.before_dispatch(key=("k", i))
                events.append("ok")
            except Exception as exc:             # noqa: BLE001 — recorded
                events.append(type(exc).__name__)
            sig = plan.corrupt_sigma(np.linspace(9.0, 1.0, 5 + i % 3))
            events.append(tuple(np.where(~np.isfinite(sig))[0]))
            events.append(tuple(plan.lost_shards(4)))
            events.append(plan.lose_host(["w0", "w1", "w2"]))
        return events, plan.snapshot()

    ours, theirs = drive(FaultPlan(**fields)), drive(JPlan(**fields))
    assert ours == theirs
    assert sum(v for k, v in ours[1].items()
               if k not in ("dispatches", "results", "sharded",
                            "host_ticks")) > 0


# ---------------------------------------------------------------------------
# sharded dispatch: shard loss -> bit-for-bit re-dispatch
# ---------------------------------------------------------------------------

def test_sharded_shard_loss_redispatch_bitwise_identical():
    from repro_torch.core.distributed import sharded_pipeline_dispatch
    from repro_torch.launch.mesh import DeviceMesh
    mesh = DeviceMesh(["cpu"] * 4)
    c = cfg4(max_batch=8)
    mats = torch.tensor(np.random.default_rng(0).standard_normal((8, 16, 16)))
    clean = sharded_pipeline_dispatch(mats, mesh, config=c)
    retries = []
    plan = FaultPlan(shard_loss_at=(0,))          # lose shard 0 of dispatch 0
    out = sharded_pipeline_dispatch(mats, mesh, config=c, faults=plan,
                                    on_shard_retry=retries.append)
    assert plan.snapshot()["shard_loss"] == 1, plan.snapshot()
    assert sum(retries) == 1, retries
    assert torch.isfinite(out).all()
    assert torch.equal(clean, out)


def test_async_sharded_engine_survives_shard_loss():
    """End to end: the async engine on a mesh, with shard losses injected:
    every request completes with the oracle spectrum and the re-dispatches
    are counted in sharded_retries."""
    from repro_torch.launch.mesh import DeviceMesh
    plan = FaultPlan(shard_loss_at=(0, 1))
    rng = np.random.default_rng(0)
    with AsyncSVDEngine(cfg4(max_batch=8), mesh=DeviceMesh(["cpu"] * 4),
                        batch_window_s=0.005, faults=plan) as eng:
        futs = [eng.submit(SVDRequest(uid=i,
                                      matrix=rng.standard_normal((16, 16)),
                                      bw=4))
                for i in range(8)]
        done = [f.result(timeout=300) for f in futs]
    for r in done:
        assert r.error is None
        check_sigma(r)
    snap = eng.metrics.snapshot()
    assert snap["sharded_retries"] >= 1, snap
    assert snap["sharded_batches"] >= 1
    assert snap["failed"] == 0 and snap["completed"] == 8, snap
