"""The port's SVD serving engine on the CPU: the reference's engine cases
(bucketed results equal direct batched calls, banded and full-SVD buckets,
the fuse depth and the tuned per-bucket config carried through, the
staged-dc tier, ``default_bucket_batch`` and ``max_batch`` in the config),
and one end-to-end parity test: the same seeded stream through the
reference's ``SVDEngine`` and the port's, per request sigma within
1e-12 * sigma_max, the same completion order, counters and tiers, and
under one ``FaultPlan`` the same retry, degrade and quarantine counts."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import check_svd

from repro.core.tuning import PipelineConfig as JConfig
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import RetryPolicy as JRetryPolicy
from repro.serve import SVDEngine as JEngine
from repro.serve import SVDRequest as JRequest
from repro_torch import convert
from repro_torch.autotune import cache as at_cache
from repro_torch.core import svd as svdmod
from repro_torch.core import tuning
from repro_torch.core.tuning import PipelineConfig
from repro_torch.serve import (FaultPlan, RetryPolicy, SVDEngine,
                               SVDRequest)

torch.set_num_threads(2)

F64 = torch.float64


def cpu_cfg(**kw):
    kw.setdefault("dtype", F64)
    return PipelineConfig.resolve(backend="ref", device="cpu", **kw)


def banded_random(n, bw, seed, dtype=np.float64):
    a = np.triu(np.random.default_rng(seed).standard_normal((n, n)))
    return (np.triu(a) - np.triu(a, bw + 1)).astype(dtype)


# ---------------------------------------------------------------------------
# bucket sizes
# ---------------------------------------------------------------------------

def test_default_bucket_batch_fills_the_card():
    """A bucket's batch fills the H100's places for chase blocks (132 SMs,
    4 blocks of 512 threads each where shared memory allows); a matrix
    whose own wavefront fills them gets 1."""
    places = tuning.SMS * 4
    for n, bw in [(24, 4), (32, 8), (256, 32), (1024, 64), (4096, 32)]:
        b = tuning.default_bucket_batch(n, bw)
        assert 1 <= b <= 64
        g = tuning.max_concurrent_sweeps(n, bw)
        assert b * g >= places or b == 64, (n, bw, b)
        assert b == 1 or (b - 1) * g < places, (n, bw, b)
    assert tuning.default_bucket_batch(100_000, 32) == 1
    # shared memory bounds the blocks per SM of a wide band: one block of
    # (512, tw 16) fp64 holds 139 KB, so one block an SM, 132 places
    assert tuning.SMEM_PER_SM // (tuning.smem_bytes(512, 16, F64) + 1024) \
        == 1
    g = tuning.max_concurrent_sweeps(8192, 512)
    assert tuning.default_bucket_batch(8192, 512, F64) == -(-tuning.SMS // g)


def test_resolve_max_batch_default_explicit_and_cached(tmp_path):
    assert PipelineConfig.resolve(bw=8, device="cpu").max_batch == 8
    assert PipelineConfig.resolve(bw=8, n=96, device="cpu").max_batch == \
        tuning.default_bucket_batch(96, 8)
    assert PipelineConfig.resolve(bw=8, n=96, max_batch=3,
                                  device="cpu").max_batch == 3
    p = str(tmp_path / "cache.json")
    at_cache.store({"tw": 3, "fuse": 4, "max_batch": 7}, device_kind="cpu",
                   n=128, bw=16, dtype="float32", compute_uv=False,
                   backend="ref", path=p)
    kw = dict(n=128, bw=16, device="cpu", autotune=True, autotune_cache=p)
    assert PipelineConfig.resolve(**kw).max_batch == 7
    assert PipelineConfig.resolve(max_batch=2, **kw).max_batch == 2
    at_cache.store({"tw": 3, "fuse": 4}, device_kind="cpu", n=128, bw=16,
                   dtype="float32", compute_uv=False, backend="ref", path=p)
    assert PipelineConfig.resolve(**kw).max_batch == \
        tuning.default_bucket_batch(128, 16)


def test_convert_keeps_max_batch():
    jcfg = JConfig.resolve(bw=8, tw=3, backend="ref", dtype=jnp.float64,
                           n=40, max_batch=5)
    cfg = convert.pipeline_config_from_reference(dataclasses.asdict(jcfg),
                                                 device="cpu")
    assert cfg.max_batch == 5
    eng = SVDEngine(cfg)
    assert eng._cfg_for((40, 8, "float64", False, False)).max_batch == 5


def test_search_default_batch_is_the_bucket_default():
    from repro_torch.autotune import search as at_search
    d = tuning.default_bucket_batch(64, 8, F64)
    seen = []

    def measure_fn(tw, fuse, batch):
        seen.append(batch)
        return 1e-3 * batch
    res = at_search.search(64, 8, dtype=F64, backend="ref", device="cpu",
                           top_k=1, fuses=(1,), batches=(1, d, 2 * d),
                           measure_fn=measure_fn)
    assert res.default.batch == d and d in seen
    res1 = at_search.search(64, 8, dtype=F64, backend="ref", device="cpu",
                            top_k=1, fuses=(1,), batches=(2,),
                            measure_fn=measure_fn)
    assert res1.default.batch == 2


# ---------------------------------------------------------------------------
# the reference's engine cases
# ---------------------------------------------------------------------------

def test_serve_bucketed_matches_direct_batched():
    rng = np.random.default_rng(4)
    small = rng.standard_normal((5, 24, 24))
    large = rng.standard_normal((3, 32, 32))
    eng = SVDEngine(cpu_cfg(bw=4, tw=2, max_batch=4), fused_n_max=0)
    uid = 0
    for m in small:
        eng.submit(SVDRequest(uid=uid, matrix=m, bw=4))
        uid += 1
    for m in large:
        eng.submit(SVDRequest(uid=uid, matrix=m, bw=8))
        uid += 1
    done = eng.run()
    assert len(done) == 8 and all(r.done for r in done)
    assert eng.calls == 3                   # ceil(5/4) + ceil(3/4) flushes
    assert eng.pending() == 0
    by_uid = {r.uid: r for r in done}
    # bit for bit the direct call on the same padded stack
    for mats, bw, first in ((small, 4, 0), (large, 8, 5)):
        cfg = eng._cfg_for((mats.shape[-1], bw, "float64", False, False))
        for lo in range(0, len(mats), cfg.max_batch):
            chunk = mats[lo:lo + cfg.max_batch]
            stack = np.zeros((cfg.max_batch,) + mats.shape[1:])
            stack[:len(chunk)] = chunk
            direct = svdmod.svd_batched(torch.from_numpy(stack), cfg).numpy()
            for i in range(len(chunk)):
                np.testing.assert_array_equal(by_uid[first + lo + i].sigma,
                                              direct[i])
            assert np.all(direct[len(chunk):] <= np.finfo(np.float64).eps)
    for i in range(5):
        s0 = np.linalg.svd(small[i], compute_uv=False)
        np.testing.assert_allclose(by_uid[i].sigma, s0, atol=1e-10 * s0[0])


def test_serve_banded_requests():
    n, bw = 32, 6
    mats = [banded_random(n, bw, 30 + s) for s in range(3)]
    eng = SVDEngine(cpu_cfg(bw=bw, tw=3, max_batch=4))
    for i, m in enumerate(mats):
        eng.submit(SVDRequest(uid=i, matrix=m, bw=bw, banded=True))
    done = eng.run()
    assert len(done) == 3
    for r in done:
        s0 = np.linalg.svd(mats[r.uid], compute_uv=False)
        np.testing.assert_allclose(r.sigma, s0, atol=1e-10 * s0[0])


def test_serve_engine_forwards_fuse():
    eng = SVDEngine(cpu_cfg(bw=4, tw=2, max_batch=4, fuse=4))
    mats = np.random.default_rng(6).standard_normal((3, 20, 20))
    for i, m in enumerate(mats):
        eng.submit(SVDRequest(uid=i, matrix=m, bw=4))
    assert eng._cfg_for(next(iter(eng.buckets))).fuse == 4
    for r in eng.run():
        s0 = np.linalg.svd(mats[r.uid], compute_uv=False)
        np.testing.assert_allclose(r.sigma, s0, atol=1e-10 * s0[0])


def test_engine_compute_uv_bucketing():
    rng = np.random.default_rng(8)
    eng = SVDEngine(cpu_cfg(bw=6, tw=2))
    mats = [rng.standard_normal((20, 20)) for _ in range(6)]
    for i, m in enumerate(mats):
        eng.submit(SVDRequest(uid=i, matrix=m, bw=6, compute_uv=(i % 2 == 0)))
    done = eng.run()
    assert len(done) == 6
    for r in done:
        s0 = np.linalg.svd(mats[r.uid], compute_uv=False)
        np.testing.assert_allclose(r.sigma, s0, atol=1e-8 * s0[0])
        if r.compute_uv:
            check_svd(mats[r.uid], r.u, r.sigma, r.vt, 1e-9)
        else:
            assert r.u is None and r.vt is None


def test_engine_keeps_the_request_dtype_and_takes_tensors():
    """No downcast: fp32 requests are served in fp32, fp64 in fp64; a
    tensor request is served like its numpy twin."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((16, 16))
    eng = SVDEngine(cpu_cfg(bw=4, tw=2))
    eng.submit(SVDRequest(uid=0, matrix=a.astype(np.float32), bw=4))
    eng.submit(SVDRequest(uid=1, matrix=torch.from_numpy(a), bw=4))
    eng.submit(SVDRequest(uid=2, matrix=a, bw=4))
    done = {r.uid: r for r in eng.run()}
    assert done[0].sigma.dtype == np.float32
    assert done[1].sigma.dtype == done[2].sigma.dtype == np.float64
    np.testing.assert_array_equal(done[1].sigma, done[2].sigma)


def _run_dc_engine(dc_n_min):
    rng = np.random.default_rng(8)
    eng = SVDEngine(cpu_cfg(bw=4, tw=2, max_batch=4), fused_n_max=0,
                    dc_n_min=dc_n_min)
    mats = rng.standard_normal((3, 24, 24))
    for uid, m in enumerate(mats):
        eng.submit(SVDRequest(uid=uid, matrix=m, bw=4))
    done = eng.run()
    assert len(done) == 3 and all(r.done and r.error is None for r in done)
    for r in done:
        s0 = np.linalg.svd(mats[r.uid], compute_uv=False)
        np.testing.assert_allclose(r.sigma, s0, atol=1e-11 * s0[0])
    return eng.metrics.snapshot()


@pytest.mark.parametrize("dc_n_min,tier", [(1, "staged-dc"), (0, "staged")])
def test_engine_dc_tier_and_disabled(dc_n_min, tier):
    snap = _run_dc_engine(dc_n_min)
    assert {v["tier"] for v in snap["bucket_tiers"].values()} == {tier}
    assert snap["tiers"][tier]["batches"] > 0
    assert set(snap["tiers"]) == {tier}


def test_engine_resolves_tuned_config_per_bucket(tmp_path):
    p = str(tmp_path / "cache.json")
    n, bw = 24, 4
    at_cache.store({"tw": 2, "fuse": 2, "max_batch": 2}, device_kind="cpu",
                   n=n, bw=bw, dtype="float32", compute_uv=False,
                   backend="ref", path=p)
    a = banded_random(n, bw, 0, np.float32)
    eng = SVDEngine(backend="ref", device="cpu", autotune=True,
                    autotune_cache=p, fused_n_max=0)
    for uid in range(3):
        eng.submit(SVDRequest(uid=uid, matrix=a, bw=bw))
    key = (n, bw, "float32", False, False)
    cfg = eng._cfg_for(key)
    assert (cfg.tw, cfg.fuse, cfg.max_batch) == (2, 2, 2)
    assert eng._cfg_for(key) is cfg          # memoized per bucket
    done = eng.run()
    assert len(done) == 3 and eng.calls == 2  # 3 requests / bucket of 2
    ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(done[0].sigma, ref, atol=1e-4)


def test_engine_autotune_miss_matches_default_and_keeps_explicit(tmp_path):
    p = str(tmp_path / "none.json")
    key = (24, 4, "float32", False, False)
    tuned = SVDEngine(backend="ref", device="cpu", autotune=True,
                      autotune_cache=p)._cfg_for(key)
    plain = SVDEngine(backend="ref", device="cpu")._cfg_for(key)
    assert tuned == plain
    base = PipelineConfig.resolve(bw=16, tw=4, fuse=2, backend="ref",
                                  device="cpu")
    cfg = SVDEngine(base, autotune=True, autotune_cache=p,
                    fused_n_max=0)._cfg_for(
        (128, 16, "float32", False, False))
    assert (cfg.tw, cfg.fuse) == (4, 2)


def test_default_engine_takes_each_buckets_tilewidth():
    """Each bucket takes its own cache-line tilewidth (fp32 bw 64: 32, two
    stages; fp64: 16), with or without a given config; a given config's tw
    holds for the buckets of the (bw, dtype) it was resolved for."""
    eng = SVDEngine(backend="ref", device="cpu", fused_n_max=0)
    f32 = eng._cfg_for((1024, 64, "float32", False, False))
    f64 = eng._cfg_for((512, 32, "float64", False, True))
    assert (f32.tw, f32.plan) == (32, ((64, 32), (32, 31)))
    assert f64.tw == 16
    given = SVDEngine(cpu_cfg(bw=32, tw=8, dtype=torch.float32),
                      fused_n_max=0)
    other = given._cfg_for((1024, 64, "float32", False, False))
    assert (other.tw, other.plan) == (32, ((64, 32), (32, 31)))
    assert given._cfg_for((512, 32, "float64", False, False)).tw == 16
    assert given._cfg_for((512, 32, "float32", False, False)).tw == 8


def test_engine_caps_a_bucket_only_where_asked():
    """With neither a config nor ``max_batch`` a bucket holds
    ``default_bucket_batch``; an explicit ``max_batch``, else a given
    config's, caps it."""
    key = (24, 4, "float64", False, False)
    d = tuning.default_bucket_batch(24, 4, torch.float64)
    assert d > 8
    assert SVDEngine(backend="ref", device="cpu",
                     fused_n_max=0)._cfg_for(key).max_batch == d
    assert SVDEngine(backend="ref", device="cpu", max_batch=5,
                     fused_n_max=0)._cfg_for(key).max_batch == 5
    assert SVDEngine(cpu_cfg(bw=4), fused_n_max=0)._cfg_for(
        key).max_batch == 8
    assert SVDEngine(cpu_cfg(bw=4, max_batch=40), max_batch=6,
                     fused_n_max=0)._cfg_for(key).max_batch == 6


@pytest.mark.parametrize("fused_n_max", [32, 0], ids=["fused", "staged"])
def test_engine_fails_a_kernel_build_error_rather_than_degrading(
        monkeypatch, fused_n_max):
    """A kernel that does not build fails its requests with the compiler's
    error: no retry, no degraded tier, no breaker count.  The kernels'
    loader is stubbed to fail and the CPU ops to reach it first, as the
    wrappers do on the card."""
    from repro_torch.kernels import _build, ops

    def no_build(name):
        raise RuntimeError(f"nvcc failed: {name}.cu")
    monkeypatch.setattr(_build, "load", no_build)
    for op, source in (("fused_svd", "fused_small"),
                       ("sturm_bisect", "sturm")):
        plain = ops._REGISTRY["ref"][op]

        def through_loader(x, *a, _plain=plain, _source=source, **kw):
            _build.load(_source)
            return _plain(x, *a, **kw)
        monkeypatch.setitem(ops._REGISTRY["ref"], op, through_loader)
    eng = SVDEngine(cpu_cfg(bw=4, tw=2, max_batch=4), fused_n_max=fused_n_max)
    rng = np.random.default_rng(3)
    for uid in range(6):
        eng.submit(SVDRequest(uid=uid, matrix=rng.standard_normal((24, 24)),
                              bw=4))
    done = eng.run()
    assert [r.uid for r in done] == list(range(6))
    assert all(isinstance(r.error, RuntimeError) and "nvcc failed" in
               str(r.error) and r.sigma is None for r in done)
    snap = eng.metrics.snapshot()
    assert (snap["failed"], snap["completed"]) == (6, 0)
    assert snap["retried"] == snap["degraded"] == snap["quarantined"] == 0
    assert eng.calls == 0


def test_engine_tuned_fused_crossover(tmp_path):
    """``autotune=True`` reads the measured fused crossover: a bucket above
    it stays staged, one at it goes fused."""
    p = str(tmp_path / "cache.json")
    at_cache.store_crossover({"fused_n_max": 16}, device_kind="cpu",
                             dtype="float64", compute_uv=False, bw=4,
                             path=p)
    eng = SVDEngine(cpu_cfg(bw=4, tw=2), autotune=True, autotune_cache=p)
    assert eng._fused_n_max_for((16, 4, "float64", False, False)) == 16
    assert eng._tier_of(eng._cfg_for((16, 4, "float64", False, False)),
                        16) == "fused"
    assert eng._tier_of(eng._cfg_for((20, 4, "float64", False, False)),
                        20) == "staged"
    assert SVDEngine(cpu_cfg(bw=4, tw=2))._fused_n_max_for(
        (16, 4, "float64", False, False)) == tuning.DEFAULT_FUSED_CROSSOVER


def test_engine_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SVDEngine()
    with pytest.raises(ValueError, match="conflicts"):
        SVDEngine(cpu_cfg(bw=4), device="cuda")


# ---------------------------------------------------------------------------
# end-to-end parity with the reference's engine
# ---------------------------------------------------------------------------

# (n, banded, compute_uv, count): with fused_n_max 16 and dc_n_min 24 the
# keys cover the fused tier (values and vectors), the staged tier (a
# banded bucket) and the staged-dc tier (vectors; dc leaves of 8)
STREAM = [(12, False, False, 5), (16, False, True, 3), (20, True, False, 4),
          (28, False, True, 3)]
BW = 4


def _stream(seed):
    rng = np.random.default_rng(seed)
    kinds = [k for k, (_, _, _, c) in enumerate(STREAM) for _ in range(c)]
    out = []
    for uid, k in enumerate(rng.permutation(kinds)):
        n, banded, uv, _ = STREAM[k]
        a = (banded_random(n, BW, 100 + uid) if banded
             else rng.standard_normal((n, n)))
        out.append((uid, a, banded, uv))
    return out


def _serve(eng, req_cls, stream):
    for uid, a, banded, uv in stream:
        eng.submit(req_cls(uid=uid, matrix=a, bw=BW, banded=banded,
                           compute_uv=uv))
    return eng.run()


COUNTERS = ("submitted", "completed", "failed", "timed_out", "rejected",
            "batches", "served_slots", "padded_slots", "bucket_hits",
            "retried", "quarantined", "degraded")


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faults"])
def test_engine_parity_with_the_reference(faulted):
    jcfg = JConfig.resolve(bw=BW, tw=2, backend="ref", dtype=np.float64,
                           max_batch=4, dc_leaf_n=8)
    cfg = convert.pipeline_config_from_reference(dataclasses.asdict(jcfg),
                                                 device="cpu")
    kw = dict(fused_n_max=16, dc_n_min=24)
    plan = dict(seed=8, dispatch_error_rate=0.3, nan_rate=0.2)
    pol = dict(max_attempts=2, numerical_max_attempts=1, backoff_base_s=0.0,
               backoff_max_s=0.0, quarantine_threshold=2)
    if faulted:
        jeng = JEngine(jcfg, faults=JFaultPlan(**plan),
                       retry=JRetryPolicy(**pol), **kw)
        eng = SVDEngine(cfg, faults=FaultPlan(**plan),
                        retry=RetryPolicy(**pol), **kw)
    else:
        jeng, eng = JEngine(jcfg, **kw), SVDEngine(cfg, **kw)
    stream = _stream(21)
    want = _serve(jeng, JRequest, stream)
    got = _serve(eng, SVDRequest, stream)
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert g.error is None and w.error is None, (g.error, w.error)
        a = np.asarray(g.matrix)
        smax = float(np.max(w.sigma))
        np.testing.assert_allclose(g.sigma, np.asarray(w.sigma), rtol=0,
                                   atol=1e-12 * smax)
        if g.compute_uv:
            check_svd(a, g.u, g.sigma, g.vt, 1e-12 * a.shape[-1])
            check_svd(a, np.asarray(w.u), np.asarray(w.sigma),
                      np.asarray(w.vt), 1e-12 * a.shape[-1])
    snap, jsnap = eng.metrics.snapshot(), jeng.metrics.snapshot()
    assert {k: snap[k] for k in COUNTERS} == {k: jsnap[k] for k in COUNTERS}
    assert snap["bucket_tiers"] == jsnap["bucket_tiers"]
    assert {v["tier"] for v in snap["bucket_tiers"].values()} == \
        {"fused", "staged", "staged-dc"}
    if faulted:
        assert eng.faults.snapshot() == jeng.faults.snapshot()
        assert snap["retried"] > 0 and snap["degraded"] > 0
        assert snap["quarantined"] > 0
        assert snap["tiers"] == jsnap["tiers"]
