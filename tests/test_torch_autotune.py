"""The port's autotuner (``repro_torch.autotune``) against the reference's
``repro.autotune``, on the CPU: the cost model to 1e-12 relative under one
profile both packages are given, the cache file readable both ways, the
searches' choices under the same injected measurements, the CLI on the
plain path, and ``PipelineConfig.resolve(autotune=True)``."""

import itertools
import math

import jax.numpy as jnp
import pytest
import torch

from repro.autotune import cache as jcache
from repro.autotune import model as jmodel
from repro.autotune import search as jsearch
from repro_torch.autotune import cache as tcache
from repro_torch.autotune import measure as tmeasure
from repro_torch.autotune import model as tmodel
from repro_torch.autotune import search as tsearch
from repro_torch.autotune.__main__ import main as autotune_main, parse_shapes
from repro_torch.core import bidiag_svd as tbs
from repro_torch.core import bulge_chasing as bc
from repro_torch.core import svd as tsvd
from repro_torch.core import tuning
from repro_torch.core.tuning import PipelineConfig

torch.set_num_threads(2)

# one profile in each package whose budget admits every candidate
_PROF = dict(mem_bw=1.5e12, launch_overhead_s=7e-6, fast_mem_bytes=1 << 40,
             execution_units=48)
JPROF = jmodel.DeviceProfile("test", **_PROF)
TPROF = tmodel.DeviceProfile("test", **_PROF)
DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]


def rel(a, b):
    if math.isinf(a) or math.isinf(b):
        return 0.0 if a == b else math.inf
    return abs(a - b) / max(abs(b), 1e-300)


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jd,td", DTYPES, ids=["float32", "float64"])
def test_stage_and_pipeline_cost_match_reference(jd, td):
    for n, bw in ((64, 8), (200, 32), (1024, 64)):
        for (tw, fuse, batch), tape in itertools.product(
                tsearch.candidate_grid(n, bw, dtype=td, fuses=(1, 2, 4),
                                       batches=(1, 3)), (False, True)):
            got = tmodel.pipeline_cost(n, bw, tw, fuse=fuse, batch=batch,
                                       dtype=td, profile=TPROF, tape=tape)
            want = jmodel.pipeline_cost(n, bw, tw, fuse=fuse, batch=batch,
                                        dtype=jd, profile=JPROF, tape=tape)
            assert rel(got, want) <= 1e-12, (n, bw, tw, fuse, batch, tape)
            b_in, twi = tuning.stage_plan(bw, tw)[0]
            g = tmodel.stage_cost(n, b_in, twi, fuse=fuse, batch=batch,
                                  dtype=td, profile=TPROF, tape=tape)
            w = jmodel.stage_cost(n, b_in, twi, fuse=fuse, batch=batch,
                                  dtype=jd, profile=JPROF, tape=tape)
            for field in ("seconds", "mem_seconds", "launch_seconds",
                          "bytes_moved", "occupancy"):
                assert rel(getattr(g, field), getattr(w, field)) <= 1e-12
            assert (g.cycles, g.supercycles, g.wavefront) == (
                w.cycles, w.supercycles, w.wavefront)


@pytest.mark.parametrize("jd,td", DTYPES, ids=["float32", "float64"])
def test_fused_and_stage3_costs_match_reference(jd, td):
    for n, bw, batch, uv in itertools.product((16, 64, 200), (4, 32), (1, 8),
                                              (False, True)):
        g = tmodel.fused_cost(n, bw, batch=batch, dtype=td, profile=TPROF,
                              compute_uv=uv)
        w = jmodel.fused_cost(n, bw, batch=batch, dtype=jd, profile=JPROF,
                              compute_uv=uv)
        assert rel(g.seconds, w.seconds) <= 1e-12, (n, bw, batch, uv)
    for bw, uv in itertools.product((8, 32), (False, True)):
        assert tmodel.predicted_crossover(
            bw, dtype=td, profile=TPROF, compute_uv=uv) == \
            jmodel.predicted_crossover(bw, dtype=jd, profile=JPROF,
                                       compute_uv=uv)
    for n, solver, batch, leaf in itertools.product(
            (40, 512, 4096, 20000), ("bisect", "dc"), (1, 4), (16, 32)):
        g = tmodel.stage3_cost(n, solver=solver, dtype=td, batch=batch,
                               profile=TPROF, leaf_n=leaf)
        w = jmodel.stage3_cost(n, solver=solver, dtype=jd, batch=batch,
                               profile=JPROF, leaf_n=leaf)
        assert rel(g.seconds, w.seconds) <= 1e-12, (n, solver, batch, leaf)
    for batch in (1, 4):
        assert tmodel.predicted_stage3_crossover(
            dtype=td, batch=batch, profile=TPROF) == \
            jmodel.predicted_stage3_crossover(dtype=jd, batch=batch,
                                              profile=JPROF)


def test_total_chase_cycles_matches_reference_and_schedule():
    for n, b_in, tw in ((64, 8, 3), (100, 16, 15), (257, 32, 16), (9, 4, 1)):
        cycles = tmodel.total_chase_cycles(n, b_in, tw)
        assert cycles == jmodel.total_chase_cycles(n, b_in, tw)
        _, T, G = bc.stage_schedule(n, b_in, tw)
        t = torch.arange(T)[:, None]
        g = torch.arange(G)[None, :]
        active = bc.chase_cycle_indices(t, g, n, b_in, tw)[3]
        assert cycles == int(active.sum())


def test_profiles():
    h100 = tmodel.profile_for("NVIDIA H100 80GB HBM3")
    assert h100.device_kind == "nvidia h100"
    assert (h100.mem_bw, h100.execution_units, h100.fast_mem_bytes) == (
        3.35e12, 132, tuning.SMEM_PER_BLOCK)
    assert tmodel.profile_for("NVIDIA A100-SXM4-80GB").device_kind == "gpu"
    assert tmodel.profile_for("cpu").device_kind == "cpu"
    assert tmodel.device_kind("cpu") == "cpu"
    # the shared-memory cliff: a chase block that misses the budget
    small = tmodel.DeviceProfile("small", 1e12, 5e-6, 4096, 132)
    assert not tmodel.stage_cost(512, 64, 32, profile=small).feasible
    assert math.isinf(tmodel.pipeline_cost(512, 64, 32, profile=small))


# ---------------------------------------------------------------------------
# the cache: one file, read by both packages
# ---------------------------------------------------------------------------

KEY = dict(device_kind="testdev", n=128, bw=16, dtype="float64",
           compute_uv=False, backend="ref")
S3 = dict(device_kind="testdev", dtype="float64", compute_uv=False)


def test_reference_cache_reads_in_the_port(tmp_path):
    p = str(tmp_path / "ref.json")
    jcache.store({"tw": 5, "fuse": 2, "max_batch": 4}, **KEY, path=p)
    jcache.store_stage3({"dc_n_min": 1536}, **S3, path=p)
    jcache.store_crossover({"fused_n_max": 96}, device_kind="testdev",
                           dtype="float64", compute_uv=False, bw=8, path=p)
    got = tcache.lookup(**KEY, path=p)
    assert (got["tw"], got["fuse"], got["max_batch"]) == (5, 2, 4)
    assert tcache.lookup_stage3(**S3, path=p) == 1536
    assert tcache.lookup_crossover(device_kind="testdev", dtype="float64",
                                   compute_uv=False, bw=8, path=p) == 96


def test_port_cache_reads_in_the_reference(tmp_path):
    p = str(tmp_path / "port.json")
    tcache.store({"tw": 7, "fuse": 1}, **KEY, path=p)
    tcache.store_stage3({"dc_n_min": 16385}, **S3, path=p)
    tcache.store_crossover({"fused_n_max": 0}, device_kind="testdev",
                           dtype="float64", compute_uv=False, path=p)
    got = jcache.lookup(**KEY, path=p)
    assert (got["tw"], got["fuse"]) == (7, 1) and "max_batch" not in got
    assert jcache.lookup_stage3(**S3, path=p) == 16385
    assert jcache.lookup_crossover(device_kind="testdev", dtype="float64",
                                   compute_uv=False, bw=8, path=p) == 0
    # corrupt and half-written entries read as misses in the port too
    tcache.store({"tw": 3}, **{**KEY, "n": 64}, path=p)
    assert tcache.lookup(**{**KEY, "n": 64}, path=p) is None
    (tmp_path / "bad.json").write_text("{not json")
    assert tcache.lookup(**KEY, path=str(tmp_path / "bad.json")) is None
    assert tcache.ENV_VAR == "REPRO_TORCH_AUTOTUNE_CACHE"


# ---------------------------------------------------------------------------
# the searches under the same injected measurements
# ---------------------------------------------------------------------------

def _fake_stage2(tw, fuse, batch):
    return 1.0 + fuse * 0.5 + abs(tw - 8) * 0.01


@pytest.mark.parametrize("fake", [_fake_stage2, lambda tw, fuse, b: 1.0])
def test_search_matches_reference(fake):
    for n, bw, jd, td in ((256, 16, jnp.float32, torch.float32),
                          (4096, 64, jnp.float64, torch.float64)):
        got = tsearch.search(n, bw, dtype=td, backend="ref", top_k=3,
                             profile=TPROF, device="cpu", measure_fn=fake)
        want = jsearch.search(n, bw, dtype=jd, backend="ref", top_k=3,
                              profile=JPROF, measure_fn=fake)
        assert (got.best.tw, got.best.fuse, got.best.batch) == (
            want.best.tw, want.best.fuse, want.best.batch)
        assert got.model_rank_of_best() == want.model_rank_of_best()
        assert [(c.tw, c.fuse) for c in got.measured] == [
            (c.tw, c.fuse) for c in want.measured]
        entry = got.to_entry()
        assert "max_batch" not in entry
        assert entry["tw"] == want.to_entry()["tw"]
        assert "model rank of measured best" in got.table()


def test_crossover_searches_match_reference():
    def fused(n, is_fused):
        return (0.5 if n <= 64 else 2.0) if is_fused else 1.0

    kw = dict(ns=(16, 32, 64, 128), batch=8)
    got = tsearch.search_fused_crossover(8, dtype=torch.float32,
                                         profile=TPROF, device="cpu",
                                         measure_fn=fused, **kw)
    want = jsearch.search_fused_crossover(8, dtype=jnp.float32,
                                          profile=JPROF, measure_fn=fused,
                                          **kw)
    assert (got.fused_n_max, got.predicted_n_max) == (
        want.fused_n_max, want.predicted_n_max) == (64, want.predicted_n_max)

    for wins in ((), (2048, 4096), (512, 4096)):
        def stage3(n, dc, wins=wins):
            return (0.5 if n in wins else 2.0) if dc else 1.0, 1e-16

        kw = dict(ns=(256, 512, 1024, 2048, 4096), batch=4)
        got = tsearch.search_stage3_crossover(
            dtype=torch.float64, profile=TPROF, device="cpu",
            measure_fn=stage3, **kw)
        want = jsearch.search_stage3_crossover(
            dtype=jnp.float64, profile=JPROF, measure_fn=stage3, **kw)
        assert (got.dc_n_min, got.predicted_n_min) == (
            want.dc_n_min, want.predicted_n_min)
        assert got.to_entry()["points"] == want.to_entry()["points"]
    assert got.dc_n_min == 4096 and "dc_n_min=4096" in got.table()


def test_stage3_crossover_measures_on_the_plain_path():
    res = tsearch.search_stage3_crossover(
        dtype=torch.float64, ns=(40,), batch=2, warmup=0, iters=1,
        leaf_n=8, profile=TPROF, device="cpu")
    (n, bi_s, dc_s, agree), = res.points
    assert n == 40 and bi_s > 0 and dc_s > 0 and agree <= 1e-12
    assert res.dc_n_min in (40, 41)


def test_stage3_crossover_on_the_pipelines_bidiagonals(monkeypatch):
    """With a bw, both solvers time what stage 2 makes of banded inputs:
    the stack the pipeline's stage 3 gets, held to the same agreement."""
    seen = []
    real = tsvd.bidiagonal_of

    def spy(a, **kw):
        seen.append(tuple(a.shape))
        return real(a, **kw)

    monkeypatch.setattr(tsvd, "bidiagonal_of", spy)
    res = tsearch.search_stage3_crossover(
        dtype=torch.float64, ns=(24, 40), batch=1, warmup=0, iters=1,
        leaf_n=8, profile=TPROF, device="cpu", bw=6)
    assert seen == [(1, 24, 24), (1, 40, 40)]   # one stack a size
    assert [p[0] for p in res.points] == [24, 40]
    assert all(p[1] > 0 and p[2] > 0 and p[3] <= 1e-12 for p in res.points)
    a = tmeasure.banded_input(40, 6, dtype=torch.float64, device="cpu")
    d, e = real(a[None], bw=6, device="cpu")
    want = torch.linalg.svdvals(a)
    assert float((tbs.bidiag_singular_values(d, e)[0] - want).abs().max()
                 ) <= 1e-12 * float(want[0])


# ---------------------------------------------------------------------------
# the CLI and resolve(autotune=True)
# ---------------------------------------------------------------------------

def test_parse_shapes():
    assert parse_shapes("n=512:bw=32, n=256:bw=16") == [(512, 32),
                                                        (256, 16)]
    for bad in ("n=512", "", "n=x:bw=3"):
        with pytest.raises(SystemExit):
            parse_shapes(bad)


def test_cli_tunes_on_the_cpu_and_resolve_picks_it_up(tmp_path, monkeypatch,
                                                      capsys):
    p = str(tmp_path / "cache.json")
    monkeypatch.setenv(tcache.ENV_VAR, p)
    rc = autotune_main(["--shapes", "n=96:bw=8", "--backend", "ref",
                        "--device", "cpu", "--top-k", "1", "--warmup", "0",
                        "--iters", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "predicted_us" in out and "model rank of measured best:" in out
    entry = tcache.lookup(device_kind="cpu", n=96, bw=8, dtype="float32",
                          compute_uv=False, backend="ref")
    assert entry is not None and "max_batch" not in entry
    cfg = PipelineConfig.resolve(n=96, bw=8, device="cpu", autotune=True)
    assert (cfg.tw, cfg.fuse) == (entry["tw"], entry["fuse"])
    assert autotune_main(["--shapes", "n=40:bw=8", "--device", "cpu",
                          "--dtype", "float64", "--stage3-crossover",
                          "--warmup", "0", "--iters", "1"]) == 0
    assert "dc_n_min" in capsys.readouterr().out
    dc_n_min = tcache.lookup_stage3(device_kind="cpu", dtype="float64",
                                    compute_uv=False)
    assert dc_n_min in (40, 41)
    cfg = PipelineConfig.resolve(bw=8, dtype=torch.float64, device="cpu",
                                 stage3="auto", autotune=True)
    assert cfg.dc_n_min == dc_n_min


def test_resolve_explicit_kwargs_beat_cache_and_miss_keeps_defaults(
        tmp_path):
    p = str(tmp_path / "cache.json")
    tcache.store({"tw": 3, "fuse": 4, "max_batch": 7}, device_kind="cpu",
                 n=128, bw=16, dtype="float64", compute_uv=False,
                 backend="ref", path=p)
    tcache.store_stage3({"dc_n_min": 1000}, device_kind="cpu",
                        dtype="float64", compute_uv=False, path=p)
    kw = dict(n=128, bw=16, dtype=torch.float64, device="cpu",
              autotune=True, autotune_cache=p)
    cfg = PipelineConfig.resolve(**kw)
    assert (cfg.tw, cfg.fuse, cfg.dc_n_min) == (3, 4, 1000)
    cfg = PipelineConfig.resolve(tw=8, fuse=2, dc_n_min=50, **kw)
    assert (cfg.tw, cfg.fuse, cfg.dc_n_min) == (8, 2, 50)
    # another n, dtype or backend misses: the analytic defaults
    for miss in (dict(n=256), dict(dtype=torch.float32),
                 dict(backend="fused_small")):
        with_at = PipelineConfig.resolve(**{**kw, **miss})
        without = PipelineConfig.resolve(
            **{**kw, **miss, "autotune": False})
        assert (with_at.tw, with_at.fuse) == (without.tw, without.fuse)
    assert PipelineConfig.resolve(
        **{**kw, "autotune_cache": str(tmp_path / "none.json")}) == \
        PipelineConfig.resolve(**{**kw, "autotune": False})


def test_measure_helpers():
    calls = []
    med = tmeasure.measure_seconds(lambda: calls.append(1), warmup=2,
                                   iters=3, device="cpu")
    assert len(calls) == 5 and med >= 0
    a = tmeasure.banded_input(12, 3, batch=2, dtype=torch.float64,
                              device="cpu")
    assert a.shape == (2, 12, 12) and a.dtype == torch.float64
    assert torch.equal(a, torch.triu(a) - torch.triu(a, 4))
    assert tmeasure.time_stage2(24, 4, tw=2, fuse=2, backend="ref",
                                warmup=0, iters=1, device="cpu") > 0
