"""The port's observability (``repro_torch.obs``) against the reference's
``tests/test_obs.py``, on the CPU: span semantics, the no-op guard under
torch.compile and CUDA graph capture, the streaming histogram, the JSONL
round trip, the Prometheus endpoint, the first-dispatch ``<name>/run``
span with its ``build`` children, the kernel build's lock, the stage spans
of the SVD entry points (coverage of one traced ``svd_batched`` call, the
uv path's replay children, sigma bit for bit the untraced one and the
reference's within 1e-12), and the serve engine's dispatch spans."""

import json
import os
import re
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import svd as jsvd
from repro.core.tuning import PipelineConfig as JConfig
from repro_torch import obs
from repro_torch.autotune import measure
from repro_torch.core import svd as tsvd
from repro_torch.core.tuning import PipelineConfig
from repro_torch.kernels import _build
from repro_torch.obs import (MetricsServer, StreamingHistogram, Tracer,
                             load_jsonl, render_serve_metrics)
from repro_torch.serve import (ServeMetrics, SVDEngine, SVDRequest,
                               bucket_key_str)

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_span_nesting_attrs_and_timing():
    tr = Tracer("t")
    with tr.span("root", n=8) as root:
        with tr.span("child_a") as a:
            a.set(bw=4)
        with tr.span("child_b"):
            pass
    assert [r.name for r in tr.roots] == ["root"]
    assert [c.name for c in root.children] == ["child_a", "child_b"]
    assert root.attrs["n"] == 8
    assert root.children[0].attrs["bw"] == 4
    assert root.dur_s >= root.total_child_seconds() > 0.0
    assert root.find("child_b") == [root.children[1]]


def test_span_exception_safety():
    tr = Tracer("t")
    with pytest.raises(ValueError, match="boom"):
        with tr.span("outer"):
            with tr.span("inner"):
                raise ValueError("boom")
    (outer,) = tr.roots
    (inner,) = outer.children
    assert "boom" in inner.attrs["error"]
    assert "boom" in outer.attrs["error"]
    with tr.span("after"):
        pass
    assert [r.name for r in tr.roots] == ["outer", "after"]


def test_ambient_tracer_and_null_span():
    with obs.span("orphan") as sp:
        sp.set(x=1)
    tr = Tracer("ambient")
    with obs.activated(tr):
        assert obs.current() is tr
        with obs.span("seen"):
            pass
    assert obs.current() is not tr
    assert [r.name for r in tr.roots] == ["seen"]
    prev = obs.install(tr)
    try:
        seen = []
        t = threading.Thread(target=lambda: seen.append(obs.current()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive() and seen == [tr]
    finally:
        obs.install(prev)


def test_spans_are_noop_under_compile_and_capture(monkeypatch):
    """The reference's jit-tracing no-op: no host span while torch.compile
    traces or a CUDA graph is captured (where a fence would be illegal)."""
    tr = Tracer("t")
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with obs.activated(tr):
        with obs.span("inside-compile") as sp:
            assert sp is obs.span("other")
        assert tr.jit_call("f", lambda x: x + 1, 1) == 2
    assert tr.roots == []
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with obs.activated(tr):
        with obs.span("inside-capture"):
            pass
    assert tr.roots == []


def test_no_tracer_no_fence(monkeypatch):
    """With no tracer the pipeline's spans never synchronize; on the CPU a
    traced call never does either (nothing to fence)."""
    def forbidden(*a, **k):
        raise AssertionError("synchronize called")
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    cfg = PipelineConfig.resolve(n=12, bw=4, tw=2, backend="ref",
                                 dtype=torch.float64, device="cpu")
    mats = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 12, 12)))
    plain = tsvd.svd_batched(mats, cfg)
    assert obs.span("x") is obs.span("y")        # the one shared null span
    traced = tsvd.svd_batched(mats, cfg, trace=Tracer("t"))
    assert torch.equal(plain, traced)


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------

def test_histogram_percentiles_within_one_bucket():
    rng = np.random.default_rng(0)
    samples = rng.lognormal(mean=-4.0, sigma=1.2, size=5000)
    h = StreamingHistogram()
    h.extend(samples)
    r = h.bucket_width_ratio()
    for q in (50, 95, 99):
        exact = float(np.percentile(samples, q, method="higher"))
        assert exact / r <= h.percentile(q) <= exact * r, q
    assert h.count == samples.size
    assert h.min == samples.min() and h.max == samples.max()
    np.testing.assert_allclose(h.mean, samples.mean())


def test_histogram_concurrent_merge_matches_numpy():
    rng = np.random.default_rng(1)
    chunks = [rng.lognormal(mean=-5.0, sigma=1.0, size=2000)
              for _ in range(4)]
    hists = [StreamingHistogram() for _ in chunks]

    def fill(h, vals):
        for v in vals:
            h.add(v)

    threads = [threading.Thread(target=fill, args=(h, c))
               for h, c in zip(hists, chunks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    merged = hists[0]
    for h in hists[1:]:
        merged.merge(h)
    allv = np.concatenate(chunks)
    one = StreamingHistogram()
    one.extend(allv)
    assert merged.count == allv.size
    np.testing.assert_array_equal(merged.counts(), one.counts())
    r = merged.bucket_width_ratio()
    for q in (50, 95, 99):
        exact = float(np.percentile(allv, q, method="higher"))
        assert exact / r <= merged.percentile(q) <= exact * r


def test_histogram_merge_scheme_mismatch_raises():
    with pytest.raises(ValueError, match="bucket schemes"):
        StreamingHistogram().merge(StreamingHistogram(buckets_per_decade=5))


def test_histogram_dict_roundtrip_and_reference_parity():
    from repro.obs import StreamingHistogram as JHist
    vals = [1e-4, 3e-3, 3e-3, 0.2, 7.0]
    h = StreamingHistogram()
    h.extend(vals)
    h2 = StreamingHistogram.from_dict(json.loads(json.dumps(h.to_dict())))
    np.testing.assert_array_equal(h.counts(), h2.counts())
    assert (h.count, h.sum, h.min, h.max) == (h2.count, h2.sum,
                                              h2.min, h2.max)
    j = JHist()
    j.extend(vals)
    assert j.to_dict() == h.to_dict()
    for q in (50, 95, 99):
        assert h.percentile(q) == h2.percentile(q) == j.percentile(q)


def test_histogram_bounded_memory_10k():
    m = ServeMetrics()
    key = (64, 8, "float64", False, False)
    m.set_bucket_tier(key, "staged", n=64, backend="ref")
    lats = np.random.default_rng(2).lognormal(mean=-5.0, sigma=0.8,
                                              size=10_000)
    for lat in lats:
        m.observe_latency("staged", key, float(lat))
        m.observe_queue_age(float(lat) / 4)
    hists = m.histograms()
    th = hists["tiers"]["staged"]
    for h in (th, hists["buckets"][bucket_key_str(key)], hists["queue_age"]):
        assert h.count == 10_000
        assert h.counts().size == h.num_buckets == \
            StreamingHistogram().num_buckets
    r = th.bucket_width_ratio()
    for q in (50, 95, 99):
        exact = float(np.percentile(lats, q, method="higher"))
        assert exact / r <= th.percentile(q) <= exact * r
    assert m.snapshot()["latency"]["tiers"]["staged"]["count"] == 10_000
    assert m.health()["latency_p99_ms"]["staged"] > 0


# ---------------------------------------------------------------------------
# JSONL export
# ---------------------------------------------------------------------------

def test_jsonl_roundtrip(tmp_path):
    path = tmp_path / "trace.jsonl"
    tr = Tracer("t", jsonl=str(path))
    with tr.span("root", n=4) as root:
        with tr.span("leaf", stage=1):
            pass
    tr.close()
    (rec,) = load_jsonl(str(path))
    assert rec.name == "root" and rec.attrs["n"] == 4
    (leaf,) = rec.children
    assert leaf.name == "leaf" and leaf.attrs["stage"] == 1
    assert rec.dur_s == pytest.approx(root.dur_s)
    assert rec.total_child_seconds() == pytest.approx(
        root.total_child_seconds())


def test_jsonl_exporter_threaded(tmp_path):
    path = tmp_path / "t.jsonl"
    tr = Tracer("t", jsonl=str(path))

    def work(i):
        with tr.span(f"w{i}"):
            with tr.span("inner"):
                pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    tr.close()
    roots = load_jsonl(str(path))
    assert sorted(r.name for r in roots) == [f"w{i}" for i in range(8)]
    assert all(len(r.children) == 1 for r in roots)


# ---------------------------------------------------------------------------
# first dispatch and the kernel build (the reference's compile split)
# ---------------------------------------------------------------------------

def test_jit_call_run_span_on_first_dispatch_only():
    calls = {"n": 0}

    def f(x):
        calls["n"] += 1
        return (x * x).sum()

    tr = Tracer("t")
    x = torch.arange(8, dtype=torch.float32)
    with tr.span("outer"):
        out1 = tr.jit_call("f", f, x)
    with tr.span("outer"):
        out2 = tr.jit_call("f", f, x)
    with tr.span("outer"):
        tr.jit_call("f", f, x[:4])               # another shape: first again
    assert torch.equal(out1, out2) and calls["n"] == 3
    first, second, third = tr.roots
    assert [c.name for c in first.children] == ["f/run"]
    assert second.children == []
    assert [c.name for c in third.children] == ["f/run"]
    assert obs.traced_jit_call("f", f, x) == out1    # no tracer: plain


class _FakeNvcc:
    """``subprocess.Popen`` for ``_build``: writes the output file after a
    pause (so that two threads' builds would overlap), counts the builds."""

    def __init__(self):
        self.cmds = []
        self.lock = threading.Lock()

    def __call__(self, cmd, **kw):
        with self.lock:
            self.cmds.append(cmd)

        class Proc:
            returncode = 0

            def communicate(self):
                time.sleep(0.2)
                out = cmd[cmd.index("-o") + 1]
                with open(out, "w") as fh:
                    fh.write("built")
                return "ptxas info", None

        return Proc()


@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    fake = _FakeNvcc()
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", fake)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: ("lib", os.path.basename(path)))
    return fake


def test_build_lock_two_threads_one_build(stub_build):
    """Two threads that load one source at once run one build and get one
    library; the temporary file is named by process and thread."""
    barrier = threading.Barrier(2)
    got, idents = [None, None], [None, None]

    def worker(i):
        idents[i] = threading.get_ident()
        barrier.wait(timeout=30)
        got[i] = _build.load("chase")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(stub_build.cmds) == 1
    assert got[0] is got[1] and got[0][0] == "lib"
    tmp = stub_build.cmds[0][stub_build.cmds[0].index("-o") + 1]
    assert re.search(rf"\.{os.getpid()}\.({idents[0]}|{idents[1]})\.tmp$",
                     tmp)
    assert _build.load("chase") is got[0]        # loaded once, kept
    assert len(stub_build.cmds) == 1


def test_build_span_wraps_a_build_it_performs(stub_build):
    """The compile split of the reference becomes the ``build`` span: a
    first dispatch that builds shows it under its ``<name>/run`` span; a
    library already built or loaded opens none."""
    tr = Tracer("t")
    with obs.activated(tr):
        with tr.span("outer"):
            tr.jit_call("stage", lambda: _build.load("sturm"))
        _build.load("sturm")                     # loaded: no span
        _build._LIBS.clear()
        _build.load("sturm")                     # on disk: no build, no span
    (outer,) = tr.roots
    (run,) = outer.children
    assert run.name == "stage/run"
    (build,) = run.children
    assert build.name == "build" and build.attrs == {"kernel": "sturm"}
    assert len(stub_build.cmds) == 1
    assert len(outer.find("build")) == 1


def test_measure_seconds_spans():
    tr = Tracer("t")
    with obs.activated(tr):
        med = measure.measure_seconds(lambda: torch.ones(4).sum(),
                                      warmup=2, iters=3, device="cpu",
                                      label="probe")
    (root,) = tr.roots
    assert root.name == "probe" and root.attrs["median_s"] == med
    names = [c.name for c in root.children]
    assert names == ["warmup", "warmup", "rep", "rep", "rep"]
    assert root.children[0].attrs["compile"] == "warmup0"


# ---------------------------------------------------------------------------
# metrics endpoint
# ---------------------------------------------------------------------------

def test_metrics_server_scrape():
    m = ServeMetrics()
    m.add(submitted=3, completed=3, batches=1, served_slots=3)
    m.add_tier("fused", batches=1, served_slots=3, padded_slots=1)
    key = (16, 4, "float64", False, False)
    m.set_bucket_tier(key, "fused", n=16, backend="fused_small")
    for lat in (0.002, 0.004, 0.008):
        m.observe_latency("fused", key, lat)
        m.observe_queue_age(lat / 2)
    srv = MetricsServer(port=0)
    try:
        srv.register("svd", m)
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            assert resp.status == 200
            assert "version=0.0.4" in resp.headers["Content-Type"]
            text = resp.read().decode("utf-8")
    finally:
        srv.stop()
    assert 'repro_serve_requests_total{engine="svd",event="submitted"} 3' \
        in text
    assert 'tier="fused"' in text
    assert f'bucket="{bucket_key_str(key)}"' in text
    assert "repro_serve_queue_age_seconds_count" in text
    assert "repro_serve_health_status" in text
    by_series = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_part, _, value = line.rpartition(" ")
        float(value)
        assert name_part
        if "_bucket{" in name_part:
            series = re.sub(r'le="[^"]*",?', "", name_part)
            by_series.setdefault(series, []).append(float(value))
    for series, counts in by_series.items():
        assert counts == sorted(counts), series
    assert ('repro_serve_latency_seconds_count{engine="svd",tier="fused"} 3'
            in text)


def test_render_matches_reference_exposition():
    from repro.obs import render_serve_metrics as jrender
    from repro.serve.metrics import ServeMetrics as JMetrics
    key = (8, 4, "float64", False, False)
    ours, theirs = ServeMetrics(), JMetrics()
    for m in (ours, theirs):
        m.add(submitted=2, completed=1, failed=1)
        m.set_bucket_tier(key, "staged", n=8, backend="ref")
        m.observe_latency("staged", key, 0.5)
    text = render_serve_metrics(ours, engine="e2")
    assert 'repro_serve_latency_seconds_bucket{engine="e2",le="+Inf",' \
           'tier="staged"} 1' in text
    def samples(t):
        return [ln for ln in t.splitlines() if not ln.startswith("#")]
    assert samples(text) == samples(jrender(theirs, engine="e2"))


# ---------------------------------------------------------------------------
# pipeline: traced entry points
# ---------------------------------------------------------------------------

def test_svd_batched_trace_coverage_and_first_dispatch():
    """One traced ``svd_batched`` call: stage spans cover >= 90 % of the
    root, the first dispatch shows its ``<name>/run`` spans, sigma is bit
    for bit the untraced call's and within 1e-12 of the reference's."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 24, 24))
    cfg = PipelineConfig.resolve(n=24, bw=4, tw=3, backend="ref",
                                 dtype=torch.float64, device="cpu")
    mats = torch.from_numpy(a)
    ref = tsvd.svd_batched(mats, config=cfg)
    want = np.asarray(jsvd.svd_batched(jnp.asarray(a), config=JConfig.resolve(
        n=24, bw=4, tw=3, backend="ref", dtype=np.float64)))
    np.testing.assert_allclose(ref.numpy(), want, rtol=0,
                               atol=1e-12 * want.max())

    tr = Tracer("svd")
    sig = tsvd.svd_batched(mats, config=cfg, trace=tr)
    assert torch.equal(sig, ref)
    (root,) = tr.roots
    assert root.name == "singular_values"
    assert root.attrs["n"] == 24 and root.attrs["batch"] == 3
    assert [c.name for c in root.children] == ["stage1", "stage2", "stage3"]
    assert root.total_child_seconds() / root.dur_s >= 0.90
    assert root.find("stage1/run") and root.find("stage3_bisect/run")
    assert len(root.find("chase_stage")) == len(cfg.plan)

    tr2 = Tracer("svd2")
    tr2._dispatched = tr._dispatched             # the first dispatch is past
    assert torch.equal(tsvd.svd_batched(mats, config=cfg, trace=tr2), ref)
    (root2,) = tr2.roots
    assert not root2.find("stage1/run")
    assert root2.total_child_seconds() / root2.dur_s >= 0.90


def test_svd_uv_trace_has_replay_children():
    cfg = PipelineConfig.resolve(n=16, bw=4, tw=3, backend="ref",
                                 dtype=torch.float64, device="cpu")
    a = np.random.default_rng(1).standard_normal((16, 16))
    tr = Tracer("uv")
    u, s, vt = tsvd.svd(a, config=cfg, compute_uv=True, trace=tr)
    np.testing.assert_allclose((u * s) @ vt, a, atol=1e-12)
    (root,) = tr.roots
    assert root.name == "svd"
    names = [c.name for c in root.children]
    assert names == ["stage1", "stage2", "replay", "stage3", "compose"]
    (replay,) = root.find("replay")
    assert replay.find("replay_stage1")
    assert len(replay.find("replay_chase")) == len(cfg.plan)
    assert root.total_child_seconds() / root.dur_s >= 0.90


def test_fused_and_banded_roots():
    a = np.random.default_rng(2).standard_normal((2, 12, 12))
    fcfg = PipelineConfig.resolve(n=12, bw=4, backend="fused_small",
                                  dtype=torch.float64, device="cpu")
    tr = Tracer("f")
    tsvd.svd_batched(a, fcfg, trace=tr)
    tsvd.banded_singular_values(np.triu(a) - np.triu(a, 5), bw=4,
                                device="cpu", trace=tr)
    fused, banded = tr.roots
    assert [c.name for c in fused.children] == ["fused"]
    assert banded.name == "banded_singular_values"
    assert [c.name for c in banded.children] == ["stage2", "stage3"]


# ---------------------------------------------------------------------------
# serve-tier spans
# ---------------------------------------------------------------------------

def test_engine_dispatch_spans_and_latency_histograms():
    tr = Tracer("serve")
    eng = SVDEngine(backend="ref", device="cpu", tracer=tr)
    rng = np.random.default_rng(3)
    for i in range(4):
        eng.submit(SVDRequest(uid=i, matrix=rng.standard_normal((16, 16)),
                              bw=4))
    done = eng.run()
    assert all(r.error is None for r in done)
    (disp,) = [r for r in tr.roots if r.name == "serve/dispatch"]
    assert disp.attrs["bucket"] == bucket_key_str(
        (16, 4, "float64", False, False))
    assert disp.attrs["tier"] == "fused"
    (entry,) = disp.children
    assert entry.name == "singular_values" and entry.find("fused")
    snap = eng.metrics.snapshot()
    assert sum(row["count"]
               for row in snap["latency"]["tiers"].values()) == 4
    assert snap["latency"]["queue_age"]["count"] == 4
