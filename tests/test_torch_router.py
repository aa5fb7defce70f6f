"""The port's serving fabric across processes against the reference's
``tests/test_router.py``, on the CPU: the wire protocol (frames byte for
byte the reference's, both ways), the router (rendezvous owners equal to
the reference router's, the same seeded stream through both fleets,
admission, unrouted drain, host-drop requeue, stats and the fleet view),
``launch.mesh.serve_mesh`` and ``init_distributed``.

Most tests drive the router with in-process workers (daemon threads
dialing the router's real TCP socket on localhost: the full protocol, no
subprocess).  The ``distributed``-marked tests start real worker processes
(``spawn_worker_process(..., device="cpu")``): a round trip, a SIGKILL
mid-stream, a two-process gloo group, and a worker refused a card.  Every
wait is bounded."""

import os
import signal
import socket
import struct
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.obs import StreamingHistogram
from repro_torch.serve import (FaultPlan, HostDownError, QueueFullError,
                               ServeMetrics, SVDRequest, SVDRouter)
from repro_torch.serve import wire
from repro_torch.serve.wire import WireClosed, recv_msg, send_msg
from repro_torch.serve.worker import (spawn_worker_process,
                                      start_inprocess_worker)

torch.set_num_threads(2)

BW = 4
FAST_ENGINE = dict(device="cpu", batch_window_s=0.005)


def dense(seed, n=12):
    return np.random.default_rng(seed).standard_normal((n, n))


def check_sigma(req, matrix):
    ref = np.linalg.svd(matrix, compute_uv=False)
    err = float(np.abs(np.asarray(req.sigma) - ref).max() / ref.max())
    assert err < 1e-12, err


def key_of(n, uv=False):
    return (n, BW, "float64", False, uv)


def make_fleet(nhosts=2, *, engine_kwargs=FAST_ENGINE, **router_kwargs):
    """A router and ``nhosts`` in-process workers, connected one at a time
    so that the router lists them in the order w0, w1, ... (a FaultPlan's
    victim is drawn by position in that list)."""
    router = SVDRouter(**router_kwargs)
    workers = []
    for i in range(nhosts):
        workers.append(start_inprocess_worker(
            router.address, f"w{i}", engine_kwargs=dict(engine_kwargs)))
        assert router.wait_for_hosts(i + 1, timeout=60)
    assert list(router._hosts) == [f"w{i}" for i in range(nhosts)]
    return router, workers


def reap(procs):
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=30)


# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------

def raw_frame(send, header, arrays):
    """The bytes ``send`` writes for one frame."""
    a, b = socket.socketpair()
    try:
        send(a, header, arrays)
        hlen, plen = struct.unpack(">II", b.recv(8, socket.MSG_WAITALL))
        body = b""
        while len(body) < hlen + plen:
            body += b.recv(hlen + plen - len(body))
        return struct.pack(">II", hlen, plen) + body
    finally:
        a.close()
        b.close()


FRAMES = [
    ({"type": "req", "rid": 3, "uid": 7, "bw": 4, "banded": False,
      "compute_uv": True, "timeout_s": 1.25},
     {"matrix": np.random.default_rng(0).standard_normal((7, 7))}),
    ({"type": "res", "rid": 9, "ok": True, "tier": "fused"},
     {"sigma": np.linspace(3.0, 1e-300, 5),
      "u": np.arange(4, dtype=np.float32).reshape(2, 2),
      "vt": np.arange(6, dtype=np.int64).reshape(3, 2)[::2]}),
    ({"type": "ping", "seq": 12}, None),
    ({"type": "hello", "host_id": "w0", "pid": 1, "devices": 1,
      "global_devices": 2, "process_index": 0, "processes": 2}, {})]


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_wire_frames_byte_identical_to_the_reference(i):
    from repro.serve import wire as rwire
    header, arrays = FRAMES[i]
    mine = raw_frame(send_msg, header, arrays)
    assert mine == raw_frame(rwire.send_msg, header, arrays)
    # both ways: a frame of either side parses on the other, bit for bit
    for send, recv in ((send_msg, rwire.recv_msg), (rwire.send_msg,
                                                    recv_msg)):
        a, b = socket.socketpair()
        try:
            send(a, header, arrays)
            got_h, got_a = recv(b)
        finally:
            a.close()
            b.close()
        assert got_h == header
        assert sorted(got_a) == sorted(arrays or {})
        for name, arr in (arrays or {}).items():
            assert got_a[name].dtype == arr.dtype
            np.testing.assert_array_equal(got_a[name], arr)


def test_wire_fp64_round_trip_bit_for_bit_and_tensors_from_host():
    rng = np.random.default_rng(1)
    m = rng.standard_normal((9, 9)) * np.exp(rng.uniform(-700, 700, (9, 9)))
    t = torch.tensor(m)
    a, b = socket.socketpair()
    try:
        send_msg(a, {"type": "res"}, {"m": m, "t": t, "s": t[::2, 1::3]})
        _, got = recv_msg(b)
    finally:
        a.close()
        b.close()
    assert got["m"].tobytes() == m.tobytes()
    assert got["t"].tobytes() == m.tobytes()
    np.testing.assert_array_equal(got["s"], m[::2, 1::3])
    assert wire.host_array(t).flags.c_contiguous


def test_wire_closed_on_eof_and_oversized_frame():
    a, b = socket.socketpair()
    a.close()
    with pytest.raises(WireClosed):
        recv_msg(b)
    b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">II", wire.MAX_FRAME_BYTES, 1))
        with pytest.raises(WireClosed, match="oversized"):
            recv_msg(b)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# rendezvous owners
# ---------------------------------------------------------------------------

def test_owner_of_equals_the_reference_router():
    from repro.serve.router import SVDRouter as RRouter
    mine, ref = SVDRouter(), RRouter()
    try:
        for hosts in (["w0", "w1"], ["w0", "w1", "w2"], ["a", "b", "c", "d"],
                      ["w1"]):
            alive = {h: types.SimpleNamespace(alive=True) for h in hosts}
            mine._hosts, ref._hosts = dict(alive), dict(alive)
            for n in (8, 12, 16, 24, 64, 96, 1024, 4096):
                for bw in (4, 8, 64):
                    for dt in ("float64", "float32"):
                        for banded in (False, True):
                            for uv in (False, True):
                                key = (n, bw, dt, banded, uv)
                                assert mine.owner_of(key) == ref.owner_of(key)
        mine._hosts, ref._hosts = {}, {}
    finally:
        mine.stop()
        ref.stop()


# ---------------------------------------------------------------------------
# router + in-process workers: the reference's fleet and the port's
# ---------------------------------------------------------------------------

def test_same_stream_through_both_fleets():
    """One seeded stream through the reference's router over two
    in-process reference workers and through the port's over two port
    workers on the CPU: per-uid sigma within 1e-12 of sigma_max, and the
    same completions per host."""
    from repro.serve import SVDRequest as RRequest
    from repro.serve.router import SVDRouter as RRouter
    from repro.serve.worker import start_inprocess_worker as rstart
    rng = np.random.default_rng(5)
    stream = [(uid, int(rng.choice([12, 16])), bool(rng.random() < 0.25))
              for uid in range(12)]
    mats = {uid: rng.standard_normal((n, n)) for uid, n, _ in stream}
    out = {}
    for side in ("reference", "port"):
        if side == "reference":
            router = RRouter()
            for i in range(2):
                rstart(router.address, f"w{i}", engine_kwargs=dict(
                    backend="ref", batch_window_s=0.005))
            make = RRequest
        else:
            router = SVDRouter()
            for i in range(2):
                start_inprocess_worker(router.address, f"w{i}",
                                       engine_kwargs=dict(FAST_ENGINE))
            make = SVDRequest
        try:
            assert router.wait_for_hosts(2, timeout=120)
            futs = {uid: router.submit(make(uid=uid, matrix=mats[uid], bw=BW,
                                            compute_uv=uv))
                    for uid, _n, uv in stream}
            done = {uid: f.result(timeout=300) for uid, f in futs.items()}
            snap = router.metrics.snapshot()
        finally:
            router.stop()
        out[side] = (done, {h: row["completed"]
                            for h, row in snap["hosts"].items()})
    (rdone, rhosts), (tdone, thosts) = out["reference"], out["port"]
    assert thosts == rhosts and sum(thosts.values()) == 12
    assert len(thosts) == 2                     # both hosts served
    for uid, _n, uv in stream:
        s = np.asarray(rdone[uid].sigma)
        assert np.abs(tdone[uid].sigma - s).max() <= 1e-12 * s[0]
        if uv:
            a = mats[uid]
            r = tdone[uid]
            assert np.abs((r.u * r.sigma) @ r.vt - a).max() <= 1e-12 * s[0]


def test_router_serves_and_attributes_hosts():
    router, _ = make_fleet(2)
    try:
        mats = [dense(i) for i in range(6)]
        futs = [router.submit(SVDRequest(uid=i, matrix=m, bw=BW))
                for i, m in enumerate(mats)]
        for m, f in zip(mats, futs):
            check_sigma(f.result(timeout=120), m)
        snap = router.metrics.snapshot()
        assert snap["completed"] == 6 and snap["failed"] == 0
        assert sum(h["completed"] for h in snap["hosts"].values()) == 6
        fleet = router.fleet()
        per_host = fleet["latency"]["per_host_summary"]
        assert (sum(s["count"] for s in per_host.values())
                == fleet["latency"]["merged_summary"]["count"] == 6)
        assert sorted(fleet["alive_hosts"]) == ["w0", "w1"]
        # a tensor request goes on the wire from host memory
        t = torch.tensor(dense(9))
        check_sigma(router.submit(SVDRequest(uid=9, matrix=t, bw=BW)).result(
            timeout=120), t.numpy())
    finally:
        router.stop()


def test_rendezvous_affinity_pins_buckets():
    router, _ = make_fleet(2)
    try:
        owner = router.owner_of(key_of(12))
        assert owner in ("w0", "w1")
        futs = [router.submit(SVDRequest(uid=i, matrix=dense(i), bw=BW))
                for i in range(4)]
        [f.result(timeout=120) for f in futs]
        snap = router.metrics.snapshot()
        assert snap["hosts"][owner]["dispatched"] == 4
        other = "w1" if owner == "w0" else "w0"
        assert snap["hosts"].get(other, {}).get("dispatched", 0) == 0
        assert router.owner_of(key_of(12)) == owner
    finally:
        router.stop()


def test_admission_refusals_resolve_futures():
    router = SVDRouter(max_pending=1)
    try:
        bad = router.submit(SVDRequest(uid=0, matrix=np.zeros((3, 4)),
                                       bw=BW))
        with pytest.raises(ValueError):
            bad.result(timeout=5)
        ok = router.submit(SVDRequest(uid=1, matrix=dense(1), bw=BW))
        full = router.submit(SVDRequest(uid=2, matrix=dense(2), bw=BW))
        with pytest.raises(QueueFullError):
            full.result(timeout=5)
        snap = router.metrics.snapshot()
        assert snap["rejected"] == 2 and snap["submitted"] == 1
        assert not ok.done()
    finally:
        router.stop(drain=False)
    stopped = SVDRouter()
    stopped.stop()
    fut = stopped.submit(SVDRequest(uid=0, matrix=dense(0), bw=BW))
    with pytest.raises(RuntimeError):
        fut.result(timeout=5)


def test_unrouted_request_drains_when_host_arrives():
    router = SVDRouter()
    try:
        m = dense(3)
        fut = router.submit(SVDRequest(uid=0, matrix=m, bw=BW))
        assert router.pending() == 1 and not fut.done()
        start_inprocess_worker(router.address, "w0",
                               engine_kwargs=dict(FAST_ENGINE))
        check_sigma(fut.result(timeout=120), m)
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# host drop
# ---------------------------------------------------------------------------

def test_fault_plan_victim_equals_the_reference():
    from repro.serve import FaultPlan as RFaultPlan
    hosts = ["w0", "w1", "w2"]
    for seed in range(6):
        for kw in (dict(host_loss_at=(0, 3)), dict(host_loss_rate=0.4)):
            mine, ref = FaultPlan(seed=seed, **kw), RFaultPlan(seed=seed, **kw)
            assert ([mine.lose_host(hosts) for _ in range(8)]
                    == [ref.lose_host(hosts) for _ in range(8)])


def test_host_drop_requeues_inflight_exactly_once():
    from repro.serve import FaultPlan as RFaultPlan
    victim = FaultPlan(seed=11, host_loss_at=(0,)).lose_host(["w0", "w1"])
    assert victim == RFaultPlan(seed=11, host_loss_at=(0,)).lose_host(
        ["w0", "w1"])
    plan = FaultPlan(seed=11, host_loss_at=(0,))
    router, _ = make_fleet(
        2, engine_kwargs=dict(device="cpu", batch_window_s=0.75),
        heartbeat_s=60.0, heartbeat_timeout_s=120.0, faults=plan)
    try:
        n = next(c for c in range(8, 64)
                 if router.owner_of(key_of(c)) == victim)
        mats = [dense(i, n) for i in range(5)]
        futs, resolutions = [], []
        for i, m in enumerate(mats):
            f = router.submit(SVDRequest(uid=i, matrix=m, bw=BW))
            f.add_done_callback(lambda _f: resolutions.append(1))
            futs.append(f)
        time.sleep(0.1)          # land in the victim's batch window
        assert router.pending() == 5
        router._heartbeat_tick()     # deterministic tick (no wall clock)
        for m, f in zip(mats, futs):
            check_sigma(f.result(timeout=120), m)
        assert len(resolutions) == 5     # every future exactly once
        snap = router.metrics.snapshot()
        survivor = "w0" if victim == "w1" else "w1"
        assert snap["retried"] == 5
        assert snap["quarantined"] == 1
        assert f"host:{victim}" in snap["quarantined_buckets"]
        assert snap["hosts"][survivor]["requeued"] == 5
        assert snap["hosts"][survivor]["completed"] == 5
        assert victim not in router.alive_hosts()
        assert victim in router.fleet()["dead_hosts"]
        assert plan.snapshot()["host_loss"] == 1
    finally:
        router.stop()
    assert issubclass(HostDownError, ConnectionError)


# ---------------------------------------------------------------------------
# fleet observability
# ---------------------------------------------------------------------------

def test_hist_merged_and_host_attribution():
    h1, h2 = StreamingHistogram(), StreamingHistogram()
    for v in (0.01, 0.02, 0.04):
        h1.add(v)
    h2.add(0.08)
    assert StreamingHistogram.merged([h1, h2.to_dict()]).count == 4
    assert StreamingHistogram.merged([]).count == 0
    m = ServeMetrics()
    m.add_host("w0", dispatched=2, completed=1)
    m.add_host("w1", requeued=3)
    snap = m.snapshot()
    assert snap["hosts"]["w0"] == {"dispatched": 2, "completed": 1,
                                   "failed": 0, "requeued": 0}
    assert snap["hosts"]["w1"]["requeued"] == 3


def test_collect_host_stats_and_fleet_render():
    router, _ = make_fleet(2)
    try:
        futs = [router.submit(SVDRequest(uid=i, matrix=dense(i), bw=BW))
                for i in range(3)]
        [f.result(timeout=120) for f in futs]
        stats = router.collect_host_stats(timeout=30)
        assert sorted(stats) == ["w0", "w1"]
        for payload in stats.values():
            assert "snapshot" in payload and "histograms" in payload
        hosts = router.fleet()["hosts"]
        for row in hosts.values():
            assert row["devices"] == 1 and row["device"] == "cpu"
            assert row["processes"] == 1 and row["global_devices"] == 1
        from repro_torch.obs import render_fleet_metrics
        text = render_fleet_metrics(router.fleet())
        assert 'repro_fleet_host_up{host="w0"} 1' in text
        assert "repro_fleet_hosts_alive 2" in text
        for line in text.splitlines():
            if line and not line.startswith("#"):
                name, _, value = line.rpartition(" ")
                float(value)
                assert name
    finally:
        router.stop()


def test_metrics_server_fleet_provider():
    import urllib.request

    from repro_torch.obs import MetricsServer, render_fleet_metrics
    router, _ = make_fleet(1)
    server = MetricsServer(port=0)
    try:
        server.register("router", router.metrics)
        server.register_provider(
            "fleet", lambda: render_fleet_metrics(router.fleet()))
        router.submit(SVDRequest(uid=0, matrix=dense(0),
                                 bw=BW)).result(timeout=120)
        with urllib.request.urlopen(server.url, timeout=10) as resp:
            text = resp.read().decode("utf-8")
        assert "repro_fleet_hosts_alive 1" in text
        assert "repro_serve_requests_total" in text
    finally:
        server.stop()
        router.stop()


# ---------------------------------------------------------------------------
# serve_mesh and init_distributed
# ---------------------------------------------------------------------------

def test_serve_mesh_env_parsing(monkeypatch):
    from repro_torch.launch import mesh as meshmod
    monkeypatch.delenv("REPRO_SERVE_MESH", raising=False)
    assert meshmod.serve_mesh() is None
    for spec in ("", "1", "auto", "0"):
        monkeypatch.setenv("REPRO_SERVE_MESH", spec)
        if not torch.cuda.is_available():
            assert meshmod.serve_mesh() is None   # never a CPU mesh
    monkeypatch.setenv("REPRO_SERVE_MESH", "two")
    with pytest.raises(ValueError, match="REPRO_SERVE_MESH"):
        meshmod.serve_mesh()
    # four local cards: "auto" takes them all, a count is clamped to them
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("REPRO_SERVE_MESH", "auto")
    mesh = meshmod.serve_mesh()
    assert mesh.shape == {"data": 4}
    assert list(mesh) == [torch.device(f"cuda:{i}") for i in range(4)]
    monkeypatch.setenv("REPRO_SERVE_MESH", "8")
    assert meshmod.serve_mesh().shape["data"] == 4
    monkeypatch.setenv("REPRO_SERVE_MESH", "2")
    assert meshmod.serve_mesh().devices == (torch.device("cuda:0"),
                                            torch.device("cuda:1"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert meshmod.serve_mesh() is None


def test_a_pinned_worker_sees_one_card_and_no_mesh():
    """``spawn_worker_process(card=i)``: the worker's environment shows it
    card i of this process's visible cards, and no ``$REPRO_SERVE_MESH``;
    unpinned, both pass through unchanged."""
    from repro_torch.serve.worker import _child_env
    base = {"REPRO_SERVE_MESH": "auto", "PYTHONPATH": "x"}
    env = _child_env(base, None)
    assert env["REPRO_SERVE_MESH"] == "auto"
    assert "CUDA_VISIBLE_DEVICES" not in env
    assert env["PYTHONPATH"].endswith(os.pathsep + "x")
    assert _child_env(base, 1)["CUDA_VISIBLE_DEVICES"] == "1"
    assert "REPRO_SERVE_MESH" not in _child_env(base, 1)
    vis = dict(base, CUDA_VISIBLE_DEVICES="4, 6")
    assert [_child_env(vis, i)["CUDA_VISIBLE_DEVICES"]
            for i in range(3)] == ["4", "6", "4"]
    assert base == {"REPRO_SERVE_MESH": "auto", "PYTHONPATH": "x"}


def test_init_distributed_unconfigured_is_noop(monkeypatch):
    from repro_torch.launch import mesh as meshmod
    for var in ("REPRO_DIST_COORDINATOR", "REPRO_DIST_NUM_PROCESSES",
                "REPRO_DIST_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert meshmod.init_distributed() is False
    assert meshmod.init_distributed(coordinator="127.0.0.1:1",
                                    num_processes=1,
                                    process_id=0) is False


# ---------------------------------------------------------------------------
# real worker processes
# ---------------------------------------------------------------------------

@pytest.mark.distributed
def test_subprocess_worker_roundtrip():
    router = SVDRouter()
    proc = spawn_worker_process(router.address, "w0", device="cpu")
    try:
        assert router.wait_for_hosts(1, timeout=120)
        mats = [dense(i) for i in range(3)]
        futs = [router.submit(SVDRequest(uid=i, matrix=m, bw=BW))
                for i, m in enumerate(mats)]
        for m, f in zip(mats, futs):
            check_sigma(f.result(timeout=120), m)
        info = router.fleet()["hosts"]["w0"]
        assert info["alive"] and info["devices"] == 1
        assert info["pid"] == proc.pid
    finally:
        router.stop()
        reap([proc])


@pytest.mark.distributed
def test_subprocess_sigkill_requeues_to_survivor():
    router = SVDRouter(heartbeat_s=0.25, heartbeat_timeout_s=2.0)
    procs = {f"w{i}": spawn_worker_process(router.address, f"w{i}",
                                           device="cpu", window_ms=500.0)
             for i in range(2)}
    try:
        assert router.wait_for_hosts(2, timeout=120)
        router.warm([SVDRequest(uid=-1, matrix=dense(99), bw=BW)],
                    timeout=120)
        victim = router.owner_of(key_of(12))
        mats = [dense(i) for i in range(4)]
        resolutions = []
        futs = []
        for i, m in enumerate(mats):
            f = router.submit(SVDRequest(uid=i, matrix=m, bw=BW))
            f.add_done_callback(lambda _f: resolutions.append(1))
            futs.append(f)
        procs[victim].send_signal(signal.SIGKILL)
        for m, f in zip(mats, futs):
            check_sigma(f.result(timeout=120), m)
        assert len(resolutions) == 4
        snap = router.metrics.snapshot()
        survivor = "w0" if victim == "w1" else "w1"
        assert snap["retried"] >= 1
        assert snap["hosts"][survivor]["completed"] >= 4
        assert victim in router.fleet()["dead_hosts"]
        assert procs[victim].wait(timeout=30) is not None
    finally:
        router.stop()
        reap(procs.values())


@pytest.mark.distributed
def test_gloo_group_of_two_worker_processes():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    router = SVDRouter()
    procs = [spawn_worker_process(router.address, f"w{i}", device="cpu",
                                  coordinator=coordinator, num_processes=2,
                                  process_id=i)
             for i in range(2)]
    try:
        assert router.wait_for_hosts(2, timeout=120)
        hosts = router.fleet()["hosts"]
        local_total = sum(v["devices"] for v in hosts.values())
        assert sorted(v["process_index"] for v in hosts.values()) == [0, 1]
        for v in hosts.values():
            assert v["processes"] == 2
            assert v["global_devices"] == local_total == 2
        m = dense(7)
        check_sigma(router.submit(
            SVDRequest(uid=0, matrix=m, bw=BW)).result(timeout=120), m)
    finally:
        router.stop()
        reap(procs)


@pytest.mark.distributed
def test_worker_without_its_card_exits_naming_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run(
        [sys.executable, "-c",
         "from repro_torch.serve.worker import main; main()",
         "--connect", "127.0.0.1:9", "--host-id", "w0"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ,
                 PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src")))
    assert res.returncode != 0
    assert "--device cpu" in res.stderr
