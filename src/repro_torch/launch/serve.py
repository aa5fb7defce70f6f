"""Serving launchers, after the reference's ``launch/serve.py``: the token
mode (random weights from a seed, a few requests with random prompts of 2
to 8 tokens, answered by the batched token ``Engine``) and ``--svd``, an
open-loop stream of SVD requests answered by ``AsyncSVDEngine``.

  python -m repro_torch.launch.serve --arch phi3-medium-14b --device cpu
  python -m repro_torch.launch.serve --arch phi3-medium-14b --full
  python -m repro_torch.launch.serve --svd --device cpu --requests 16 \\
      --rate 200 --svd-n 32 --svd-bw 4
  python -m repro_torch.launch.serve --svd --hosts 2 --device cpu \\
      --requests 12 --rate 100 --svd-n 24 --svd-bw 4

Without ``--full`` the model is the architecture's smoke variant (tiny
widths).  ``--device`` defaults to the card; without one the run raises,
naming ``--device cpu``.  ``--svd --hosts N`` serves the same stream
through an ``SVDRouter`` in this process over N worker processes, each on
``--device``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, smoke_of
from repro_torch.models import build
from repro_torch.serve import Engine, Request, ServeConfig

__all__ = ["main", "main_svd", "main_svd_multihost", "make_requests",
           "serve"]


def make_requests(cfg, n: int, new_tokens: int, seed: int = 0
                  ) -> list[Request]:
    """``n`` requests with prompts of 2 to 8 random tokens in [1, vocab)."""
    rng = np.random.default_rng(seed)
    return [Request(uid=uid,
                    prompt=list(map(int, rng.integers(
                        1, cfg.vocab, int(rng.integers(2, 9))))),
                    max_new_tokens=new_tokens)
            for uid in range(n)]


def serve(model, requests: list[Request], cfg: ServeConfig) -> dict:
    """Answer ``requests`` with one ``Engine``; the clock covers the run and
    ends after the device is done."""
    eng = Engine(model, cfg)
    for req in requests:
        eng.submit(req)
    sync = (torch.cuda.synchronize if model.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    done = eng.run()
    sync()
    dt = time.perf_counter() - t0
    ntok = sum(len(r.output) for r in done)
    return {"done": done, "requests": len(done), "tokens": ntok,
            "rounds": eng.rounds, "seconds": dt,
            "tokens_per_s": ntok / max(dt, 1e-9)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: smoke, CPU-runnable)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--svd", action="store_true",
                    help="drive the async SVD serve tier instead of the "
                         "token engine")
    ap.add_argument("--svd-n", type=int, default=64, metavar="N",
                    help="[--svd] matrix size")
    ap.add_argument("--svd-bw", type=int, default=8, metavar="BW",
                    help="[--svd] stage-1 target bandwidth")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="[--svd] open-loop Poisson arrival rate, req/s")
    ap.add_argument("--timeout-ms", type=float, default=0.0,
                    help="[--svd] per-request deadline (0: none)")
    ap.add_argument("--autotune", action="store_true",
                    help="[--svd] per-bucket configs from the tuned-config "
                         "cache")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="[--svd] serve Prometheus-format engine metrics at "
                         "127.0.0.1:PORT/metrics for the run (0: an "
                         "ephemeral port)")
    ap.add_argument("--hosts", type=int, default=0, metavar="N",
                    help="[--svd] serve through a router over N worker "
                         "processes, each on --device")
    args = ap.parse_args(argv)
    if args.svd and args.hosts >= 1:
        return main_svd_multihost(args)
    if args.svd:
        return main_svd(args)

    cfg = get_config(args.arch) if args.full else smoke_of(args.arch)
    model = build(cfg, device=args.device)
    model.init_params(torch.Generator(device=model.device).manual_seed(
        args.seed))
    stats = serve(model, make_requests(cfg, args.requests, args.new_tokens,
                                       args.seed),
                  ServeConfig(max_batch=args.max_batch, max_seq=args.max_seq))
    for r in stats["done"][:4]:
        print(f"req {r.uid}: {r.output}")
    print(f"served {stats['requests']} requests / {stats['tokens']} tokens in "
          f"{stats['seconds']:.1f}s ({stats['tokens_per_s']:.1f} tok/s) on "
          f"{model.device}")
    return stats


def main_svd(args) -> dict:
    """Open-loop async SVD serving: a warm-up request (the kernels' builds)
    outside the clock, then ``--requests`` random fp64 matrices at Poisson
    arrivals of ``--rate`` per second; prints the served count, latency
    percentiles, the engine's metrics and its health."""
    from repro_torch.serve import AsyncSVDEngine, SVDRequest

    n, bw = args.svd_n, args.svd_bw
    rng = np.random.default_rng(args.seed)
    eng = AsyncSVDEngine(device=args.device, autotune=args.autotune,
                         default_timeout_s=(args.timeout_ms / 1e3 or None))
    mserver = None
    if args.metrics_port is not None:
        from repro_torch.obs import MetricsServer
        mserver = MetricsServer(port=args.metrics_port)
        mserver.register("svd", eng.metrics)
        print(f"metrics endpoint: {mserver.url}")
    try:
        # never under the engine's default deadline: a first dispatch on
        # the card builds its kernels
        eng.submit(SVDRequest(uid=-1, matrix=rng.standard_normal((n, n)),
                              bw=bw), timeout_s=float("inf")).result(
                                  timeout=1200)
        gaps = rng.exponential(1.0 / args.rate, args.requests)
        futs, lat = [], []

        def stamp(req):
            # latency is sampled when the future resolves
            def cb(fut):
                if fut.exception() is None:
                    lat.append(time.monotonic() - req.arrived)
            return cb

        t0 = time.perf_counter()
        for uid in range(args.requests):
            time.sleep(gaps[uid])
            r = SVDRequest(uid=uid, matrix=rng.standard_normal((n, n)),
                           bw=bw)
            f = eng.submit(r)
            f.add_done_callback(stamp(r))
            futs.append(f)
        for f in futs:
            try:
                f.result(timeout=1200)
            except Exception as exc:             # noqa: BLE001 — a report
                print(f"request failed: {exc!r}")
        dt = time.perf_counter() - t0
    finally:
        eng.stop()
        if mserver is not None:
            mserver.stop()
    snap = eng.metrics.snapshot()
    if lat:
        p50, p95, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 95, 99])
        print(f"served {len(lat)}/{args.requests} requests in {dt:.2f}s "
              f"({len(lat) / dt:.1f} req/s) on {eng.device}")
        print(f"latency p50/p95/p99 = {p50:.1f}/{p95:.1f}/{p99:.1f} ms")
    print("metrics:", {k: round(v, 3) if isinstance(v, float) else v
                       for k, v in sorted(snap.items())})
    health = eng.metrics.health()
    print("health:", {k: round(v, 4) if isinstance(v, float) else v
                      for k, v in health.items()})
    return {"served": len(lat), "requests": args.requests, "seconds": dt,
            "metrics": snap, "health": health}


def main_svd_multihost(args) -> dict:
    """The open loop of :func:`main_svd` through an ``SVDRouter`` in this
    process over ``--hosts`` worker processes, each serving on
    ``--device`` (``cuda``: worker i pinned to local card i mod the
    count, one process a card): every host warmed on the stream's bucket
    first, outside the clock; prints the served count, latency
    percentiles, each host's completions and the fleet's merged latency.
    The workers are reaped before it returns."""
    from repro_torch.kernels import ops
    from repro_torch.serve import SVDRequest, SVDRouter, spawn_worker_process

    ops.check_device(args.device)        # no card: raises, naming the CPU
    n, bw = args.svd_n, args.svd_bw
    rng = np.random.default_rng(args.seed)
    dev = torch.device(args.device)
    # one worker process a card: worker i on local card i mod the count
    cards = (torch.cuda.device_count()
             if dev.type == "cuda" and dev.index is None else 0)
    router = SVDRouter(default_timeout_s=(args.timeout_ms / 1e3 or None))
    procs = [spawn_worker_process(router.address, f"w{i}",
                                  device=args.device,
                                  card=i % cards if cards else None)
             for i in range(args.hosts)]
    mserver = None
    try:
        deadline = time.monotonic() + 300
        while not router.wait_for_hosts(args.hosts, timeout=1.0):
            dead = [p.returncode for p in procs if p.poll() is not None]
            if dead or time.monotonic() > deadline:
                raise RuntimeError(
                    f"only {len(router.alive_hosts())}/{args.hosts} worker "
                    f"hosts connected (exit codes of the dead: {dead})")
        if args.metrics_port is not None:
            from repro_torch.obs import MetricsServer, render_fleet_metrics
            mserver = MetricsServer(port=args.metrics_port)
            mserver.register("router", router.metrics)
            mserver.register_provider(
                "fleet", lambda: render_fleet_metrics(router.fleet()))
            print(f"metrics endpoint: {mserver.url}")
        # every host builds its kernels on the bucket outside the clock
        router.warm([SVDRequest(uid=-1, matrix=rng.standard_normal((n, n)),
                                bw=bw)], timeout=1200)
        router.reset_stats()
        gaps = rng.exponential(1.0 / args.rate, args.requests)
        futs, lat = [], []
        t0 = time.perf_counter()
        for uid in range(args.requests):
            time.sleep(gaps[uid])
            r = SVDRequest(uid=uid, matrix=rng.standard_normal((n, n)),
                           bw=bw)
            futs.append((r, router.submit(r)))
        for r, f in futs:
            try:
                f.result(timeout=1200)
                lat.append(time.monotonic() - r.arrived)
            except Exception as exc:             # noqa: BLE001 — a report
                print(f"request {r.uid} failed: {exc!r}")
        dt = time.perf_counter() - t0
        fleet = router.fleet()
    finally:
        router.stop()
        if mserver is not None:
            mserver.stop()
        for p in procs:
            try:
                p.wait(timeout=30)
            except Exception:                    # noqa: BLE001 — reaped
                p.kill()
                p.wait()
    hosts = {h: row.get("completed", 0)
             for h, row in fleet["router"].get("hosts", {}).items()}
    if lat:
        p50, p95, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 95, 99])
        print(f"served {len(lat)}/{args.requests} requests in {dt:.2f}s "
              f"({len(lat) / dt:.1f} req/s) across "
              f"{len(fleet['alive_hosts'])} hosts on {args.device}")
        print(f"latency p50/p95/p99 = {p50:.1f}/{p95:.1f}/{p99:.1f} ms")
    print("completed per host:", hosts)
    print("fleet hosts:", {h: {k: row[k] for k in (
        "alive", "devices", "process_index", "processes", "dispatched",
        "completed", "requeued") if k in row}
        for h, row in fleet["hosts"].items()})
    print("merged latency:", fleet["latency"]["merged_summary"])
    return {"served": len(lat), "requests": args.requests, "seconds": dt,
            "hosts": fleet["alive_hosts"], "completed_per_host": hosts,
            "fleet": fleet}


if __name__ == "__main__":
    main()
