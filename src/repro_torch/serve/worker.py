"""Worker host of the serving fabric across processes, after the reference's
``serve/worker.py``.

One :class:`ServeWorker` wraps one
:class:`~repro_torch.serve.AsyncSVDEngine` (micro-batching, the fault
ladder, quarantine, the degraded tier) behind a wire connection to the
front-end router (``serve/router.py``).  The worker serves compute but is
the client of the socket: it dials the router's listen address, sends one
``hello``, then answers ``req``/``ping``/``stats``/``stop`` frames until the
connection closes.  A closed connection means the router is gone: the
worker drains nothing (nobody is listening for results) and exits.

The fabric's processes talk over these sockets only, so killing one worker
never takes the others with it.  ``--coordinator`` opts a worker in to a
``torch.distributed`` process group on gloo (``launch.mesh.
init_distributed``); its hello then reports the group's rank and size and
the sum of the group's devices.

A worker runs on the card (``--device cuda``, the default) or, when asked,
on the CPU (``--device cpu``); a worker told to use a card that is not
there exits non-zero, naming ``--device cpu``, and never serves on the CPU
in its place.  A worker spawned with ``card=`` sees that one card; one
worker process a card is how the fabric serves on several.  An unpinned
worker's engine spans the local cards through ``launch.mesh.serve_mesh()``
where ``$REPRO_SERVE_MESH`` asks for it.

Three entry points:

* :class:`ServeWorker`: the protocol loop over an existing socket.
* :func:`start_inprocess_worker`: a worker on a daemon thread in THIS
  process (the full wire protocol, no subprocess).
* :func:`spawn_worker_process`: a real worker process running
  :func:`main`.
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import threading

from repro_torch.serve.wire import WireClosed, recv_msg, send_msg

__all__ = ["ServeWorker", "start_inprocess_worker", "spawn_worker_process",
           "main"]

# how long the hello's all-reduce of the group's devices may wait for the
# other processes
GROUP_WAIT_S = 30.0


def _group_devices(local: int) -> int:
    """The sum of ``local`` over the ``torch.distributed`` group, by one
    gloo all-reduce bounded by ``GROUP_WAIT_S``; ``local`` where no group
    is initialized."""
    import torch
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return local
    t = torch.tensor([local], dtype=torch.int64)
    work = dist.all_reduce(t, async_op=True)
    work.wait(timeout=datetime.timedelta(seconds=GROUP_WAIT_S))
    return int(t[0])


class ServeWorker:
    """Protocol loop: one engine, one router connection.

    ``engine`` defaults to a fresh ``AsyncSVDEngine(**engine_kwargs)``
    built in :meth:`serve_forever` (construction stays off the caller's
    thread for in-process workers)."""

    def __init__(self, sock: socket.socket, *, host_id: str,
                 engine=None, engine_kwargs: dict | None = None):
        self.sock = sock
        self.host_id = str(host_id)
        self.engine = engine
        self.engine_kwargs = dict(engine_kwargs or {})
        self._send_lock = threading.Lock()
        self._pings = 0

    # ------------------------------------------------------------------

    def _send(self, header: dict, arrays=None) -> bool:
        """Send one frame; False (never raises) once the router is gone —
        a result with nobody to deliver it to is not a worker failure."""
        try:
            with self._send_lock:
                send_msg(self.sock, header, arrays)
            return True
        except (OSError, WireClosed):
            return False

    def _hello(self) -> None:
        import torch

        from repro_torch.core.distributed import process_info
        pid_idx, nproc = process_info()
        dev = self.engine.device
        local = torch.cuda.device_count() if dev.type == "cuda" else 1
        self._send({"type": "hello", "host_id": self.host_id,
                    "pid": os.getpid(), "device": str(dev),
                    "devices": local,
                    "global_devices": _group_devices(local),
                    "process_index": pid_idx, "processes": nproc})

    def _on_request(self, header: dict, arrays: dict) -> None:
        from repro_torch.serve.engine import SVDRequest
        rid = int(header["rid"])
        req = SVDRequest(uid=int(header.get("uid", rid)),
                         matrix=arrays["matrix"],
                         bw=int(header.get("bw", 32)),
                         banded=bool(header.get("banded", False)),
                         compute_uv=bool(header.get("compute_uv", False)))
        fut = self.engine.submit(req, timeout_s=header.get("timeout_s"))
        fut.add_done_callback(lambda f, rid=rid, req=req:
                              self._send_result(rid, req, f))

    def _send_result(self, rid: int, req, fut) -> None:
        exc = fut.exception()
        if exc is not None:
            self._send({"type": "res", "rid": rid, "ok": False,
                        "error": str(exc),
                        "error_type": type(exc).__name__})
            return
        arrays = {"sigma": req.sigma}
        if req.compute_uv:
            arrays["u"] = req.u
            arrays["vt"] = req.vt
        self._send({"type": "res", "rid": rid, "ok": True,
                    "tier": self.engine.metrics.tier_of_bucket(req.key())},
                   arrays)

    def _on_stats(self, header: dict) -> None:
        """Per-host observability payload: the engine's metrics snapshot
        plus the latency histograms as mergeable dicts, which the router
        folds into the fleet view."""
        hists = self.engine.metrics.histograms()
        self._send({"type": "stats_res", "host_id": self.host_id,
                    "token": header.get("token"),
                    "snapshot": self.engine.metrics.snapshot(),
                    "histograms": {
                        "tiers": {t: h.to_dict()
                                  for t, h in hists["tiers"].items()},
                        "queue_age": hists["queue_age"].to_dict()},
                    "faults": (self.engine.faults.snapshot()
                               if self.engine.faults is not None else None)})

    # ------------------------------------------------------------------

    def serve_forever(self) -> None:
        """Run the protocol until ``stop`` or the router disconnects."""
        if self.engine is None:
            from repro_torch.serve.async_engine import AsyncSVDEngine
            self.engine = AsyncSVDEngine(**self.engine_kwargs)
        self.engine.start()
        self._hello()
        drain = False
        try:
            while True:
                try:
                    header, arrays = recv_msg(self.sock)
                except WireClosed:
                    break                    # router gone: no drain target
                t = header.get("type")
                if t == "req":
                    self._on_request(header, arrays)
                elif t == "ping":
                    self._pings += 1
                    self._send({"type": "pong", "host_id": self.host_id,
                                "seq": header.get("seq"),
                                "pending": self.engine.pending(),
                                "health": self.engine.metrics.health()[
                                    "status"]})
                elif t == "stats":
                    self._on_stats(header)
                elif t == "stop":
                    drain = True
                    break
        finally:
            try:
                self.engine.stop(drain=drain)
            finally:
                try:
                    self.sock.close()
                except OSError:
                    pass


def start_inprocess_worker(address, host_id: str, *,
                           engine_kwargs: dict | None = None):
    """Run a worker on a daemon thread in this process, dialed into the
    router at ``address``: the full wire protocol with no subprocess.
    ``engine_kwargs`` go to ``AsyncSVDEngine`` (``device="cpu"`` to serve
    on the CPU)."""
    sock = socket.create_connection(address, timeout=30)
    sock.settimeout(None)
    worker = ServeWorker(sock, host_id=host_id, engine_kwargs=engine_kwargs)
    thread = threading.Thread(target=worker.serve_forever,
                              name=f"ServeWorker-{host_id}", daemon=True)
    thread.start()
    return worker, thread


def _child_env(env: dict | None, card: int | None) -> dict:
    """A worker's environment: ``env`` (else this process's), with this
    package's ``src`` first on ``PYTHONPATH``; pinned to local card
    ``card`` (an index into this process's visible cards) through
    ``CUDA_VISIBLE_DEVICES``, and then without ``$REPRO_SERVE_MESH``, since
    a pinned worker sees one card."""
    child_env = dict(os.environ if env is None else env)
    src = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    child_env["PYTHONPATH"] = (src + os.pathsep
                               + child_env.get("PYTHONPATH", "")).rstrip(
                                   os.pathsep)
    if card is not None:
        visible = [v for v in child_env.get("CUDA_VISIBLE_DEVICES",
                                            "").split(",") if v.strip()]
        child_env["CUDA_VISIBLE_DEVICES"] = (
            visible[card % len(visible)].strip() if visible else str(card))
        child_env.pop("REPRO_SERVE_MESH", None)
    return child_env


def spawn_worker_process(address, host_id: str, *, backend: str = "auto",
                         window_ms: float = 5.0, device: str = "cuda",
                         card: int | None = None, coordinator: str = "",
                         num_processes: int = 0, process_id: int = -1,
                         env: dict | None = None) -> subprocess.Popen:
    """Launch :func:`main` in a new process of this interpreter, with this
    package's ``src`` first on its ``PYTHONPATH``.

    ``device`` is the worker's ``--device``; ``card`` pins it to that local
    card (``CUDA_VISIBLE_DEVICES``: the worker's ``cuda`` is that card, and
    its engine takes no mesh), one worker process a card being the way to
    serve on several; ``coordinator`` opts it in to a gloo process group
    (``num_processes``, ``process_id``).  The caller reaps the process
    (``wait``, else ``kill``)."""
    host, port = address
    # a `-c` entry rather than `-m repro_torch.serve.worker`: the package
    # __init__ already imports this module, so runpy would warn about (and
    # shadow) the copy in sys.modules
    cmd = [sys.executable, "-c",
           "from repro_torch.serve.worker import main; main()",
           "--connect", f"{host}:{port}", "--host-id", str(host_id),
           "--backend", backend, "--window-ms", str(window_ms),
           "--device", device]
    if coordinator:
        cmd += ["--coordinator", coordinator,
                "--num-processes", str(num_processes),
                "--process-id", str(process_id)]
    return subprocess.Popen(cmd, env=_child_env(env, card))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Worker host of the SVD serving fabric")
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="router listen address to dial")
    ap.add_argument("--host-id", required=True)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default: the card)")
    ap.add_argument("--window-ms", type=float, default=5.0,
                    help="engine micro-batch window")
    ap.add_argument("--max-pending", type=int, default=4096)
    ap.add_argument("--coordinator", default="", metavar="HOST:PORT",
                    help="opt-in torch.distributed rendezvous address (a "
                         "gloo process group across the workers)")
    ap.add_argument("--num-processes", type=int, default=0)
    ap.add_argument("--process-id", type=int, default=-1)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_distributed, serve_mesh
    try:
        ops.check_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"repro_torch.serve.worker {args.host_id}: {exc}; "
                         f"pass --device cpu to serve on the CPU") from None
    if args.coordinator:
        init_distributed(coordinator=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id)
    mesh = None
    if torch.device(args.device).type == "cuda":
        # the card's context is made before the hello: from then on the
        # router expects a pong every heartbeat
        torch.empty(1, device=args.device)
        mesh = serve_mesh()
    host, _, port = args.connect.rpartition(":")
    sock = socket.create_connection((host, int(port)), timeout=60)
    sock.settimeout(None)
    worker = ServeWorker(sock, host_id=args.host_id, engine_kwargs=dict(
        backend=args.backend, device=args.device,
        batch_window_s=args.window_ms / 1e3, max_pending=args.max_pending,
        mesh=mesh))
    worker.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
