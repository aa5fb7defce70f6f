"""Serving of the port, after the reference's ``serve/`` package.

Sync tier: ``Engine`` (tokens) and ``SVDEngine`` (spectral,
shape-bucketed).  Async tier: ``AsyncSVDEngine`` — thread-safe
micro-batching queue, deadline-aware admission, futures; ``ServeMetrics``
counters live on every SVD engine as ``.metrics``.  Fault tolerance:
``FaultPlan`` (deterministic injection), ``RetryPolicy`` (backoff ladder)
and ``BucketQuarantine`` (per-bucket circuit breaker) in
``serve/faults.py``; ``NumericalFault`` lives in ``core/svd.py`` and is
re-exported here.  Across devices: an engine's ``mesh=`` splits each
bucket over a ``launch.mesh.DeviceMesh`` (``core/distributed.py``).  Across
processes: ``SVDRouter`` (the admission front end, ``serve/router.py``)
over ``ServeWorker`` hosts (``serve/worker.py``) speaking the
``serve/wire.py`` frame protocol, wire-compatible with the reference's.
"""
from repro_torch.core.svd import NumericalFault
from repro_torch.serve.async_engine import AsyncSVDEngine, QueueFullError
from repro_torch.serve.engine import (Engine, Request, ServeConfig, SVDEngine,
                                      SVDRequest)
from repro_torch.serve.faults import (BucketQuarantine, FaultPlan,
                                      InjectedDeviceLoss,
                                      InjectedDispatchError, InjectedFault,
                                      RetryPolicy)
from repro_torch.serve.metrics import ServeMetrics, bucket_key_str
from repro_torch.serve.router import HostDownError, SVDRouter
from repro_torch.serve.worker import (ServeWorker, spawn_worker_process,
                                      start_inprocess_worker)

__all__ = ["Engine", "Request", "ServeConfig", "SVDEngine", "SVDRequest",
           "AsyncSVDEngine", "QueueFullError", "ServeMetrics",
           "bucket_key_str",
           "SVDRouter", "HostDownError", "ServeWorker",
           "start_inprocess_worker", "spawn_worker_process",
           "FaultPlan", "RetryPolicy", "BucketQuarantine", "NumericalFault",
           "InjectedFault", "InjectedDispatchError", "InjectedDeviceLoss"]
