"""Batched serving engines with static shapes, after the reference's
``serve/engine.py``: ``Engine`` (tokens) and ``SVDEngine`` (spectral,
shape-bucketed).

``Engine``: requests queue up; up to ``max_batch`` live in fixed KV-cache slots with
*per-slot positions* (``decode_step`` takes a (b,) position vector).  Every
round issues ONE batched decode step: prefilling slots feed their next
prompt token, generating slots feed their last sampled token, finished
slots are refilled from the queue.  Greedy sampling; the padded-vocab tail
is masked at sample time.  Idle slots sit at position 0 and write their row
0 every round, as in the reference.

The model carries its weights and its device (``models.zoo.Model``); the
caches live on the same device.

``SVDEngine``: requests are bucketed by ``SVDRequest.key()`` ``(n, bw,
dtype, banded, compute_uv)``; each flush pads one bucket to its config's
``max_batch`` with zero matrices, on the engine's device, and issues ONE
batched pipeline call (``core.svd``), so heavy small-matrix traffic fills
the chase wavefront that a single matrix cannot (paper Eq. 1).  Results
come back to the host (numpy) before a request completes.  The
asynchronous tier (queue, micro-batch window, futures, deadlines) lives in
``serve/async_engine.py`` and extends ``SVDEngine``; the counters of both
live in ``serve/metrics.py``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import svd as svdmod
from repro_torch.core import tuning
from repro_torch.kernels import ops
from repro_torch.serve.faults import (BucketQuarantine, InjectedFault,
                                      RetryPolicy)
from repro_torch.serve.metrics import ServeMetrics, bucket_key_str

__all__ = ["Request", "ServeConfig", "Engine", "SVDRequest", "SVDEngine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 4
    max_seq: int = 128
    eos_id: int = -1                          # -1: never stop early


class _Slot:
    __slots__ = ("req", "pos", "k", "next_tok")

    def __init__(self, req):
        self.req = req
        self.pos = 0                          # next cache position to write
        self.k = 0                            # prompt cursor
        self.next_tok = req.prompt[0]


class Engine:
    def __init__(self, model, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.slots: list[_Slot | None] = [None] * cfg.max_batch
        self.rounds = 0                       # decode steps issued
        self.caches = model.init_caches(cfg.max_batch, cfg.max_seq)

    def submit(self, req: Request):
        assert len(req.prompt) >= 1
        self.queue.append(req)

    def _admit(self):
        for i in range(self.cfg.max_batch):
            if self.slots[i] is None and self.queue:
                self.slots[i] = _Slot(self.queue.pop(0))

    def step(self) -> int:
        """One batched decode round.  Returns number of active slots."""
        self._admit()
        act = [i for i, s in enumerate(self.slots) if s is not None]
        if not act:
            return 0
        b = self.cfg.max_batch
        toks = np.zeros((b, 1), np.int64)
        pos = np.zeros((b,), np.int64)
        for i in act:
            s = self.slots[i]
            toks[i, 0] = s.next_tok
            pos[i] = s.pos
        dev = self.model.device
        self.rounds += 1
        logits, self.caches = self.model.decode_step(
            torch.from_numpy(toks).to(dev), self.caches,
            torch.from_numpy(pos).to(dev))
        v = self.model.cfg.vocab
        nxt = torch.argmax(logits[:, 0, :v], dim=-1).cpu().numpy()
        for i in act:
            s = self.slots[i]
            s.pos += 1
            s.k += 1
            if s.k < len(s.req.prompt):           # still prefilling
                s.next_tok = int(s.req.prompt[s.k])
                continue
            tok = int(nxt[i])
            s.req.output.append(tok)
            s.next_tok = tok
            if (tok == self.cfg.eos_id
                    or len(s.req.output) >= s.req.max_new_tokens
                    or s.pos >= self.cfg.max_seq - 1):
                s.req.done = True
                self.finished.append(s.req)
                self.slots[i] = None
        return len(act)

    def run(self, max_rounds: int = 10_000) -> list[Request]:
        end = self.rounds + max_rounds
        while (self.queue or any(self.slots)) and self.rounds < end:
            self.step()
        return self.finished


# ---------------------------------------------------------------------------
# Batched SVD serving (shape-bucketed, batch-native pipeline)
# ---------------------------------------------------------------------------

def _dtype_name(m) -> str:
    if isinstance(m, torch.Tensor):
        return str(m.dtype).removeprefix("torch.")
    return np.dtype(m.dtype).name


@dataclasses.dataclass
class SVDRequest:
    """One spectral query: singular values (and optionally vectors) of a
    square (or banded) matrix, a numpy array or a tensor on any device.

    A request always COMPLETES (``done=True``) exactly once: either with
    results (``sigma`` and, for ``compute_uv``, ``u``/``vt``, numpy arrays
    of the matrix's dtype) or with ``error`` set to the exception that
    failed it — engines never raise a per-request problem out of a whole
    batched step.  ``deadline`` (an absolute ``time.monotonic()`` instant)
    is honored by the async engine: a request still queued past its
    deadline is failed with :class:`TimeoutError` instead of being
    dispatched.
    """
    uid: int
    matrix: object                             # (n, n); upper-banded if banded
    bw: int = 32                               # stage-1 target / band bandwidth
    banded: bool = False                       # True: skip stage 1
    compute_uv: bool = False                   # True: full SVD (U, sigma, Vt)
    sigma: np.ndarray | None = None            # (n,) result, descending
    u: np.ndarray | None = None                # (n, n) left vectors (compute_uv)
    vt: np.ndarray | None = None               # (n, n) right vectors^T
    done: bool = False
    error: Exception | None = None             # set instead of raising
    deadline: float | None = None              # absolute monotonic() instant
    arrived: float | None = None               # set at submit (monotonic())
    future: object | None = dataclasses.field(default=None, repr=False)

    def key(self) -> tuple:
        """Bucket key: everything that shapes the pipeline.  ``compute_uv``
        is part of it: a values-only request must not pay for a
        co-bucketed full-SVD one."""
        return (self.matrix.shape[-1], self.bw, _dtype_name(self.matrix),
                self.banded, self.compute_uv)


# The faults the retry ladder and the degraded tier absorb: a result the
# numerical guard refused, and the errors a FaultPlan injects.
_ABSORBED = (svdmod.NumericalFault, InjectedFault)


def _padded_stack(mats: list, cap: int, n: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """``mats`` stacked on ``device`` and padded with zero matrices to
    ``cap``: one host-to-device copy where every matrix is on the host."""
    batch = torch.zeros((cap, n, n), dtype=dtype, device=device)
    ts = [torch.as_tensor(m) for m in mats]
    if all(t.device.type == "cpu" for t in ts):
        batch[:len(ts)].copy_(torch.stack(ts).to(dtype))
    else:
        for i, t in enumerate(ts):
            batch[i].copy_(t)
    return batch


class SVDEngine:
    """Shape-bucketing batched SVD server.

    Queued requests are grouped by ``SVDRequest.key()``; ``step`` flushes the
    fullest bucket as ONE batched pipeline call, padded to the bucket capacity
    (``PipelineConfig.max_batch``).  Results are bit for bit a direct
    ``svd_batched`` call on the same padded stack: padding rows are
    independent problems and are sliced off.

    >>> eng = SVDEngine(PipelineConfig.resolve(bw=8, dtype=torch.float64,
    ...                                        device="cpu"))
    >>> eng.submit(SVDRequest(uid=0, matrix=a, bw=8))
    >>> done = eng.run()

    The engine runs where its config says: ``device`` (default: the config's,
    else the card) resolves the config when none is given.  A bucket holds
    ``tuning.default_bucket_batch(n, bw)`` matrices (or the tuned
    ``max_batch`` of a cache hit), capped by the engine's ``max_batch``, or
    where none is given by the given config's; an engine built with
    neither has no cap.

    ``autotune=True`` resolves each bucket against the tuned-config cache
    (``repro_torch.autotune.cache``): a HIT gives the bucket's ``tw``,
    ``fuse`` and ``max_batch``; on a MISS the engine's own config stays in
    charge.  The resolved config is memoized per key.  One departure from
    the reference: the config's ``tw`` was resolved for its (bw, dtype),
    so it holds for buckets of that (bw, dtype) only; any other bucket
    takes the cache-line tilewidth of its own, where the reference gives
    every bucket the config's (a bw-64 bucket under a bw-32 fp32 config
    gets tw 31, which splits its stage 2 into three stages, the last of
    them, b_in 2 tw 1, the slowest on the card).

    ``fused_n_max`` governs the fused small-n tier: buckets with ``n <=
    fused_n_max`` resolve with ``backend="fused_small"`` (one launch per
    batch on the card), the rest stay on the staged pipeline.  ``None`` uses
    the measured crossover from the cache when ``autotune=True``, else
    ``tuning.DEFAULT_FUSED_CROSSOVER``; ``0`` disables the tier; an int pins
    it.  ``dc_n_min`` is the same at the other end: staged buckets with ``n
    >= dc_n_min`` take the divide-and-conquer stage 3 ("staged-dc");
    ``None`` uses the cache's crossover when ``autotune=True``, else
    ``tuning.DEFAULT_DC_N_MIN``; ``0`` pins bisection.  Per-bucket routing
    shows in ``metrics.snapshot()["bucket_tiers"]``.

    **Fault tolerance.**  Every result passes the numerical guard
    (``core.svd.validate_sigma``, ``validate_uv``; ``residual_check=True``
    adds ``spot_check_svd`` for ``compute_uv`` buckets).  A dispatch whose
    result the guard refuses (``NumericalFault``), or that a ``FaultPlan``
    failed (``InjectedFault``), enters the ``retry`` ladder
    (:class:`~repro_torch.serve.faults.RetryPolicy`: bounded attempts,
    capped backoff that never sleeps past a deadline); exhausted requests
    are served on the DEGRADED tier — the bucket's shape on the plain
    ``ref`` backend, on the engine's device, with bisection — counted as
    ``"degraded-ref"``.  Repeated such failures trip the bucket's circuit
    breaker (:class:`~repro_torch.serve.faults.BucketQuarantine`).  Any
    other error, such as a kernel that does not build or launch, fails the
    dispatch's requests with that error and counts in ``failed``: it is
    neither retried nor served on the plain tier, where it would only show
    as a slower service.  (The reference retries and degrades on every
    error.)
    ``faults`` (a :class:`~repro_torch.serve.faults.FaultPlan`) injects
    failures into the primary path only.

    ``mesh`` (a ``launch.mesh.DeviceMesh``, e.g. from
    ``launch.mesh.serve_mesh()``, of devices of the engine's device type)
    sends every batched dispatch through
    ``core.distributed.sharded_pipeline_dispatch``: the padded bucket is
    split over the mesh's devices, one slice each, and gathered back;
    ``sharded_batches`` counts such dispatches and ``sharded_retries`` the
    shards run again after a loss.  ``tracer`` (or an ambient one)
    gets ``serve/dispatch``, ``serve/retry`` and ``serve/degraded`` spans,
    with the pipeline's own spans nested under each dispatch.
    """

    def __init__(self, config=None, *, backend: str = "auto",
                 device: str | None = None, max_batch: int | None = None,
                 autotune: bool = False, autotune_cache: str | None = None,
                 fused_n_max: int | None = None,
                 dc_n_min: int | None = None,
                 faults=None, retry: RetryPolicy | None = None,
                 residual_check: bool = False, tracer=None, mesh=None):
        given = config is not None
        if config is None:
            config = tuning.PipelineConfig.resolve(
                backend=backend, device=device or "cuda")
        elif device is not None and torch.device(device) != torch.device(
                config.device):
            raise ValueError(f"device={device!r} conflicts with "
                             f"config.device={config.device!r}")
        if max_batch is not None:
            config = dataclasses.replace(config, max_batch=max_batch)
        self.config = config
        # the cap on every bucket's batch; None lets default_bucket_batch
        # (or a cache hit) decide alone
        self.max_batch = (config.max_batch
                          if given or max_batch is not None else None)
        self.device = ops.check_device(config.device)   # no card: raises
        self.autotune = autotune
        self.autotune_cache = autotune_cache
        self.fused_n_max = fused_n_max           # fused-tier crossover
        self.dc_n_min = dc_n_min                 # stage-3 dc crossover
        self.faults = faults                     # fault injection hook
        if mesh is not None and any(torch.device(d).type != self.device.type
                                    for d in mesh):
            raise ValueError(f"mesh {mesh!r} is not on the engine's device "
                             f"type ({self.device.type})")
        self.mesh = mesh                         # batch dispatch over devices
        self.retry = retry if retry is not None else RetryPolicy()
        self.residual_check = bool(residual_check)
        self.quarantine = BucketQuarantine(
            threshold=self.retry.quarantine_threshold,
            cooldown_s=self.retry.quarantine_cooldown_s)
        self.buckets: dict[tuple, list[SVDRequest]] = {}
        self.finished: list[SVDRequest] = []
        self.calls = 0                           # batched pipeline invocations
        self.metrics = ServeMetrics()
        self.tracer = tracer                     # obs.Tracer or None
        self._cfg_memo: dict[tuple, object] = {}  # bucket key -> resolved cfg
        self._degraded_memo: dict[tuple, object] = {}  # key -> ref-tier cfg

    def _resolve_tracer(self):
        return self.tracer if self.tracer is not None else obs.current()

    def _span(self, name: str, **attrs):
        """A span on the engine's tracer (explicit or ambient), the shared
        null span when neither exists."""
        tr = self._resolve_tracer()
        if tr is None:
            return obs.span(name, **attrs)       # -> null span
        return tr.span(name, **attrs)

    def submit(self, req: SVDRequest) -> None:
        m = req.matrix
        if not (m.ndim == 2 and m.shape[0] == m.shape[1]):
            raise ValueError(f"SVDRequest.matrix must be square 2-D, got "
                             f"shape {tuple(m.shape)}")
        if req.arrived is None:
            req.arrived = time.monotonic()       # queue-age/latency clock
        key = req.key()
        self.metrics.add(submitted=1,
                         bucket_hits=int(key in self._cfg_memo
                                         or key in self.buckets))
        self.buckets.setdefault(key, []).append(req)
        self.metrics.set_queue_depth(self.pending())

    def pending(self) -> int:
        return sum(len(v) for v in self.buckets.values())

    def _fused_n_max_for(self, key: tuple) -> int:
        """The fused-tier crossover governing this bucket: an explicit
        engine ``fused_n_max`` pins it (0 disables the tier); otherwise
        ``autotune=True`` consults the MEASURED crossover persisted by
        ``python -m repro_torch.autotune --fused-crossover`` (bw-specific
        entry first, then the device-wide one); otherwise
        ``tuning.DEFAULT_FUSED_CROSSOVER``."""
        if self.fused_n_max is not None:
            return int(self.fused_n_max)
        _n, bw, dtype, _banded, compute_uv = key
        if self.autotune:
            from repro_torch.autotune import cache as at_cache
            from repro_torch.autotune import model as at_model
            tuned = at_cache.lookup_crossover(
                device_kind=at_model.device_kind(self.device), dtype=dtype,
                compute_uv=compute_uv, bw=bw, path=self.autotune_cache)
            if tuned is not None:
                return tuned
        return tuning.DEFAULT_FUSED_CROSSOVER

    def _dc_n_min_for(self, key: tuple) -> int:
        """The stage-3 dc crossover governing this bucket, with the same
        precedence as ``_fused_n_max_for``: an explicit engine
        ``dc_n_min`` (0 disables dc), else the cache's measured crossover
        when ``autotune=True``, else ``tuning.DEFAULT_DC_N_MIN``."""
        if self.dc_n_min is not None:
            return int(self.dc_n_min)
        _n, _bw, dtype, _banded, compute_uv = key
        if self.autotune:
            from repro_torch.autotune import cache as at_cache
            from repro_torch.autotune import model as at_model
            tuned = at_cache.lookup_stage3(
                device_kind=at_model.device_kind(self.device), dtype=dtype,
                compute_uv=compute_uv, path=self.autotune_cache)
            if tuned is not None:
                return tuned
        return tuning.DEFAULT_DC_N_MIN

    def _cfg_for(self, key: tuple):
        if key in self._cfg_memo:
            return self._cfg_memo[key]
        n, bw, dtype, _banded, compute_uv = key
        entry = None
        if self.autotune:
            from repro_torch.autotune import cache as at_cache
            from repro_torch.autotune import model as at_model
            entry = at_cache.lookup(
                device_kind=at_model.device_kind(self.device), n=n, bw=bw,
                dtype=dtype, compute_uv=compute_uv,
                backend=self.config.backend, path=self.autotune_cache)
        if entry is not None:
            # Tuned bucket: the measured optimum decides tw/fuse (and
            # max_batch where the search explored the batch axis).
            eff = (entry.get("max_batch")
                   or tuning.default_bucket_batch(n, bw, dtype))
            tw, fuse = entry["tw"], entry["fuse"]
        else:
            # Miss (or autotune off): the occupancy default sizes the
            # bucket, so that large matrices, whose own wavefront fills
            # the card, are not padded for nothing; the config's fuse
            # holds, and its tw where the bucket is of the (bw, dtype) it
            # was resolved for, else the bucket's own cache-line tw.
            eff = tuning.default_bucket_batch(n, bw, dtype)
            same = (bw, dtype) == (self.config.bw, self.config.dtype)
            tw = self.config.tw if same else None
            fuse = self.config.fuse
        if self.max_batch is not None:
            eff = min(eff, self.max_batch)

        # "auto" plus the bucket's crossover collapses to one solver inside
        # resolve (n is known); dc_n_min < 1 pins bisection.
        dmin = self._dc_n_min_for(key)
        stage3 = "bisect" if dmin < 1 else "auto"

        def resolve(backend: str):
            return tuning.PipelineConfig.resolve(
                bw=bw, tw=tw, backend=backend, dtype=dtype, n=n,
                device=self.config.device, max_batch=max(1, eff),
                compute_uv=compute_uv, fuse=fuse, stage3=stage3,
                dc_leaf_n=self.config.dc_leaf_n, dc_n_min=max(dmin, 1))

        cfg = None
        if n <= self._fused_n_max_for(key):
            # Fused small-n tier: an n whose fused block does not fit
            # shared memory stays on the staged pipeline.
            try:
                cfg = resolve("fused_small")
            except ValueError:
                cfg = None
        if cfg is None:
            cfg = resolve(self.config.backend)
        self.metrics.set_bucket_tier(key, self._tier_of(cfg, n), n=n,
                                     backend=cfg.backend)
        self._cfg_memo[key] = cfg
        return cfg

    @staticmethod
    def _tier_of(cfg, n: int) -> str:
        """Metrics label of a resolved bucket config: "fused", "staged-dc"
        (the staged pipeline with dc stage 3) or "staged" (bisection)."""
        if cfg.backend == "fused_small":
            return "fused"
        return "staged-dc" if cfg.stage3_for(n) == "dc" else "staged"

    def _pop(self, key: tuple, cap: int) -> list[SVDRequest]:
        """Dequeue up to ``cap`` requests of one bucket, submission order."""
        reqs = self.buckets[key][:cap]
        self.buckets[key] = self.buckets[key][cap:]
        if not self.buckets[key]:
            del self.buckets[key]
        self.metrics.set_queue_depth(self.pending())
        return reqs

    def _finish(self, req: SVDRequest, error: Exception | None = None, *,
                tier: str | None = None) -> None:
        """Complete one request exactly once: results already on it, or
        ``error``; resolve its future (async callers) either way.

        A request admitted in time but completed after its deadline is a
        timeout to the caller and counts in ``timed_out``; its late results
        stay on the request.  Successful completions feed the per-tier and
        per-bucket latency histograms with the client-view latency (submit
        to completion)."""
        if (error is None and req.deadline is not None
                and time.monotonic() > req.deadline):
            error = TimeoutError(
                f"request {req.uid} completed after its deadline "
                f"({time.monotonic() - req.deadline:.3f}s late); late "
                f"results remain on the request")
        req.error = error
        req.done = True
        self.finished.append(req)
        if error is None:
            self.metrics.add(completed=1)
            if req.arrived is not None:
                key = req.key()
                self.metrics.observe_latency(
                    tier or self.metrics.tier_of_bucket(key), key,
                    time.monotonic() - req.arrived)
        elif isinstance(error, TimeoutError):
            self.metrics.add(timed_out=1)        # serving failure, not pipeline
        else:
            self.metrics.add(failed=1)
        if req.future is not None:
            try:
                if error is not None:
                    req.future.set_exception(error)
                else:
                    req.future.set_result(req)
            except Exception:                    # noqa: BLE001 — caller
                pass                             # cancelled; result stays on req

    def _pipeline_call(self, key: tuple, cfg, mats: list, *,
                       tier: str | None = None, inject: bool = True):
        """ONE batched pipeline dispatch for ``mats`` (padded to the bucket
        capacity): returns numpy ``(sigma, u, vt)`` sliced to ``len(mats)``
        (``u``/``vt`` None for values-only buckets), under a
        ``serve/dispatch`` span where a tracer is active.

        With a :class:`~repro_torch.serve.faults.FaultPlan` and ``inject``
        True (primary path only), the plan may delay or raise before the
        dispatch and corrupt the sigma block after it.  Every result then
        passes the numerical guard, raising ``NumericalFault`` on
        garbage."""
        tr = self._resolve_tracer()
        if tr is None:
            return self._pipeline_call_inner(key, cfg, mats, tier=tier,
                                             inject=inject)
        # activating the tracer nests the pipeline's own spans under this
        with obs.activated(tr), tr.span(
                "serve/dispatch", bucket=bucket_key_str(key),
                tier=tier or self._tier_of(cfg, key[0]), n=key[0],
                batch=len(mats), backend=cfg.backend, inject=inject):
            return self._pipeline_call_inner(key, cfg, mats, tier=tier,
                                             inject=inject)

    def _pipeline_call_inner(self, key: tuple, cfg, mats: list, *,
                             tier: str | None = None, inject: bool = True):
        n, _bw, dtype, banded, compute_uv = key
        faults = self.faults if inject else None
        if faults is not None:
            faults.before_dispatch(key)          # may sleep and/or raise
        batch = _padded_stack(mats, cfg.max_batch, n, tuning.dtype_of(dtype),
                              torch.device(cfg.device))
        u = vt = None
        if self.mesh is not None:
            from repro_torch.core import distributed
            out = distributed.sharded_pipeline_dispatch(
                batch, self.mesh, config=cfg, banded=banded,
                compute_uv=compute_uv, faults=faults,
                on_shard_retry=lambda k_: self.metrics.add(sharded_retries=k_))
            if compute_uv:
                u, sig, vt = out
            else:
                sig = out
            self.metrics.add(sharded_batches=1)
        elif compute_uv:
            fn = svdmod.banded_svd if banded else svdmod.svd
            u, sig, vt = fn(batch, config=cfg, compute_uv=True)
        elif banded:
            sig = svdmod.banded_singular_values(batch, config=cfg)
        else:
            sig = svdmod.svd_batched(batch, config=cfg)
        self.calls += 1
        self.metrics.add(batches=1, served_slots=len(mats),
                         padded_slots=cfg.max_batch - len(mats))
        self.metrics.add_tier(
            tier or self._tier_of(cfg, n), batches=1, served_slots=len(mats),
            padded_slots=cfg.max_batch - len(mats))
        k = len(mats)
        # read back to the host (the copy waits for the device) before any
        # request completes
        sig = sig[:k].cpu().numpy()
        if compute_uv:
            u, vt = u[:k].cpu().numpy(), vt[:k].cpu().numpy()
        if faults is not None:
            sig = faults.corrupt_sigma(sig)
        # the numerical guard: a NaN/Inf/garbage sigma raises NumericalFault
        # here and never reaches a caller as an answer
        svdmod.validate_sigma(sig)
        if compute_uv:
            svdmod.validate_uv(u, vt)
            if self.residual_check:
                svdmod.spot_check_svd(batch[:k], u, sig, vt)
        return sig, u, vt

    # ------------------------------------------------------------------
    # fault-tolerant dispatch
    # ------------------------------------------------------------------

    def _degraded_cfg(self, key: tuple, cap: int):
        """The degraded-tier config of a bucket: same shapes, the plain
        ``ref`` backend on the engine's device, bisection stage 3, the
        bucket's capacity ``cap``.  Memoized per key."""
        if key not in self._degraded_memo:
            n, bw, dtype, _banded, compute_uv = key
            self._degraded_memo[key] = tuning.PipelineConfig.resolve(
                bw=bw, backend="ref", dtype=dtype, n=n,
                device=self.config.device, max_batch=cap,
                compute_uv=compute_uv, stage3="bisect")
        return self._degraded_memo[key]

    def _note_failure(self, key: tuple, exc: Exception) -> None:
        """Record one primary-path failure: last-error attribution plus
        the circuit breaker's consecutive-failure count."""
        self.metrics.set_bucket_error(key, exc)
        if self.quarantine.record_failure(key):
            self.metrics.add(quarantined=1)
            self.metrics.set_bucket_quarantined(key, True)

    def _note_success(self, key: tuple) -> None:
        if self.quarantine.record_success(key):
            self.metrics.set_bucket_quarantined(key, False)

    def _deliver(self, key: tuple, reqs: list[SVDRequest], sig, u, vt,
                 tier: str | None = None) -> None:
        """Copy one dispatch's results onto its requests and complete them
        in submission (FIFO) order."""
        compute_uv = key[4]
        for i, r in enumerate(reqs):
            r.sigma = sig[i]
            if compute_uv:
                r.u, r.vt = u[i], vt[i]
            self._finish(r, tier=tier)

    def _fail(self, key: tuple, reqs: list[SVDRequest],
              exc: Exception) -> int:
        """Complete ``reqs`` with ``exc``, an error the ladder does not
        absorb (a kernel that does not build or launch): no retry, no
        degraded tier, no count towards the bucket's breaker."""
        self.metrics.set_bucket_error(key, exc)
        for r in reqs:
            self._finish(r, error=exc)
        return len(reqs)

    def _serve_degraded(self, key: tuple, cfg, reqs: list[SVDRequest],
                        cause: Exception | None) -> int:
        """Serve ``reqs`` on the degraded ref tier (a quarantined bucket, or
        a request whose retries are exhausted).  The degraded dispatch is
        never fault-injected and still passes the numerical guard; if even
        it fails, the request surfaces ``cause`` (the primary-path error)."""
        with self._span("serve/degraded", bucket=bucket_key_str(key),
                        batch=len(reqs),
                        cause=repr(cause) if cause is not None else None):
            try:
                dcfg = self._degraded_cfg(key, cfg.max_batch)
                sig, u, vt = self._pipeline_call(key, dcfg,
                                                 [r.matrix for r in reqs],
                                                 tier="degraded-ref",
                                                 inject=False)
            except Exception as exc:             # noqa: BLE001 — last resort
                for r in reqs:
                    self._finish(r, error=cause if cause is not None else exc)
                return len(reqs)
            self.metrics.add(degraded=len(reqs))
            self._deliver(key, reqs, sig, u, vt, tier="degraded-ref")
            return len(reqs)

    def _retry_request(self, key: tuple, cfg, req: SVDRequest,
                       exc: Exception) -> int:
        """The per-request retry ladder: after a failed primary attempt,
        retry with capped exponential backoff up to the policy's attempt
        bound (tighter for ``NumericalFault``), never sleeping past the
        request's deadline; on exhaustion fall through to the degraded
        tier."""
        policy = self.retry
        failures = 1
        self._note_failure(key, exc)
        while failures < policy.attempts_for(exc):
            delay = policy.backoff_for(failures, deadline=req.deadline,
                                       now=time.monotonic())
            if delay is None:                    # would sleep past deadline
                break
            if delay > 0:
                time.sleep(delay)
            if self.quarantine.active(key):      # tripped meanwhile
                break
            self.metrics.add(retried=1)
            try:
                with self._span("serve/retry", bucket=bucket_key_str(key),
                                attempt=failures, backoff_s=delay):
                    sig, u, vt = self._pipeline_call(key, cfg, [req.matrix])
            except _ABSORBED as exc2:
                exc = exc2
                failures += 1
                self._note_failure(key, exc)
                continue
            except Exception as exc2:            # noqa: BLE001 — surfaced
                return self._fail(key, [req], exc2)
            self._note_success(key)
            self._deliver(key, [req], sig, u, vt)
            return 1
        return self._serve_degraded(key, cfg, [req], cause=exc)

    def _serve_batch(self, key: tuple, cfg, reqs: list[SVDRequest]) -> int:
        """Serve one dequeued batch; every request in ``reqs`` COMPLETES, in
        submission (FIFO) order.  A batch that fails with a fault of
        ``_ABSORBED`` falls back to per-request dispatches (isolating poison
        requests), each of which enters the retry ladder; a quarantined
        bucket skips the primary path entirely.  Any other error fails the
        whole batch (``_fail``)."""
        if self.quarantine.active(key):
            return self._serve_degraded(key, cfg, reqs, cause=None)
        try:
            sig, u, vt = self._pipeline_call(key, cfg,
                                             [r.matrix for r in reqs])
        except _ABSORBED as exc:                 # isolate below
            if len(reqs) == 1:
                return self._retry_request(key, cfg, reqs[0], exc)
            for r in reqs:                       # FIFO order preserved
                self._serve_batch(key, cfg, [r])
            return len(reqs)
        except Exception as exc:                 # noqa: BLE001 — surfaced
            return self._fail(key, reqs, exc)
        self._note_success(key)
        self._deliver(key, reqs, sig, u, vt)
        return len(reqs)

    def step(self) -> int:
        """Flush the fullest bucket with one batched call; #requests served.

        An empty engine is a no-op (returns 0, no dispatch).  Oversize
        buckets split at the bucket capacity: each step serves at most
        ``max_batch`` requests and leaves the tail queued, FIFO."""
        if not self.buckets:
            return 0
        key = max(self.buckets, key=lambda k: len(self.buckets[k]))
        try:
            cfg = self._cfg_for(key)
        except Exception as exc:                 # noqa: BLE001
            # The whole bucket shares the un-resolvable key (e.g. a band
            # whose chase block does not fit shared memory): fail its
            # requests, keep serving the other buckets.
            for r in self._pop(key, len(self.buckets[key])):
                self._finish(r, error=exc)
            return 0
        reqs = self._pop(key, cfg.max_batch)
        # Queue age is observed exactly once per request, here at dispatch
        # (the per-request fallback inside _serve_batch re-enters with the
        # same requests and must not re-observe).
        now = time.monotonic()
        for r in reqs:
            if r.arrived is not None:
                self.metrics.observe_queue_age(now - r.arrived)
        return self._serve_batch(key, cfg, reqs)

    def run(self, max_rounds: int = 10_000) -> list[SVDRequest]:
        rounds = 0
        while self.buckets and rounds < max_rounds:
            self.step()
            rounds += 1
        return self.finished
