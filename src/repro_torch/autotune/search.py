"""Model-pruned search on the card over the ``(tw, fuse, batch)`` grid, and
the measured fused-tier and stage-3 crossovers.

The paper's tuning methodology, end to end: the analytic model
(``autotune/model.py``) ranks the FULL candidate grid by predicted cost;
only the top-K candidates — plus the static analytic default, always — are
actually timed (``autotune/measure.py``); the winner is whatever measured
fastest *per matrix*.  Because the default is always in the measured set,
the returned config beats or ties it by construction, and because every
measured candidate carries its prediction, the result reports
predicted-vs-measured error and the model's rank of the measured best —
the model is falsifiable (a bad model shows up as the winner ranked deep
in the list, or as large errors in the validation table).

``SearchResult.to_entry()`` is the persistent-cache payload
(``autotune/cache.py``); ``python -m repro_torch.autotune`` drives this
module.  The reference's ``autotune/search.py``, with this package's
pipeline and timer; every search takes the ``device`` it measures on (the
card unless the caller asks for the CPU) and a ``backend`` of the kernel
registry.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.autotune import measure as measure_mod
from repro_torch.autotune import model as model_mod
from repro_torch.core import tuning
from repro_torch.kernels import ops

__all__ = ["Candidate", "SearchResult", "candidate_grid", "search",
           "FusedCrossoverResult", "search_fused_crossover",
           "Stage3CrossoverResult", "search_stage3_crossover"]


@dataclasses.dataclass
class Candidate:
    """One grid point; times are seconds PER MATRIX (batched call / batch)."""
    tw: int
    fuse: int
    batch: int
    predicted_s: float
    measured_s: float | None = None

    @property
    def error_pct(self) -> float | None:
        """Signed prediction error vs measurement, in % of measured."""
        if self.measured_s is None or not math.isfinite(self.predicted_s):
            return None
        return 100.0 * (self.predicted_s - self.measured_s) / self.measured_s

    def label(self) -> str:
        return f"tw={self.tw} fuse={self.fuse} B={self.batch}"


def candidate_grid(n: int, bw: int, *, dtype=torch.float32,
                   fuses: tuple[int, ...] = (1, 2, 4, 8),
                   batches: tuple[int, ...] = (1,),
                   tws: tuple[int, ...] | None = None
                   ) -> list[tuple[int, int, int]]:
    """The full (tw, fuse, batch) grid for one shape.

    ``tws`` defaults to the powers of two below ``bw`` plus the two anchors
    that matter: the cache-line default and the single-stage width
    ``bw - 1`` (paper Fig. 4 sweeps the same axis).
    """
    if tws is None:
        cand = {1, bw - 1, tuning.default_tilewidth(bw, dtype)}
        p = 2
        while p < bw:
            cand.add(p)
            p *= 2
        tws = tuple(sorted(t for t in cand if 1 <= t <= max(bw - 1, 1)))
    return [(t, k, b) for t in tws for k in fuses if k >= 1
            for b in batches if b >= 1]


@dataclasses.dataclass
class SearchResult:
    n: int
    bw: int
    dtype: str
    backend: str
    compute_uv: bool
    device_kind: str
    top_k: int
    candidates: list[Candidate]          # full grid, predicted order
    measured: list[Candidate]            # timed subset (top-K + default)
    best: Candidate                      # measured argmin (per matrix)
    default: Candidate                   # the static analytic default
    batch_searched: bool = False         # batch axis had > 1 grid value

    def model_rank_of_best(self) -> int:
        """1-based rank of the measured-best candidate in the model's
        predicted ordering (1 = the model nailed it)."""
        for i, c in enumerate(self.candidates):
            if (c.tw, c.fuse, c.batch) == (self.best.tw, self.best.fuse,
                                           self.best.batch):
                return i + 1
        return len(self.candidates) + 1     # default-only winner, off-grid

    def table(self) -> str:
        """The predicted-vs-measured validation table (CLI output)."""
        hdr = (f"shape n={self.n} bw={self.bw} dtype={self.dtype} "
               f"backend={self.backend} uv={self.compute_uv} "
               f"device={self.device_kind}")
        lines = [hdr,
                 f"{'rank':>4} {'tw':>4} {'fuse':>4} {'B':>3} "
                 f"{'predicted_us':>13} {'measured_us':>12} {'err%':>7}"]
        by_key = {(c.tw, c.fuse, c.batch): c for c in self.measured}
        shown = 0
        for i, c in enumerate(self.candidates):
            m = by_key.pop((c.tw, c.fuse, c.batch), None)
            if m is None and shown >= self.top_k:
                continue
            shown += 1
            mu = f"{m.measured_s * 1e6:12.1f}" if m else f"{'-':>12}"
            err = (f"{m.error_pct:6.1f}%" if m and m.error_pct is not None
                   else f"{'-':>7}")
            pred = (f"{c.predicted_s * 1e6:13.1f}"
                    if math.isfinite(c.predicted_s) else f"{'vmem-cliff':>13}")
            mark = " <- best" if (c.tw, c.fuse, c.batch) == (
                self.best.tw, self.best.fuse, self.best.batch) else ""
            dflt = " (default)" if (c.tw, c.fuse, c.batch) == (
                self.default.tw, self.default.fuse, self.default.batch) else ""
            lines.append(f"{i + 1:>4} {c.tw:>4} {c.fuse:>4} {c.batch:>3} "
                         f"{pred} {mu} {err}{mark}{dflt}")
        lines.append(f"model rank of measured best: "
                     f"{self.model_rank_of_best()} of {len(self.candidates)} "
                     f"(top_k={self.top_k})")
        return "\n".join(lines)

    def to_entry(self) -> dict:
        """The persistent-cache payload for the winning config.

        ``max_batch`` is included ONLY when the batch axis was actually
        searched (> 1 grid value): a batches=(1,) run never compared batch
        sizes, and persisting its trivial ``batch=1`` would make
        ``resolve(autotune=True)`` serialize serve-side bucketing that the
        Eq.-1 analytic default would have batched.  Consumers treat a
        missing ``max_batch`` as "not tuned — use the analytic default".
        """
        entry = {
            "tw": int(self.best.tw),
            "fuse": int(self.best.fuse),
            "measured_us": round(self.best.measured_s * 1e6, 3),
            "predicted_us": (round(self.best.predicted_s * 1e6, 3)
                             if math.isfinite(self.best.predicted_s)
                             else None),
            "default_measured_us": (round(self.default.measured_s * 1e6, 3)
                                    if self.default.measured_s is not None
                                    else None),
            "model_rank_of_best": self.model_rank_of_best(),
            "schema": 1,
        }
        if self.batch_searched:
            entry["max_batch"] = int(self.best.batch)
        return entry


def _static_default(bw: int, dtype) -> tuple[int, int]:
    """The knobs ``PipelineConfig.resolve`` picks with no cache: the
    cache-line tilewidth and the paper's unfused schedule."""
    tw = max(1, min(tuning.default_tilewidth(bw, dtype), max(bw - 1, 1)))
    return tw, 1


def search(n: int, bw: int, *, dtype=torch.float32, backend: str = "auto",
           compute_uv: bool = False, top_k: int = 4,
           fuses: tuple[int, ...] = (1, 2, 4, 8),
           batches: tuple[int, ...] = (1,),
           profile: model_mod.DeviceProfile | None = None,
           warmup: int = 1, iters: int = 2, seed: int = 0,
           device="cuda", measure_fn=None) -> SearchResult:
    """Tune one shape: rank the grid by the model, time top-K + default.

    ``measure_fn(tw, fuse, batch) -> seconds (whole batched call)`` is
    injectable for tests; the real path is ``measure.time_stage2`` on the
    full ``bw -> 1`` reduction on ``device`` (so small tilewidths pay for
    the extra stages they force — the honest objective).  The default's
    batch is the smallest in ``batches``: this package has no bucket-size
    default until its serving layer.
    """
    if not batches or not fuses:
        raise ValueError(f"batches={batches!r} and fuses={fuses!r} must be "
                         f"non-empty")
    kind = model_mod.device_kind(device)
    prof = profile if profile is not None else model_mod.profile_for(kind)
    dname = tuning.dtype_name(dtype)
    backend = ops.resolve_backend(backend, device)
    if measure_fn is None:
        def measure_fn(tw, fuse, batch):
            return measure_mod.time_stage2(
                n, bw, tw=tw, fuse=fuse, batch=batch, backend=backend,
                dtype=dtype, tape=compute_uv, warmup=warmup, iters=iters,
                seed=seed, device=device)

    grid = candidate_grid(n, bw, dtype=dtype, fuses=fuses, batches=batches)
    d_tw, d_fuse = _static_default(bw, dtype)
    d_batch = min(batches)
    if (d_tw, d_fuse, d_batch) not in grid:
        grid.append((d_tw, d_fuse, d_batch))

    cands = [Candidate(t, k, b, predicted_s=model_mod.pipeline_cost(
        n, bw, t, fuse=k, batch=b, dtype=dtype, profile=prof,
        tape=compute_uv) / b) for (t, k, b) in grid]
    cands.sort(key=lambda c: (c.predicted_s, c.tw, c.fuse, c.batch))

    to_time = [c for c in cands if math.isfinite(c.predicted_s)][:top_k]
    default = next(c for c in cands if (c.tw, c.fuse, c.batch) ==
                   (d_tw, d_fuse, d_batch))
    if default not in to_time:
        to_time.append(default)
    for c in to_time:
        c.measured_s = measure_fn(c.tw, c.fuse, c.batch) / c.batch
    best = min(to_time, key=lambda c: c.measured_s)
    return SearchResult(n=n, bw=bw, dtype=dname, backend=backend,
                        compute_uv=compute_uv,
                        device_kind=kind, top_k=top_k,
                        candidates=cands, measured=to_time, best=best,
                        default=default,
                        batch_searched=len(set(batches)) > 1)


# ---------------------------------------------------------------------------
# Fused-tier crossover search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FusedCrossoverResult:
    """Measured fused-vs-staged crossover for one (device, dtype, uv, bw).

    ``points`` holds ``(n, fused_s, staged_s)`` per-matrix seconds for every
    n actually measured; ``fused_n_max`` is the largest measured n where the
    fused tier won (0 = never — the staged pipeline wins everywhere).
    ``predicted_n_max`` is the analytic model's figure
    (``model.predicted_crossover``) for the same setting, kept alongside so
    a wildly wrong model is visible in the cache entry itself.
    """
    bw: int
    dtype: str
    compute_uv: bool
    device_kind: str
    points: list[tuple[int, float, float]]
    fused_n_max: int
    predicted_n_max: int

    def table(self) -> str:
        lines = [f"fused crossover bw={self.bw} dtype={self.dtype} "
                 f"uv={self.compute_uv} device={self.device_kind}",
                 f"{'n':>5} {'fused_us':>10} {'staged_us':>10} {'winner':>7}"]
        for n, fused_s, staged_s in self.points:
            win = "fused" if fused_s < staged_s else "staged"
            lines.append(f"{n:>5} {fused_s * 1e6:10.1f} "
                         f"{staged_s * 1e6:10.1f} {win:>7}")
        lines.append(f"measured fused_n_max={self.fused_n_max} "
                     f"(model predicted {self.predicted_n_max})")
        return "\n".join(lines)

    def to_entry(self) -> dict:
        """The persistent-cache payload (``cache.store_crossover``)."""
        return {
            "fused_n_max": int(self.fused_n_max),
            "predicted_n_max": int(self.predicted_n_max),
            "points": [{"n": int(n),
                        "fused_us": round(f * 1e6, 3),
                        "staged_us": round(s * 1e6, 3)}
                       for n, f, s in self.points],
            "schema": 1,
        }


def search_fused_crossover(bw: int, *, dtype=torch.float32,
                           compute_uv: bool = False,
                           ns: tuple[int, ...] = (16, 32, 64, 128, 256,
                                                  384, 512),
                           batch: int = 8, warmup: int = 1, iters: int = 2,
                           seed: int = 0,
                           profile: model_mod.DeviceProfile | None = None,
                           device="cuda",
                           measure_fn=None) -> FusedCrossoverResult:
    """Measure the fused-vs-staged per-matrix crossover on ``device``.

    Walks ``ns`` ascending, timing the SAME dense random stack through the
    whole pipeline twice — once with ``backend="fused_small"``, once with
    the device's staged default — via ``core.svd.svd_batched``.  Stops at
    the first n whose fused scratch does not fit shared memory
    (``tuning.check_fused_smem_budget``; larger n only get worse).
    ``measure_fn(n, fused) -> seconds (whole batched call)`` is injectable
    for tests.  The result's ``.to_entry()`` feeds
    ``cache.store_crossover``.
    """
    from repro_torch.core import svd as svd_mod   # deferred: import cycle

    kind = model_mod.device_kind(device)
    prof = profile if profile is not None else model_mod.profile_for(kind)
    dname = tuning.dtype_name(dtype)

    if measure_fn is None:
        def measure_fn(n, fused):
            bw_eff = max(1, min(bw, max(n - 1, 1)))
            cfg = tuning.PipelineConfig.resolve(
                bw=bw_eff, dtype=dtype, n=n, compute_uv=compute_uv,
                backend="fused_small" if fused else "auto", device=device)
            rng = np.random.default_rng(seed)
            a = torch.from_numpy(rng.standard_normal((batch, n, n))).to(
                device=device, dtype=tuning.dtype_of(dtype))
            return measure_mod.measure_seconds(
                lambda: svd_mod.svd_batched(a, cfg, compute_uv=compute_uv),
                warmup=warmup, iters=iters, device=device)

    points: list[tuple[int, float, float]] = []
    fused_n_max = 0
    for n in sorted(set(int(x) for x in ns)):
        if n < 1:
            continue
        try:
            tuning.check_fused_smem_budget(n, dtype, compute_uv=compute_uv)
        except ValueError:
            break                      # ascending ns: larger n only worse
        fused_s = measure_fn(n, True) / batch
        staged_s = measure_fn(n, False) / batch
        points.append((n, float(fused_s), float(staged_s)))
        if fused_s < staged_s:
            fused_n_max = n
    predicted = model_mod.predicted_crossover(bw, dtype=dtype, batch=batch,
                                              profile=prof,
                                              compute_uv=compute_uv)
    return FusedCrossoverResult(bw=bw, dtype=dname, compute_uv=compute_uv,
                                device_kind=kind, points=points,
                                fused_n_max=fused_n_max,
                                predicted_n_max=predicted)


# ---------------------------------------------------------------------------
# Stage-3 solver crossover search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Stage3CrossoverResult:
    """Measured bisect-vs-D&C stage-3 crossover for one (device, dtype, uv).

    ``points`` holds ``(n, bisect_s, dc_s, agree)`` per-matrix seconds plus
    the max |sigma_dc - sigma_bisect| / sigma_max agreement for every n
    measured — the numerical check rides along with the timing so a cache
    entry can never enshrine a fast-but-wrong solver.  ``dc_n_min`` is the
    smallest measured n from which D&C stayed faster through the top of the
    sweep; when D&C never won it is ``1 + max(ns)`` — a beyond-any-measured-n
    threshold (``PipelineConfig`` "auto" then keeps bisection), NOT a cache
    miss.  ``predicted_n_min`` is ``model.predicted_stage3_crossover`` for
    the same setting, kept alongside so a wildly wrong model is visible in
    the cache entry itself.
    """
    dtype: str
    compute_uv: bool
    device_kind: str
    points: list[tuple[int, float, float, float]]
    dc_n_min: int
    predicted_n_min: int

    def table(self) -> str:
        lines = [f"stage3 crossover dtype={self.dtype} uv={self.compute_uv} "
                 f"device={self.device_kind}",
                 f"{'n':>6} {'bisect_us':>11} {'dc_us':>11} {'agree':>9} "
                 f"{'winner':>7}"]
        for n, bi_s, dc_s, agree in self.points:
            win = "dc" if dc_s < bi_s else "bisect"
            lines.append(f"{n:>6} {bi_s * 1e6:11.1f} {dc_s * 1e6:11.1f} "
                         f"{agree:9.1e} {win:>7}")
        lines.append(f"measured dc_n_min={self.dc_n_min} "
                     f"(model predicted {self.predicted_n_min})")
        return "\n".join(lines)

    def to_entry(self) -> dict:
        """The persistent-cache payload (``cache.store_stage3``)."""
        return {
            "dc_n_min": int(self.dc_n_min),
            "predicted_n_min": int(self.predicted_n_min),
            "points": [{"n": int(n),
                        "bisect_us": round(b * 1e6, 3),
                        "dc_us": round(d * 1e6, 3),
                        "agree": float(a)}
                       for n, b, d, a in self.points],
            "schema": 1,
        }


def search_stage3_crossover(*, dtype=torch.float64, compute_uv: bool = False,
                            ns: tuple[int, ...] = (256, 512, 1024, 2048,
                                                   4096),
                            batch: int = 4, warmup: int = 1, iters: int = 2,
                            seed: int = 0, leaf_n: int | None = None,
                            backend: str = "auto",
                            profile: model_mod.DeviceProfile | None = None,
                            device="cuda", bw: int | None = None,
                            measure_fn=None) -> Stage3CrossoverResult:
    """Measure the stage-3 bisect-vs-dc per-matrix crossover on ``device``.

    Walks ``ns`` ascending, timing the SAME bidiagonal stack ``(batch, n)``
    through ``core.bidiag_svd`` (bisection) and ``core.bidiag_dc`` (divide
    and conquer) — the values path, or the full ``compute_uv`` solve when
    asked — and recording the sigma agreement of the two.  With ``bw=None``
    the bidiagonals are i.i.d. normal, as the reference's; with a ``bw``
    they are what stage 2 makes of ``measure.banded_input(n, bw)``, the
    bidiagonals the pipeline hands stage 3 (they deflate far less).
    ``measure_fn(n, dc) -> (seconds, agree)`` (whole batched call; agree
    only needs to be meaningful on one of the two variants) is injectable
    for tests.  ``.to_entry()`` feeds ``cache.store_stage3``;
    ``PipelineConfig.resolve(autotune=True)`` reads it through
    ``cache.lookup_stage3``.
    """
    from repro_torch.core import bidiag_dc as dc_mod     # deferred: keep
    from repro_torch.core import bidiag_svd as bs_mod    # imports light
    from repro_torch.core import svd as svd_mod

    kind = model_mod.device_kind(device)
    prof = profile if profile is not None else model_mod.profile_for(kind)
    dname = tuning.dtype_name(dtype)
    leaf = leaf_n if leaf_n is not None else dc_mod.DEFAULT_DC_LEAF_N
    backend = ops.resolve_backend(backend, device)

    if measure_fn is None:
        made: dict = {}

        def bidiagonals(n):
            """The stack of size n, made once and timed by both solvers."""
            if n in made:
                return made[n]
            made.clear()
            if bw is not None:
                a = measure_mod.banded_input(n, bw, batch=batch, dtype=dtype,
                                             seed=seed, device=device)
                made[n] = svd_mod.bidiagonal_of(
                    a.reshape(batch, n, n),
                    config=tuning.PipelineConfig.resolve(
                        bw=bw, dtype=dtype, n=n, backend=backend,
                        device=device))
            else:
                rng = np.random.default_rng(seed)
                # e is (n,) with e[0] unused (e[i] = B[i-1, i])
                made[n] = tuple(torch.from_numpy(
                    rng.standard_normal((batch, n))).to(
                    device=device, dtype=tuning.dtype_of(dtype))
                    for _ in range(2))
            return made[n]

        def measure_fn(n, dc):
            d, e = bidiagonals(n)
            if dc:
                if compute_uv:
                    def fn():
                        return dc_mod.bidiag_dc_svd(d, e, leaf_n=leaf,
                                                    backend=backend)[1]
                else:
                    def fn():
                        return dc_mod.bidiag_dc_singular_values(
                            d, e, leaf_n=leaf, backend=backend)
            elif compute_uv:
                def fn():
                    return bs_mod.bidiag_svd(d, e, backend=backend)[1]
            else:
                def fn():
                    return bs_mod.bidiag_singular_values(d, e,
                                                         backend=backend)
            sig = fn()
            ref = bs_mod.bidiag_singular_values(d, e, backend=backend)
            scale = float(ref.abs().max()) or 1.0
            agree = float((sig - ref).abs().max()) / scale
            secs = measure_mod.measure_seconds(fn, warmup=warmup,
                                               iters=iters, device=device)
            return secs, agree

    points: list[tuple[int, float, float, float]] = []
    probe = sorted(set(int(x) for x in ns if x >= 1))
    for n in probe:
        bi_s, _ = measure_fn(n, False)
        dc_s, agree = measure_fn(n, True)
        points.append((n, float(bi_s) / batch, float(dc_s) / batch,
                       float(agree)))
    dc_n_min = 1 + (max(probe) if probe else 0)
    for n, bi_s, dc_s, _ in reversed(points):
        if dc_s < bi_s:
            dc_n_min = n
        else:
            break
    predicted = model_mod.predicted_stage3_crossover(
        dtype=dtype, batch=batch, profile=prof, leaf_n=leaf)
    return Stage3CrossoverResult(dtype=dname, compute_uv=compute_uv,
                                 device_kind=kind, points=points,
                                 dc_n_min=dc_n_min,
                                 predicted_n_min=predicted)

