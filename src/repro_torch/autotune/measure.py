"""The autotuner's timer: ``measure_seconds`` (median of k calls after a
warm-up) and its stage-2 workload ``time_stage2``, the whole ``bw -> 1``
reduction.

On the card each call is fenced with ``torch.cuda.synchronize()`` and timed
with CUDA events; on the CPU with the host clock.  Under an ambient
``repro_torch.obs`` tracer each ``measure_seconds`` is a span with a
``warmup`` child per discarded call (the first builds the kernels:
``compile="warmup0"``) and a ``rep`` child per timed one.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import band as bandmod
from repro_torch.core import bulge_chasing as bc
from repro_torch.core import tuning

__all__ = ["measure_seconds", "banded_input", "time_stage2"]


def measure_seconds(fn, *args, warmup: int = 1, iters: int = 3,
                    device="cuda", label: str = "measure") -> float:
    """Median seconds of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` discarded ones (the first builds the kernels).  On a CUDA
    ``device`` each call is fenced by ``torch.cuda.synchronize()`` and
    timed by CUDA events; on the CPU by ``time.perf_counter``.  Under an
    ambient tracer the call is a span named ``label`` with ``warmup`` and
    ``rep`` children."""
    cuda = torch.device(device).type == "cuda"
    with obs.span(label, warmup=warmup, iters=iters) as sp:
        for i in range(max(warmup, 0)):
            with obs.span("warmup", i=i) as w:
                if i == 0:
                    w.set(compile="warmup0")
                w.fence(fn(*args))
        ts = []
        for i in range(max(iters, 1)):
            with obs.span("rep", i=i):
                if cuda:
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn(*args)
                    end.record()
                    torch.cuda.synchronize()
                    ts.append(start.elapsed_time(end) / 1e3)
                else:
                    t0 = time.perf_counter()
                    fn(*args)
                    ts.append(time.perf_counter() - t0)
        med = sorted(ts)[len(ts) // 2]
        sp.set(median_s=med)
    return med


def banded_input(n: int, bw: int, *, batch: int = 1, dtype=torch.float32,
                 seed: int = 0, device="cuda") -> torch.Tensor:
    """Upper-banded test matrices (batch, n, n) (batch 1: (n, n)) from
    ``seed``, as the reference's ``measure.banded_input`` makes them."""
    rng = np.random.default_rng(seed)
    shape = (batch, n, n) if batch > 1 else (n, n)
    a = np.triu(rng.standard_normal(shape))
    a = np.triu(a) - np.triu(a, bw + 1)
    return torch.from_numpy(a).to(device=device,
                                  dtype=tuning.dtype_of(dtype))


def time_stage2(n: int, bw: int, *, tw: int, fuse: int = 1, batch: int = 1,
                backend: str = "auto", dtype=torch.float32,
                tape: bool = False, warmup: int = 1, iters: int = 3,
                seed: int = 0, device="cuda") -> float:
    """Median seconds of ONE batched stage-2 call at the candidate, the
    whole ``bw -> 1`` plan (so a small tw pays for the stages it adds),
    through ``bulge_chasing.bidiagonalize_packed``.  The band is packed
    outside the timing."""
    a = banded_input(n, bw, batch=batch, dtype=dtype, seed=seed,
                     device=device)
    packed = bandmod.pack(a, bw, min(tw, max(bw - 1, 1)))
    return measure_seconds(
        lambda: bc.bidiagonalize_packed(packed, n=n, bw=bw, tw=tw,
                                        backend=backend, tape=tape,
                                        fuse=fuse),
        warmup=warmup, iters=iters, device=device)
