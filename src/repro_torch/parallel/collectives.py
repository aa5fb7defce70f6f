"""Collectives over the axes of a ``launch.mesh.ProcessMesh``: ``psum``,
``mean``, ``reduce_scatter``, ``all_gather`` and ``broadcast``, what the
Trainer's data-parallel step, PowerSGD and the checkpoints need.

Each is one ``torch.distributed`` call a mesh axis, on that axis's
subgroup: ``all_reduce``, ``reduce_scatter_tensor``,
``all_gather_into_tensor`` and ``broadcast``.  Ranks that
share one card run on gloo (NCCL refuses two ranks on one card), and the
gloo of the card's torch (2.11) takes CUDA tensors for all four (checked
on an H100, through pinned host memory); a backend that cannot run an op
on the tensors given raises, and nothing moves the work to another device.
A reduce-scatter or gather along a dim other than the first moves that
dim to the front first (a copy).

An op over several axes runs one after another over each axis's subgroup
(the mean over ("pod", "data") is the sum over "data", then over "pod";
a block over ("pod", "data") is the "pod" block's "data" block); an axis
of size 1 moves nothing.  Every op adds to ``mesh.traffic[site]`` one
call, the bytes of the whole tensor of each backend call (a
reduce-scatter's input, a gather's output), and the host's seconds in the
backend's calls (gloo returns once a CUDA tensor's result is copied back
or queued to be).
"""

from __future__ import annotations

import math
import time

import torch

__all__ = ["psum", "mean", "reduce_scatter", "all_gather", "broadcast",
           "gather_sharded"]


def _live(mesh, axes) -> tuple[str, ...]:
    return tuple(a for a in axes if mesh.shape.get(a, 1) > 1)


def _count(mesh, site: str, nbytes: int, t0: float) -> None:
    t = mesh.traffic.setdefault(site, {"calls": 0, "bytes": 0,
                                       "seconds": 0.0})
    t["calls"] += 1
    t["bytes"] += nbytes
    t["seconds"] += time.perf_counter() - t0


def psum(x: torch.Tensor, mesh, axes, site: str) -> torch.Tensor:
    """``x`` (contiguous, this rank's) replaced in place by its sum over
    the ranks that differ from this one on ``axes``; returns ``x``."""
    import torch.distributed as dist
    for a in _live(mesh, axes):
        t0 = time.perf_counter()
        dist.all_reduce(x, group=mesh.group(a))
        _count(mesh, site, x.numel() * x.element_size(), t0)
    return x


def mean(x: torch.Tensor, mesh, axes, site: str) -> torch.Tensor:
    """``x`` (contiguous, this rank's) replaced in place by its mean over
    the ranks that differ from this one on ``axes``; returns ``x``."""
    n = math.prod(mesh.shape.get(a, 1) for a in axes)
    if n > 1:
        psum(x, mesh, axes, site).div_(n)
    return x


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int,
                   site: str) -> torch.Tensor:
    """This rank's block, along ``dim`` over ``axes`` (the first major),
    of the mean of ``x`` over them, as a new tensor."""
    import torch.distributed as dist
    axes = _live(mesh, axes)
    y = x.movedim(dim, 0)
    for a in axes:
        n = mesh.shape[a]
        if y.shape[0] % n:
            raise ValueError(f"a dim of {y.shape[0]} does not split over "
                             f"{a} ({n} ranks)")
        y = y.contiguous()
        out = y.new_empty((y.shape[0] // n,) + tuple(y.shape[1:]))
        t0 = time.perf_counter()
        dist.reduce_scatter_tensor(out, y, group=mesh.group(a))
        _count(mesh, site, y.numel() * y.element_size(), t0)
        y = out
    if axes:
        y.div_(math.prod(mesh.shape[a] for a in axes))
    return y.movedim(0, dim).contiguous()


def all_gather(block: torch.Tensor, mesh, axes, dim: int, site: str,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The whole tensor whose blocks along ``dim`` over ``axes`` (the
    first major) the ranks hold, this rank ``block``; copied into ``out``
    when given (which ``block`` may be a view of)."""
    import torch.distributed as dist
    y = block.movedim(dim, 0)
    for a in reversed(_live(mesh, axes)):
        y = y.contiguous()
        full = y.new_empty((y.shape[0] * mesh.shape[a],)
                           + tuple(y.shape[1:]))
        t0 = time.perf_counter()
        dist.all_gather_into_tensor(full, y, group=mesh.group(a))
        _count(mesh, site, full.numel() * full.element_size(), t0)
        y = full
    y = y.movedim(0, dim)
    if out is None:
        return y.contiguous()
    return out.copy_(y)


def broadcast(x: torch.Tensor, mesh, site: str, src: int = 0
              ) -> torch.Tensor:
    """``x`` replaced in place by rank ``src``'s, over the whole group."""
    import torch.distributed as dist
    if math.prod(mesh.shape.values()) > 1:
        t0 = time.perf_counter()
        dist.broadcast(x, src=src)
        _count(mesh, site, x.numel() * x.element_size(), t0)
    return x


def gather_sharded(x: torch.Tensor, sharding, site: str) -> torch.Tensor:
    """The global array of which ``x`` is this rank's block under
    ``sharding`` (``parallel.sharding.Sharding``), on every rank."""
    for dim, axes in sharding.dims():
        x = all_gather(x.contiguous(), sharding.mesh, axes, dim, site)
    return x
