"""Spectra across devices, after the reference's ``core/distributed.py``.

Two ways of spreading the pipeline over a mesh (``launch.mesh.DeviceMesh``,
an ordered tuple of devices on one ``"data"`` axis):

* **Batch dispatch.**  Each device owns a slice of a batch of matrices and
  runs the whole three-stage pipeline on it, with no exchange during the
  chase and one gather at the end (``sharded_singular_values``,
  ``sharded_svd``, ``sharded_pipeline_dispatch`` for the serving engines,
  ``spectrum_of_params`` for the weights of a model).  The reference runs a
  ``shard_map`` over its mesh; here one host thread per shard drives that
  shard's device, since the pipeline has host loops and syncs of its own.
  The results are gathered on the mesh's first device.
* **Column sharding of one band** (``reduce_stage_sharded``,
  ``bidiagonalize_sharded``).  The packed band is split by column; each
  shard chases the windows of a cycle whose pivot lies in its block, in
  place (``ops.band_stage``: the one-cycle band kernel of
  ``chase_cycle_cuda`` on the card, its plain version on the CPU), and a
  W-column halo passes between neighbouring shards each cycle.  The
  3-cycle separation leaves at most one window across each shard boundary
  per cycle, and its writes miss the neighbour's own windows, so the halo
  merge is a masked overwrite.  The whole schedule is on the devices
  before the first cycle: no cycle waits for the host.

Padding rows of a batch are zero matrices (sigma(0) = 0), dropped before
anyone sees them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import band as bandmod
from repro_torch.core import bulge_chasing as bc
from repro_torch.core import svd as svdmod
from repro_torch.core import tuning

__all__ = ["batched_singular_values", "sharded_singular_values",
           "sharded_svd", "sharded_pipeline_dispatch", "shard_pad",
           "spectrum_of_params", "square_embed", "process_info",
           "reduce_stage_sharded", "bidiagonalize_sharded"]


def process_info() -> tuple[int, int]:
    """``(rank, world_size)`` of the ``torch.distributed`` group this
    process belongs to, or ``(0, 1)`` when none is initialized."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank()), int(dist.get_world_size())
    except Exception:                        # noqa: BLE001 — one process
        pass
    return 0, 1


def square_embed(w, size: int) -> torch.Tensor:
    """Embed or crop an (m, k) matrix into (size, size); sigma is kept for
    size >= max(m, k) (padding adds zero singular values only)."""
    w = torch.as_tensor(w)
    m, k = w.shape
    if m < k:                       # sigma(A) == sigma(A^T); keep tall
        w = w.T
    w = w[:size, :size]
    out = w.new_zeros((size, size))
    out[: w.shape[0], : w.shape[1]] = w
    return out


def shard_pad(b: int, shards: int) -> int:
    """Rows to append so a batch of ``b`` splits evenly over ``shards``."""
    assert shards >= 1, shards
    return (-b) % shards


def _mesh_devices(mesh) -> tuple:
    """The mesh's devices, in order (the port's mesh has the one axis
    ``"data"`` and is a sequence of devices)."""
    devs = tuple(torch.device(d) for d in mesh)
    if not devs:
        raise ValueError("empty mesh")
    return devs


def _on(dev: torch.device):
    """The current device for this thread where ``dev`` is a card."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _per_shard(fn, shards: int) -> list:
    """``[fn(0), ..., fn(shards - 1)]``, one thread a shard (inline for one
    shard); the first shard's error is raised once every thread is done."""
    if shards == 1:
        return [fn(0)]
    out: list = [None] * shards
    errs: list = [None] * shards

    def body(j):
        try:
            out[j] = fn(j)
        except BaseException as exc:         # noqa: BLE001 — re-raised below
            errs[j] = exc

    threads = [threading.Thread(target=body, args=(j,), daemon=True,
                                name=f"shard-{j}") for j in range(shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for exc in errs:
        if exc is not None:
            raise exc
    return out


def _gather(parts: list, dev: torch.device, compute_uv: bool):
    """Concatenate the shards' results on ``dev``."""
    if compute_uv:
        return tuple(torch.cat([p[i].to(dev) for p in parts])
                     for i in range(3))
    return torch.cat([p.to(dev) for p in parts])


def _shard_configs(config, devs) -> list:
    return [dataclasses.replace(config, device=str(d)) for d in devs]


def batched_singular_values(mats, *, bw: int | None = None,
                            tw: int | None = None, backend: str = "auto",
                            config=None, compute_uv: bool = False,
                            device: str | None = None):
    """Batch-native three-stage pipeline: (B, n, n) -> (B, n) descending
    sigma, or ``(U, sigma, V^T)`` with ``compute_uv=True``; on
    ``config.device`` (the card unless ``device=`` or the config says
    otherwise)."""
    mats = torch.as_tensor(mats)
    if config is None:
        config = tuning.PipelineConfig.resolve(
            bw=bw if bw is not None else 32, tw=tw, backend=backend,
            dtype=mats.dtype, n=mats.shape[-1],
            device=device if device is not None else "cuda")
    return svdmod.svd_batched(mats, config, compute_uv=compute_uv)


def sharded_singular_values(mats, mesh, *, bw: int = 32,
                            tw: int | None = None, backend: str = "auto",
                            compute_uv: bool = False, config=None):
    """Spectra of (B, n, n) batch-dispatched over the mesh: (B, n), or with
    ``compute_uv=True`` ``(U, sigma, V^T)``, on the mesh's first device.

    B must divide evenly over the mesh; each device runs its slice of the
    batch end to end (with ``compute_uv`` its tapes' replay too), one
    matrix never crossing devices (``sharded_pipeline_dispatch``)."""
    devs = _mesh_devices(mesh)
    mats = torch.as_tensor(mats)
    if mats.shape[0] % len(devs):
        raise ValueError(f"batch {mats.shape[0]} does not divide over "
                         f"{len(devs)} shards (shard_pad)")
    if config is None:
        config = tuning.PipelineConfig.resolve(
            bw=bw, tw=tw, backend=backend, dtype=mats.dtype,
            n=mats.shape[-1], device=str(devs[0]))
    return sharded_pipeline_dispatch(mats, devs, config=config,
                                     compute_uv=compute_uv)


def sharded_svd(mats, mesh, *, bw: int = 32, tw: int | None = None,
                backend: str = "auto", config=None):
    """Full SVD batch-dispatched over the mesh: (B, n, n) ->
    ``(U (B, n, n), sigma (B, n), V^T (B, n, n))``."""
    return sharded_singular_values(mats, mesh, bw=bw, tw=tw, backend=backend,
                                   compute_uv=True, config=config)


def _local(ms, cfg, *, banded: bool, compute_uv: bool):
    """One device's dispatch in the serving engines' four modes."""
    if compute_uv:
        fn = svdmod.banded_svd if banded else svdmod.svd
        return fn(ms, config=cfg, compute_uv=True)
    if banded:
        return svdmod.banded_singular_values(ms, config=cfg)
    return svdmod.svd_batched(ms, cfg)


def sharded_pipeline_dispatch(mats, mesh, *, config, banded: bool = False,
                              compute_uv: bool = False, faults=None,
                              on_shard_retry=None):
    """The serving engines' mesh dispatch: pad the batch with zero matrices
    to divide over the mesh, run the bucket's pipeline on every shard (its
    own slice on its own device, one thread a shard), gather on the mesh's
    first device and drop the padding.

    ``config`` is the bucket's resolved config, given each shard's device.
    ``(banded, compute_uv)`` picks ``svd_batched`` /
    ``banded_singular_values`` / ``svd`` / ``banded_svd``, the engines'
    four local modes.

    A dispatch that raises on any shard is run again UNSHARDED on the
    mesh's first device, the whole padded batch through the same pipeline,
    and reported as ``on_shard_retry(shards)``.  ``faults`` (a
    :class:`~repro_torch.serve.faults.FaultPlan`) simulates the loss of
    single shards (``lost_shards``): each lost shard's results are dropped
    and its slice is run again on that shard's own device, on the same
    bytes, so the recovered results are bit for bit the clean run's; each
    is reported as ``on_shard_retry(1)``.  Spans: ``sharded_dispatch``
    around it all, ``sharded_fallback_unsharded`` and ``shard_retry``; the
    shards' own pipelines run on their threads, outside the caller's
    ambient tracer."""
    devs = _mesh_devices(mesh)
    shards = len(devs)
    mats = torch.as_tensor(mats)
    b0 = mats.shape[0]
    pad = shard_pad(b0, shards)
    if pad:
        mats = torch.cat([mats, mats.new_zeros((pad,) + mats.shape[1:])])
    per = mats.shape[0] // shards
    cfgs = _shard_configs(config, devs)

    def shard(j):
        with _on(devs[j]):
            ms = mats[j * per:(j + 1) * per].to(devs[j])
            return _local(ms, cfgs[j], banded=banded, compute_uv=compute_uv)

    with obs.span("sharded_dispatch", shards=shards, pad=pad, batch=int(b0),
                  n=int(mats.shape[-1]), banded=banded,
                  compute_uv=compute_uv) as dsp:
        try:
            parts = _per_shard(shard, shards)
        except Exception:                        # noqa: BLE001 — mesh down
            if on_shard_retry is not None:
                on_shard_retry(shards)
            with obs.span("sharded_fallback_unsharded", shards=shards) as sp:
                with _on(devs[0]):
                    out = sp.fence(_local(mats.to(devs[0]), cfgs[0],
                                          banded=banded,
                                          compute_uv=compute_uv))
            dsp.set(fallback="unsharded")
        else:
            lost = faults.lost_shards(shards) if faults is not None else []
            for j in sorted(set(lost)):
                parts[j] = None                  # that device's results: gone
                with obs.span("shard_retry", shard=j) as sp:
                    parts[j] = sp.fence(shard(j))
                if on_shard_retry is not None:
                    on_shard_retry(1)
            out = _gather(parts, devs[0], compute_uv)
        dsp.fence(out)
    if compute_uv:
        u, sig, vt = out
        return u[:b0], sig[:b0], vt[:b0]
    return out[:b0]


def _tree_leaves(tree, out: list) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _tree_leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tree_leaves(v, out)
    else:
        out.append(tree)


def _tree_rebuild(tree, it):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_rebuild(v, it)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_rebuild(v, it) for v in tree)
    return next(it)


def spectrum_of_params(params, *, size: int = 256, bw: int = 32,
                       tw: int | None = None, mesh=None,
                       backend: str = "auto", device: str | None = None):
    """Top spectra of every >= 2-D leaf of nested dicts and lists (a
    ``state_dict`` is one) of tensors or numpy arrays.

    Returns the same structure, each matrix leaf mapped to its length-
    ``size`` singular values (descending), leaves of more than 2 dims to
    ``(*lead, size)`` (stacked layers give their per-layer matrices), other
    leaves to ``None``.  The matrices run as one batch on ``device`` (the
    card unless ``device="cpu"``), or batch-dispatched over ``mesh``."""
    leaves: list = []
    _tree_leaves(params, leaves)

    def is_mat(leaf):
        return hasattr(leaf, "ndim") and leaf.ndim >= 2

    mats = []
    for leaf in leaves:
        if not is_mat(leaf):
            continue
        t = torch.as_tensor(leaf)
        w = t.reshape((-1,) + tuple(t.shape[-2:]))
        mats += [square_embed(w[b], size) for b in range(w.shape[0])]
    if not mats:
        return _tree_rebuild(params, iter([None] * len(leaves)))
    batch = torch.stack(mats)
    if mesh is not None:
        devs = _mesh_devices(mesh)
        cfg = tuning.PipelineConfig.resolve(
            bw=bw, tw=tw, backend=backend, dtype=batch.dtype, n=size,
            device=str(devs[0]))
        sig = sharded_pipeline_dispatch(batch, devs, config=cfg)
    else:
        sig = batched_singular_values(batch, bw=bw, tw=tw, backend=backend,
                                      device=device)
    out, k = [], 0
    for leaf in leaves:
        if not is_mat(leaf):
            out.append(None)
            continue
        lead = tuple(leaf.shape[:-2])
        nmat = int(np.prod(lead, dtype=np.int64)) if lead else 1
        vals = sig[k:k + nmat]
        out.append(vals[0] if not lead else vals.reshape(lead + (size,)))
        k += nmat
    return _tree_rebuild(params, iter(out))


# ---------------------------------------------------------------------------
# One band across devices: the packed band split by column (the paper's
# note that the GPU algorithm could take more devices).  Shard j holds
# columns [j*c, (j+1)*c) in ``ext[j]`` = its block, a W-column halo (the
# right neighbour's leading columns) and G zero dump windows for the slots
# whose pivot is not its own: the layout of a padded band
# (``tuning.band_padding``) with the block in place of the n columns.
# ---------------------------------------------------------------------------

def reduce_stage_sharded(band: torch.Tensor, *, n: int, b_in: int, tw: int,
                         mesh) -> torch.Tensor:
    """One SBR stage with the band ``(b_in + 2*tw + 1, ncols)`` split by
    column over the mesh, ``ncols`` a multiple of the mesh's size and at
    least ``n + W`` (W = b_in + tw + 1).  Returns the reduced band on
    ``band``'s device.

    Each cycle: every shard but the last copies its right neighbour's
    leading W columns into its halo; each shard chases, in place, the
    windows of the slots whose pivot lies in its block (``ops.band_stage``
    with those slots live: one launch of the one-cycle band kernel on the
    card; a slot that is not the shard's own points at a dump window and
    touches nothing); then each shard but the first takes from its left
    neighbour's halo the leading columns that neighbour's crossing window
    wrote (``m`` of them, from the schedule)."""
    from repro_torch.kernels import ops
    devs = _mesh_devices(mesh)
    d = len(devs)
    h = b_in + 2 * tw + 1
    w = b_in + tw + 1
    if band.dim() != 2 or band.shape[0] != h:
        raise ValueError(f"band has shape {tuple(band.shape)}, expected "
                         f"({h}, ncols)")
    nsweeps, total, g_max = bc.stage_schedule(n, b_in, tw)
    if nsweeps == 0:
        return band.clone()
    ncols = band.shape[1]
    if ncols % d or ncols < n + w:
        raise ValueError(f"ncols {ncols} must be a multiple of {d} and at "
                         f"least n + W = {n + w}")
    c = ncols // d
    if c < w:
        raise ValueError(f"shard width {c} must cover one chase window "
                         f"({w} columns)")
    width = tuning.band_padding(c, b_in, tw, 1, g_max)
    tt = torch.arange(total)[:, None]
    gg = torch.arange(g_max)[None, :]
    _, _, p, active, first = bc.chase_cycle_indices(tt, gg, n, b_in, tw)

    shards = []
    for j, dev in enumerate(devs):
        lo = j * c
        mine = active & (p >= lo) & (p < lo + c)
        crossing = active & (p > lo - w) & (p < lo)
        m = torch.where(crossing, p + w - lo, 0).amax(dim=1)
        ext = band.new_zeros((1, h, width), device=dev)
        ext[0, :, :c] = band[:, lo:lo + c].to(dev)
        shards.append(dict(
            ext=ext,
            p_safe=torch.where(mine, p - lo, c + w + gg * w).to(
                device=dev, dtype=torch.int32),
            live=mine[..., None].to(dev), first=first.to(dev).contiguous(),
            take=(torch.arange(w)[None, :] < m[:, None]).to(dev)))

    stages = []
    for s, dev in zip(shards, devs):
        with _on(dev):
            stages.append(ops.band_stage(
                s["ext"], s["p_safe"], s["first"], s["live"], n=c,
                b_in=b_in, tw=tw, fuse=1))
    for t in range(total):
        for j in range(d - 1):                   # fresh halos from the right
            with _on(devs[j]):
                shards[j]["ext"][0, :, c:c + w].copy_(
                    shards[j + 1]["ext"][0, :, :w])
        for stage, dev in zip(stages, devs):
            with _on(dev):
                stage(t)
        for j in range(1, d):                    # the left neighbour's writes
            cur = shards[j]
            with _on(devs[j]):
                recv = shards[j - 1]["ext"][0, :, c:c + w].to(devs[j])
                head = cur["ext"][0, :, :w]
                head.copy_(torch.where(cur["take"][t][None, :], recv, head))
    return torch.cat([s["ext"][0, :, :c].to(band.device) for s in shards],
                     dim=1)


def bidiagonalize_sharded(a, *, bw: int, tw: int, mesh):
    """SBR of an upper-banded (n, n) with the band split by column over the
    mesh in every stage: returns ``(diag, superdiag)`` on the mesh's first
    device."""
    devs = _mesh_devices(mesh)
    d = len(devs)
    a = torch.as_tensor(a).to(devs[0])
    n = a.shape[0]
    plan = tuning.stage_plan(bw, tw)
    if not plan:
        packed = bandmod.pack(a, bw, 0)
        return (bandmod.band_extract_diag(packed, 0, 0, n),
                bandmod.band_extract_diag(packed, 0, 1, n))
    tw_cur = plan[0][1]
    cur = bandmod.pack(a, bw, tw_cur)
    for b_in, twi in plan:
        h_i = b_in + 2 * twi + 1
        start = tw_cur - twi
        cur = cur[start:start + h_i]
        w_i = b_in + twi + 1
        ncols = max(-(-(n + w_i) // d) * d, d * w_i)
        cur = bandmod.pad_columns(cur, ncols - cur.shape[1])
        cur = reduce_stage_sharded(cur, n=n, b_in=b_in, tw=twi,
                                   mesh=devs)[:, :n]
        tw_cur = twi
    return (bandmod.band_extract_diag(cur, tw_cur, 0, n),
            bandmod.band_extract_diag(cur, tw_cur, 1, n))
