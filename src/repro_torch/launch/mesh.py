"""Meshes of local cards and the multi-process bootstrap, after the
reference's ``launch/mesh.py``.

The port's mesh is :class:`DeviceMesh`: an ordered tuple of
``torch.device`` on one ``"data"`` axis (``mesh.shape["data"]`` is its
length).  Like the reference's ``shard_map`` mesh it lives in one process
and spans that process's local devices; ``core.distributed`` runs one shard
of a batch on each.

:func:`serve_mesh` builds the serving engines' mesh from
``$REPRO_SERVE_MESH``; it spans distinct cards only, never the CPU.  A mesh
whose shards share one card is built by hand (``DeviceMesh(["cuda:0"] *
2)``), as tests and ``chip_smoke.py`` do on a machine with one card.

:func:`init_distributed` boots ``torch.distributed`` on gloo for worker
processes that want a process group (the worker's ``--coordinator``).
Gloo, because the fabric runs no device collective, and NCCL refuses two
ranks on one card.  Like every function here, importing this module
touches no device.

Training across processes has a mesh of its own, :class:`ProcessMesh`:
named axes over the ranks of the default process group (``"data"``,
``"pod"``, ``"model"``), each rank's coordinates on them, one subgroup per
axis for ``parallel.collectives``, and the rank's device.
:func:`make_mesh` builds one, :func:`make_production_mesh` the reference's
(16, 16) and (2, 16, 16) meshes, and :func:`rules_for` the sharding rules
of a mesh (``parallel.sharding``).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import warnings

import numpy as np
import torch

from repro_torch.parallel.sharding import (DEFAULT_RULES, MULTIPOD_RULES,
                                           AxisRules)

__all__ = ["DeviceMesh", "serve_mesh", "init_distributed", "ProcessMesh",
           "make_mesh", "make_production_mesh", "rules_for"]

# how long the rendezvous waits for the other processes: the process
# group's own default would block for 30 minutes on a missing peer
DIST_TIMEOUT_S = 60.0


class DeviceMesh(tuple):
    """An ordered tuple of ``torch.device`` on one ``"data"`` axis.

    >>> mesh = DeviceMesh(["cuda:0", "cuda:1"])
    >>> mesh.shape["data"]
    2
    """

    def __new__(cls, devices):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return super().__new__(cls, devs)

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self)}

    @property
    def devices(self) -> tuple:
        return tuple(self)

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self]})"


def serve_mesh() -> DeviceMesh | None:
    """The serving engines' mesh from ``$REPRO_SERVE_MESH``, or ``None``.

    * unset or empty: ``None``, the engines dispatch on their own device;
    * ``"auto"``: every local card, ``cuda:0`` to ``cuda:k-1``;
    * an integer: that many local cards, clamped to
      ``torch.cuda.device_count()``.

    ``None`` as well where fewer than 2 cards would take part (one card, or
    none): a mesh never repeats a device and never holds the CPU.  A value
    that is neither ``"auto"`` nor an integer raises ``ValueError``: a
    mistyped setting should be loud, not silently one device.  Local cards
    only: under a process group (``init_distributed``) the other processes'
    cards are theirs to feed."""
    spec = os.environ.get("REPRO_SERVE_MESH", "").strip().lower()
    if not spec:
        return None
    if spec != "auto":
        try:
            int(spec)
        except ValueError:
            raise ValueError(
                f"$REPRO_SERVE_MESH={spec!r}: expected unset, 'auto', or "
                f"a device count") from None
    local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    ndev = local if spec == "auto" else min(int(spec), local)
    if ndev < 2:
        return None
    return DeviceMesh([f"cuda:{i}" for i in range(ndev)])


def init_distributed(*, coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join a ``torch.distributed`` process group on gloo over
    ``tcp://<coordinator>``; True iff the group is up.

    The arguments, else ``$REPRO_DIST_COORDINATOR``,
    ``$REPRO_DIST_NUM_PROCESSES`` and ``$REPRO_DIST_PROCESS_ID``; the
    rendezvous waits ``DIST_TIMEOUT_S``.  Never raises: an unset or
    partial setting returns False (one process is the default, not an
    error), and a failed rendezvous warns and returns False, since the
    fabric's processes talk over their own sockets (``serve/router.py``)
    and a worker serves its local devices without a group.  Idempotent: a
    second call is a no-op True."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ.get
    coordinator = coordinator or env("REPRO_DIST_COORDINATOR", "")
    nproc = (num_processes if num_processes
             else int(env("REPRO_DIST_NUM_PROCESSES", "0") or 0))
    pid = (process_id if process_id is not None and process_id >= 0
           else int(env("REPRO_DIST_PROCESS_ID", "-1") or -1))
    if not coordinator or nproc < 2 or pid < 0:
        return False
    if not dist.is_available():
        warnings.warn("torch.distributed is not available (serving "
                      "single-process)", stacklevel=2)
        return False
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}", world_size=nproc,
            rank=pid, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    except Exception as exc:                 # noqa: BLE001 — best effort
        warnings.warn(f"torch.distributed.init_process_group failed "
                      f"(serving single-process): {exc!r}", stacklevel=2)
        return False
    return True


class ProcessMesh:
    """Named axes over the ranks of the default process group.

    Rank r sits at the row-major coordinates of r in ``shape`` (the last
    axis fastest, as the reference's ``jax.make_mesh`` lays devices out).
    ``shape`` is {axis: size}, ``coords`` {axis: this rank's coordinate};
    ``group(axis)`` is the subgroup of the ranks that differ from this one
    on ``axis`` only.  ``device`` is this rank's card (``cuda:<rank mod
    cards>``) unless the caller passes one (``device="cpu"``).
    ``traffic`` is {call site: {"calls", "bytes", "seconds"}}, what
    ``parallel.collectives`` handed the backend from this rank and the
    host's time in its calls.

    Every rank must build the same meshes in the same order: each builds
    its subgroups, a collective call."""

    def __init__(self, shape, axes, device=None):
        import torch.distributed as dist
        sizes = tuple(int(n) for n in shape)
        axes = tuple(axes)
        if len(sizes) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {sizes} and axes {axes} do not "
                             f"pair up")
        world, rank = dist.get_world_size(), dist.get_rank()
        if math.prod(sizes) != world:
            raise ValueError(f"a mesh of shape {dict(zip(axes, sizes))} "
                             f"needs {math.prod(sizes)} processes; the "
                             f"process group has {world}")
        self.shape = dict(zip(axes, sizes))
        self.coords = {a: int(c) for a, c in
                       zip(axes, np.unravel_index(rank, sizes))}
        self.rank = rank
        grid = np.arange(world).reshape(sizes)
        self._groups = {}
        for i, axis in enumerate(axes):
            for ranks in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
                group = dist.new_group(ranks.tolist())
                if rank in ranks:
                    self._groups[axis] = group
        if device is None:
            from repro_torch.kernels.ops import check_device
            check_device("cuda")
            device = torch.device("cuda", rank % torch.cuda.device_count())
        self.device = torch.device(device)
        self.traffic: dict[str, dict] = {}

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, rank {self.rank} at "
                f"{self.coords}, {self.device})")


def make_mesh(shape, axes, device=None) -> ProcessMesh:
    """A :class:`ProcessMesh` of ``shape`` over ``axes``."""
    return ProcessMesh(shape, axes, device=device)


def make_production_mesh(*, multi_pod: bool = False) -> ProcessMesh:
    """(16, 16) = (data, model) single pod; (2, 16, 16) = (pod, data,
    model) for the 2-pod, 512-chip production target.  Raises
    ``ValueError`` unless the process group has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def rules_for(mesh) -> AxisRules:
    base = MULTIPOD_RULES if "pod" in mesh.shape else DEFAULT_RULES
    return dataclasses.replace(base, mesh=mesh)
