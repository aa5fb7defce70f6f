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

The reference's ``make_production_mesh`` and ``rules_for`` belong to its
``parallel/`` package, which the port does not have yet.
"""

from __future__ import annotations

import datetime
import os
import warnings

import torch

__all__ = ["DeviceMesh", "serve_mesh", "init_distributed"]

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
