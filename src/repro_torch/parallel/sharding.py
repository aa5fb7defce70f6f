"""Logical-axis sharding rules (Megatron/GSPMD style), after the reference's
``parallel/sharding.py``.

Model code declares each parameter with *logical* axis names ("batch",
"vocab", "model_in", ...); an ``AxisRules`` maps those to the axes of a
process mesh (``launch.mesh.ProcessMesh``).  The rules and the specs they
give are the reference's, entry for entry:

  batch     -> ("pod", "data")  (DP over pod x data; hierarchical mean)
  model_in  -> "model"          (column-parallel weight input dim)
  model_out -> "model"          (row-parallel weight output dim)
  vocab     -> "model"          (vocab-parallel embedding + lm head)
  heads/kv  -> "model"          (attention-head parallelism)
  expert    -> "model"          (expert parallelism for MoE)
  seq       -> "model" only inside sequence-parallel sections (opt-in)

Where the reference hands a ``NamedSharding`` to XLA, which places each
shard, the port's :class:`Sharding` says which slice of a global array
this rank holds: each rank's tensors already are its shards, so
``act_shard`` has nothing to do.  Only the ``"data"`` and ``"pod"`` axes
carry work here; the Trainer refuses a ``"model"`` axis larger than 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any

__all__ = [
    "AxisRules", "set_rules", "current_rules", "use_rules", "act_shard",
    "logical_spec", "param_shardings", "zero1_shardings", "DEFAULT_RULES",
    "MULTIPOD_RULES", "PartitionSpec", "P", "Sharding", "map_logical",
]


def _entry(e):
    """One spec entry as the reference's ``PartitionSpec`` keeps it: a
    tuple of one axis is that axis, an empty tuple None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class PartitionSpec(tuple):
    """One entry a dim: None (whole), a mesh axis, or a tuple of axes (the
    dim split over their product, the first axis major).  Equal, entry for
    entry, to the reference's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where an array of a global shape lives on ``mesh``: each dim split
    over the product of its spec entry's axes; this rank holds the block at
    its mesh coordinates (mixed radix over a dim's axes, the first major,
    as the reference's mesh orders devices)."""
    mesh: Any
    spec: PartitionSpec

    def dims(self) -> list[tuple[int, tuple[str, ...]]]:
        """(dim, its axes of size > 1) of every dim that is split."""
        out = []
        for i, entry in enumerate(self.spec):
            axes = tuple(a for a in _axes(entry) if self.mesh.shape[a] > 1)
            if axes:
                out.append((i, axes))
        return out

    def local_slices(self, shape) -> tuple[slice, ...]:
        """This rank's block of an array of global ``shape``."""
        out = [slice(None)] * len(shape)
        for i, axes in self.dims():
            n = math.prod(self.mesh.shape[a] for a in axes)
            if shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"over {axes} ({n} ranks)")
            idx = 0
            for a in axes:
                idx = idx * self.mesh.shape[a] + self.mesh.coords[a]
            size = shape[i] // n
            out[i] = slice(idx * size, (idx + 1) * size)
        return tuple(out)

    def local_shape(self, shape) -> tuple[int, ...]:
        return tuple(len(range(*s.indices(d)))
                     for s, d in zip(self.local_slices(shape), shape))

    def take(self, x):
        """This rank's block of the global array ``x`` (a view where the
        array type slices by view: torch, numpy)."""
        return x[self.local_slices(x.shape)]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical name -> mesh axis (or tuple of axes, or None)."""
    rules: tuple[tuple[str, tuple[str, ...] | str | None], ...]
    mesh: Any = None

    def lookup(self, name: str | None):
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def spec(self, logical: tuple[str | None, ...]) -> PartitionSpec:
        phys = []
        used: set[str] = set()
        for name in logical:
            ax = self.lookup(name)
            if isinstance(ax, tuple):
                ax = tuple(a for a in ax if self._has(a) and a not in used)
                ax = ax if ax else None
            elif ax is not None and (not self._has(ax) or ax in used):
                ax = None
            if ax is not None:
                used.update(ax if isinstance(ax, tuple) else (ax,))
            phys.append(ax)
        return PartitionSpec(*phys)

    def _has(self, axis: str) -> bool:
        return self.mesh is None or axis in self.mesh.shape


_SINGLE = (
    ("batch", ("data",)),
    ("seq_kv", ("data",)),    # long-context decode: shard cache seq, not batch
    ("model_in", "model"),
    ("model_out", "model"),
    ("vocab", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("expert", "model"),
    ("dff", "model"),
    ("seq_sp", "model"),
)
_MULTI = (("batch", ("pod", "data")),
          ("seq_kv", ("pod", "data"))) + _SINGLE[2:]

DEFAULT_RULES = AxisRules(_SINGLE)
MULTIPOD_RULES = AxisRules(_MULTI)

_tls = threading.local()


def set_rules(rules: AxisRules | None):
    _tls.rules = rules


def current_rules() -> AxisRules | None:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def use_rules(rules: AxisRules | None):
    prev = current_rules()
    set_rules(rules)
    try:
        yield
    finally:
        set_rules(prev)


def logical_spec(logical: tuple[str | None, ...]) -> PartitionSpec:
    r = current_rules()
    return r.spec(logical) if r is not None else PartitionSpec()


def act_shard(x, logical: tuple[str | None, ...]):
    """The reference's sharding constraint on an activation.  Here it
    returns ``x``: each rank's tensors already hold that rank's shard, and
    no compiler moves them."""
    return x


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def map_logical(fn, tree, *rest):
    """``fn(logical, *leaves of rest at the same path)`` over a nested dict
    whose leaves are logical tuples (and ``rest`` of the same keys)."""
    if _is_logical(tree):
        return fn(tree, *rest)
    return {k: map_logical(fn, tree[k], *(r[k] for r in rest)) for k in tree}


def param_shardings(logical_tree, rules: AxisRules):
    """Nested dict of logical tuples -> nested dict of Shardings."""
    assert rules.mesh is not None
    return map_logical(lambda lg: Sharding(rules.mesh, rules.spec(lg)),
                       logical_tree)


def zero1_shardings(logical_tree, shape_tree, rules: AxisRules,
                    dp_axes: tuple[str, ...] = ("data",)):
    """ZeRO-1: optimizer-state shardings = param sharding + DP sharding on the
    first still-unsharded, divisible dimension (states live scattered over the
    data-parallel group; the Trainer gathers the updated parameters)."""
    assert rules.mesh is not None
    dp_axes = tuple(a for a in dp_axes if a in rules.mesh.shape)
    dp = 1
    for a in dp_axes:
        dp *= rules.mesh.shape[a]

    def one(logical, shape):
        spec = list(rules.spec(logical))
        spec += [None] * (len(shape) - len(spec))
        if dp > 1:
            for i, (ax, dim) in enumerate(zip(spec, shape)):
                if ax is None and dim % dp == 0 and dim >= dp:
                    spec[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
                    break
        return Sharding(rules.mesh, PartitionSpec(*spec))

    return map_logical(one, logical_tree, shape_tree)
