"""Minimal functional module substrate (params are nested dicts of tensors),
after the reference's ``models/modules.py``.

Every parameter is declared through ``param(...)``, which records its shape,
dtype, *logical sharding axes* and init rule; ``init_tree`` materializes a
tree of them from an explicit ``torch.Generator`` on an explicit device,
and ``logical_tree`` and ``shape_tree`` extract the matching trees of
logical axes and shapes, from which ``parallel.sharding`` places each
parameter and its optimizer state on a process mesh.  Weights keep the
reference's layout, (in, out), so ``x @ w`` is a plain ``torch.matmul`` and
the reference's weights carry across without a transpose.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

__all__ = ["ParamSpec", "param", "spec_items", "init_tree", "logical_tree",
           "shape_tree", "dense", "rmsnorm_p", "rmsnorm", "embedding_p",
           "swiglu_p", "swiglu"]

_CHUNK = 1 << 26     # elements drawn at once, so the fp32 draw stays small


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype
    logical: tuple[str | None, ...]
    init: str = "normal"              # normal | zeros | ones | scaled
    scale: float = 1.0

    @property
    def std(self) -> float:
        """The reference's rule: ``fan_in = shape[0]``, which for a stacked
        layer weight (L, in, out) is L, not ``in``."""
        fan_in = self.shape[0] if len(self.shape) > 1 else max(self.shape[0], 1)
        if self.init == "scaled":
            return self.scale / math.sqrt(fan_in)
        return 0.02

    def materialize(self, generator: torch.Generator, device,
                    out: torch.Tensor | None = None) -> torch.Tensor:
        """Values drawn in fp32 from ``generator`` (on ``device``), times
        ``std``, rounded to the dtype; into ``out`` when given.  Large
        tensors are drawn slice by slice along their first axis."""
        if out is None:
            out = torch.empty(self.shape, dtype=self.dtype, device=device)
        if self.init in ("zeros", "ones"):
            return out.fill_(0.0 if self.init == "zeros" else 1.0)
        flat = out.view(out.shape[0], -1) if out.dim() > 1 else out.view(1, -1)
        rows = max(1, _CHUNK // max(flat.shape[1], 1))
        for r0 in range(0, flat.shape[0], rows):
            part = flat[r0:r0 + rows]
            draw = torch.randn(part.shape, generator=generator,
                               dtype=torch.float32, device=out.device)
            part.copy_(draw.mul_(self.std))
        return out


def param(shape, dtype, logical, init="scaled", scale=1.0) -> ParamSpec:
    assert len(logical) == len(shape), (shape, logical)
    return ParamSpec(tuple(shape), dtype, tuple(logical), init, scale)


def spec_items(spec_tree, prefix: str = ""):
    """(path, ParamSpec) of a nested dict of specs, keys sorted, the path
    joined by ".": the order every init draws in."""
    for key in sorted(spec_tree):
        val = spec_tree[key]
        path = f"{prefix}{key}"
        if isinstance(val, ParamSpec):
            yield path, val
        else:
            yield from spec_items(val, f"{path}.")


def init_tree(spec_tree, generator: torch.Generator, device) -> dict:
    """Materialize a nested dict of ParamSpecs into tensors on ``device``,
    drawing from ``generator`` in sorted-path order."""
    out: dict = {}
    for path, spec in spec_items(spec_tree):
        node = out
        *parents, leaf = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = spec.materialize(generator, device)
    return out


def _map_specs(fn, spec_tree) -> dict:
    return {k: fn(v) if isinstance(v, ParamSpec) else _map_specs(fn, v)
            for k, v in spec_tree.items()}


def logical_tree(spec_tree) -> dict:
    """The nested dict of each parameter's logical axes."""
    return _map_specs(lambda s: s.logical, spec_tree)


def shape_tree(spec_tree) -> dict:
    """The nested dict of each parameter's shape."""
    return _map_specs(lambda s: s.shape, spec_tree)


# ---------------------------------------------------------------------------
# primitive layers (functional)
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w, output in x.dtype (bf16 products sum in fp32 inside the
    matmul, as on the reference's hardware)."""
    out = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        out = out + b.to(x.dtype)
    return out


def rmsnorm_p(d: int, dtype) -> ParamSpec:
    return param((d,), dtype, (None,), init="ones")


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g.to(x.dtype)


def embedding_p(vocab: int, d: int, dtype) -> ParamSpec:
    return param((vocab, d), dtype, ("vocab", None), init="normal")


def swiglu_p(d: int, f: int, dtype) -> dict:
    return {
        "wi": param((d, 2 * f), dtype, (None, "dff")),    # gate+up fused
        "wo": param((f, d), dtype, ("dff", None)),
    }


def swiglu(x: torch.Tensor, p: dict) -> torch.Tensor:
    gu = dense(x, p["wi"])
    g, u = gu.chunk(2, dim=-1)
    return dense(F.silu(g) * u, p["wo"])
