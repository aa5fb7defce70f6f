"""AdamW, its schedule and clipping, after the reference's
``train/optimizer.py``, written out as the reference writes them (not
``torch.optim.AdamW``): the schedule in fp32, the gradients cast to fp32,
the spectral clip and then the global-norm clip on them, decay added to the
step on leaves of two or more dims, the update in fp32 and cast back to the
parameter's dtype.  The state is ``{"step", "m", "v"}``, m and v fp32 and
keyed as the parameters are.

``adamw_update`` updates the parameters, m and v in place (the reference
donates them to its jitted step, so the values are the same) and walks each
leaf in chunks, so that its fp32 temporaries stay at a chunk's size.  Under
ZeRO-1 it updates each rank's block of m, v and the parameters (the
reference states ZeRO-1 as shardings and lets GSPMD slice the same update).
``spectral_clip`` takes per-leaf sigma_max from ``train.spectral``'s
monitor: the paper's SVD pipeline on the parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.train.tree import get_path, items

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "clip_by_global_norm"]

_CHUNK = 1 << 26        # elements of a leaf updated at once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    spectral_clip: float = 0.0      # 0 = off; else max sigma ratio per update


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine to ``min_lr``, in fp32."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> dict:
    """Step 0 (int32) and fp32 zeros for m and v, on each leaf's device."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=torch.float32,
                           device=tree.device)
    dev = next(leaf for _, leaf in items(params)).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": zeros(params), "v": zeros(params)}


def _chunks(x: torch.Tensor):
    return x.reshape(-1).split(_CHUNK)


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    """sum(x ** 2) in fp32, chunk by chunk."""
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in _chunks(x):
        c = c.float()
        total = total + torch.sum(c * c)
    return total


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(leaf ** 2), in fp32."""
    total = 0
    for _, leaf in items(tree):
        total = total + _sq_sum(leaf)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / norm) in fp32 and cast back to each
    leaf's dtype, as new tensors; the norm before clipping)."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)

    def clip(tree):
        if isinstance(tree, dict):
            return {k: clip(v) for k, v in tree.items()}
        return (tree.float() * scale).to(tree.dtype)
    return clip(tree), g


def _spectral_factor(cfg: AdamWConfig, sig: torch.Tensor, ndim: int):
    """The reference's spectral rescale of one gradient leaf: per-layer
    sigma (stacked leaves) reshaped over the leaf's trailing dims, in
    sigma's own dtype."""
    sig = sig.reshape(sig.shape + (1,) * (ndim - sig.dim()))
    sig = torch.clamp(sig, min=1e-9)
    limit = cfg.spectral_clip * sig
    return torch.clamp(limit / sig, max=1.0)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig,
                 sigma_tree: Any | None = None, *, slices=None,
                 reduce_sq=None):
    """One AdamW step, in place.  Returns (params, state, metrics {"lr",
    "grad_norm"}), the same params and state objects updated.

    ``grads`` (keyed as ``params``) is taken as scratch: each leaf is cast
    to fp32, and an fp32 leaf is rescaled in place.  ``sigma_tree``:
    optional per-leaf sigma_max (``SpectralMonitor.sigma_max_tree``); with
    ``cfg.spectral_clip > 0`` each gradient leaf of >= 2 dims is rescaled
    by min(1, spectral_clip * sigma / sigma), as the reference does.  The
    global norm (reported as "grad_norm") is taken after that and before
    the global clip.

    ZeRO-1: ``slices`` (keyed as ``params``) gives a leaf's block, a tuple
    of slices, or None where the leaf is whole.  A sliced leaf's gradient,
    m and v hold only that block, and only that block of the parameter is
    updated (the caller gathers the rest); decay still follows the whole
    leaf's ndim.  The squares of the blocks are summed by
    ``reduce_sq(partial)`` across the ranks that hold the other blocks, and
    the whole leaves' squares added once, so the norm is the whole
    gradient's."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    paths = [path for path, _ in items(params)]
    p_l = [leaf for _, leaf in items(params)]
    g_l = [get_path(grads, path).float() for path in paths]
    s_l = [None if slices is None else get_path(slices, path)
           for path in paths]
    if cfg.spectral_clip > 0 and sigma_tree is not None:
        for i, path in enumerate(paths):
            sig = get_path(sigma_tree, path)
            if sig is not None and g_l[i].dim() >= 2:
                factor = _spectral_factor(cfg, sig.to(g_l[i].device),
                                          g_l[i].dim())
                if s_l[i] is not None:
                    factor = factor.expand(p_l[i].shape)[s_l[i]]
                g_l[i].mul_(factor)
    if slices is None:
        gnorm = global_norm(dict(enumerate(g_l)))
    else:
        part = sum((_sq_sum(g) for g, s in zip(g_l, s_l) if s is not None),
                   torch.zeros((), dtype=torch.float32, device=g_l[0].device))
        whole = sum(_sq_sum(g) for g, s in zip(g_l, s_l) if s is None)
        gnorm = torch.sqrt(reduce_sq(part) + whole)
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        for g in g_l:
            g.mul_(scale)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for path, p, g, sl in zip(paths, p_l, g_l, s_l):
        m = get_path(state["m"], path)
        v = get_path(state["v"], path)
        decay = p.dim() >= 2 and cfg.weight_decay
        target = p if sl is None else p[sl]
        work = target if target.is_contiguous() else target.contiguous()
        for pc, gc, mc, vc in zip(_chunks(work), _chunks(g), _chunks(m),
                                  _chunks(v)):
            mc.copy_(b1 * mc + (1 - b1) * gc)
            vc.copy_(b2 * vc + (1 - b2) * gc * gc)
            delta = (mc / bc1) / (torch.sqrt(vc / bc2) + cfg.eps)
            pf = pc.float()
            if decay:
                delta = delta + cfg.weight_decay * pf
            pc.copy_(pf - lr * delta)
        if work is not target:
            target.copy_(work)
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}
