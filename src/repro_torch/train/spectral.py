"""Spectral monitoring, after the reference's ``train/spectral.py``: the
paper's pipeline as a training feature.

Every ``every`` steps the monitor computes the top singular values of each
weight matrix (each layer's, for stacked leaves) through
``core.distributed.spectrum_of_params``, one batched three-stage SVD on the
leaves' device: on the card, stage 1 on ``hh_apply.cu``, stage 2 on the
chase kernel, stage 3 on ``sturm.cu``.  The leaves keep their own dtype,
as in the reference.  Consumers:

* health metrics: sigma_max, stable rank ``||W||_F^2 / sigma_max^2`` and
  spectral entropy per leaf;
* ``sigma_max_tree`` for the optimizer's spectral clip
  (``optimizer.adamw_update``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.distributed import spectrum_of_params
from repro_torch.train.tree import items, map_tree

__all__ = ["SpectralMonitorConfig", "SpectralMonitor", "spectral_metrics"]


@dataclasses.dataclass(frozen=True)
class SpectralMonitorConfig:
    every: int = 100            # refresh period (steps)
    size: int = 128             # square-embed size (top-k spectrum window)
    bw: int = 16                # stage-1 target bandwidth
    tw: int | None = None       # stage-2 inner tilewidth (None -> tuned)
    backend: str = "auto"


def spectral_metrics(sigma: torch.Tensor) -> dict:
    """Summary stats from one descending spectrum, in fp32."""
    s = sigma.float()
    smax = s[0]
    fro2 = torch.sum(s * s)
    stable_rank = fro2 / torch.clamp(smax * smax, min=1e-20)
    p = s * s / torch.clamp(fro2, min=1e-20)
    entropy = -torch.sum(torch.where(
        p > 0, p * torch.log(torch.clamp(p, min=1e-20)), 0.0))
    return {"sigma_max": smax, "stable_rank": stable_rank,
            "spectral_entropy": entropy}


class SpectralMonitor:
    """``maybe_refresh`` recomputes the spectra when due, on the device of
    the tree's leaves (``mesh``: batch-dispatched over a ``DeviceMesh``)."""

    def __init__(self, cfg: SpectralMonitorConfig, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.sigma_tree: Any = None
        self.last_refresh: int = -1

    def maybe_refresh(self, step: int, tree) -> bool:
        """Recompute spectra if due.  ``tree``: params or grads."""
        if self.last_refresh >= 0 and step - self.last_refresh < self.cfg.every:
            return False
        c = self.cfg
        device = str(next(leaf for _, leaf in items(tree)).device)
        with torch.no_grad():
            self.sigma_tree = spectrum_of_params(
                tree, size=c.size, bw=c.bw, tw=c.tw, mesh=self.mesh,
                backend=c.backend, device=device)
        self.last_refresh = step
        return True

    def sigma_max_tree(self):
        """Per-leaf sigma_max (None for non-matrix leaves) for the optimizer."""
        if self.sigma_tree is None:
            return None
        return map_tree(lambda s: None if s is None else s[..., 0],
                        self.sigma_tree)

    def metrics(self) -> dict:
        """{"spectral/<path>/<stat>": float} of each matrix leaf's first
        spectrum (layer 0 of a stacked leaf)."""
        out = {}
        if self.sigma_tree is None:
            return out
        for path, sig in items(self.sigma_tree):
            if sig is None:
                continue
            name = "/".join(str(p) for p in path)
            vec = sig.reshape(-1, sig.shape[-1])[0]
            for k, v in spectral_metrics(vec).items():
                out[f"spectral/{name}/{k}"] = float(v)
        return out
