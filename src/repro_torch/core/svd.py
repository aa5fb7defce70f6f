"""Singular values of banded matrices: stage 2 (bulge chasing) and stage 3
(Sturm bisection), batch-native.

``banded_singular_values`` is the paper's own use case and this package's
public entry point.  It runs on the card unless the caller asks for the
CPU: the config's ``device`` is "cuda" by default, a missing card raises
``RuntimeError``, and ``device="cpu"`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bidiag_svd as s3
from repro_torch.core import bulge_chasing as bc
from repro_torch.core import tuning

__all__ = ["NumericalFault", "validate_sigma", "bidiagonal_of",
           "banded_singular_values"]


class NumericalFault(ArithmeticError):
    """A result failed post-solve validation: non-finite, negative or
    unsorted sigma."""


def _sigma_tol(s: torch.Tensor) -> float:
    """Slack for the non-negativity and order checks: a few ulps of the
    spectrum's scale."""
    if s.numel() == 0:
        return 0.0
    eps = torch.finfo(s.dtype).eps if s.is_floating_point() else 0.0
    fin = s[torch.isfinite(s)]
    smax = float(fin.abs().max()) if fin.numel() else 1.0
    return 16.0 * eps * max(smax, 1.0)


def validate_sigma(sig, *, name: str = "sigma") -> None:
    """Every value finite, non-negative (to rounding slack) and descending
    along the last axis; raises :class:`NumericalFault` otherwise.  Reads
    the values on the host, so it waits for the device."""
    s = torch.as_tensor(sig).detach().cpu()
    if s.numel() == 0:
        return
    finite = torch.isfinite(s)
    if not bool(finite.all()):
        bad = int((~finite).sum())
        raise NumericalFault(f"{name}: {bad} non-finite value(s)")
    tol = _sigma_tol(s)
    mn = float(s.min())
    if mn < -tol:
        raise NumericalFault(f"{name}: negative value {mn:.3e} < -{tol:.1e}")
    if s.shape[-1] >= 2:
        rise = float((s[..., 1:] - s[..., :-1]).max())
        if rise > tol:
            raise NumericalFault(f"{name}: not descending (adjacent rise "
                                 f"{rise:.3e} > {tol:.1e})")


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        return torch.tensor(a)
    return a


def _config(a: torch.Tensor, *, bw, tw, config, device
            ) -> tuning.PipelineConfig:
    """The config of this call: a given one, checked against the other
    arguments (a conflict raises), or one resolved from them."""
    if config is None:
        return tuning.PipelineConfig.resolve(
            bw=bw if bw is not None else 32, tw=tw, dtype=a.dtype,
            n=a.shape[-1], device=device if device is not None else "cuda")
    if bw is not None and bw != config.bw:
        raise ValueError(f"bw={bw} conflicts with config.bw={config.bw}")
    if tw is not None and tw != config.tw:
        raise ValueError(f"tw={tw} conflicts with config.tw={config.tw}")
    if device is not None and torch.device(device) != torch.device(
            config.device):
        raise ValueError(f"device={device!r} conflicts with "
                         f"config.device={config.device!r}")
    if tuning.dtype_name(a.dtype) != config.dtype:
        raise ValueError(f"input dtype {a.dtype} conflicts with "
                         f"config.dtype={config.dtype}")
    if config.stage3 != "bisect":
        raise NotImplementedError(tuning.LATER.get(config.stage3,
                                                   config.stage3))
    from repro_torch.kernels import ops
    ops.resolve_backend(config.backend, config.device)
    return config


def _on_device(a: torch.Tensor, device: str) -> torch.Tensor:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this call runs on a CUDA device and torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return a.to(dev)


def bidiagonal_of(a, *, bw: int | None = None, tw: int | None = None,
                  config: tuning.PipelineConfig | None = None,
                  device: str | None = None):
    """Stage 2 only: upper-banded (..., n, n) -> (diag, superdiag)."""
    a = _as_tensor(a)
    cfg = _config(a, bw=bw, tw=tw, config=config, device=device)
    a = _on_device(a, cfg.device)
    return bc.bidiagonalize(a, bw=cfg.bw, tw=cfg.tw, config=cfg)


def banded_singular_values(a, *, bw: int | None = None,
                           tw: int | None = None,
                           config: tuning.PipelineConfig | None = None,
                           device: str | None = None,
                           check: bool = False) -> torch.Tensor:
    """Singular values of upper-banded (..., n, n), descending, on
    ``config.device``.

    ``a`` may be a numpy array or a tensor on any device; it is moved to the
    config's device ("cuda" unless ``device=`` or the config says
    otherwise).  Leading axes are a batch that runs on one wavefront.
    ``check=True`` runs :func:`validate_sigma` on the result."""
    a = _as_tensor(a)
    cfg = _config(a, bw=bw, tw=tw, config=config, device=device)
    a = _on_device(a, cfg.device)
    d, e = bc.bidiagonalize(a, bw=cfg.bw, tw=cfg.tw, config=cfg)
    sig = s3.bidiag_singular_values(d, e, backend=cfg.backend)
    if check:
        validate_sigma(sig)
    return sig
