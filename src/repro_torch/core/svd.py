"""The three-stage SVD pipeline, batch-native:

  dense --stage 1--> banded --stage 2 (bulge chasing)--> bidiagonal
        --stage 3 (Sturm bisection or divide and conquer)--> singular values
        [+ U, V^T by reflector-tape replay and inverse iteration]

``banded_singular_values`` enters at stage 2 (the paper's own use case);
``singular_values`` / ``batched_singular_values`` run all three stages on a
dense (..., n, n) input; ``svd`` / ``banded_svd`` / ``svd_batched(...,
compute_uv=True)`` return ``(U, sigma, V^T)``.  For those, stages 1 and 2
record their reflectors (``tape=True``), ``core/transforms.py`` replays them
into U and V^T, and stage 3 adds the bidiagonal's vectors; sigma comes from
the same band arithmetic and the same stage-3 call as the values path, so
it is bit-identical to it.  ``config.stage3`` picks that call: Sturm
bisection (``core/bidiag_svd.py``) or divide and conquer
(``core/bidiag_dc.py``), "auto" by n through ``stage3_for``.

A config with ``backend="fused_small"`` sends every entry point through
``_fused_path`` in place of the staged pipeline: the one-launch small-n
tier (``ops.fused_svd``), whose in-kernel stage 1 is an exact no-op on a
banded input.  Its values mode solves stage 3 by the kernel's own
bisection whatever ``config.stage3`` says; its uv mode by the config's
solver.  So under ``stage3="dc"`` (or "auto" at a dc n) the fused tier's
sigma from ``svd`` is divide and conquer's and agrees with
``singular_values``' to rounding only; under "bisect" it is bit-identical.

Every entry point runs on the card unless the caller asks for the CPU: the
config's ``device`` is "cuda" by default, a missing card raises
``RuntimeError``, and ``device="cpu"`` runs the plain PyTorch versions.
Leading axes are a batch that runs on one wavefront.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import bidiag_dc as s3dc
from repro_torch.core import bidiag_svd as s3
from repro_torch.core import bulge_chasing as bc
from repro_torch.core import stage1 as s1
from repro_torch.core import transforms
from repro_torch.core import tuning
from repro_torch.core.householder import acc_dtype
from repro_torch.kernels import ops

__all__ = ["NumericalFault", "validate_sigma", "validate_uv",
           "spot_check_svd", "bidiagonal_of", "banded_singular_values",
           "singular_values", "batched_singular_values", "svd_batched",
           "svd", "banded_svd"]


class NumericalFault(ArithmeticError):
    """A result failed post-solve validation: non-finite, negative or
    unsorted sigma, non-finite vectors, or a residual too large."""


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


def validate_uv(u, vt, *, name: str = "uv") -> None:
    """Every entry of U and V^T finite; raises :class:`NumericalFault`
    otherwise."""
    for tag, m in (("U", u), ("V^T", vt)):
        if m is not None and not bool(torch.isfinite(torch.as_tensor(m)).all()):
            raise NumericalFault(f"{name}: non-finite entries in {tag}")


def spot_check_svd(a, u, sig, vt, *, rtol: float | None = None) -> None:
    """``||A - U diag(s) V^T||_F / ||A||_F`` of the FIRST matrix of a
    (possibly batched) full-SVD result, in the accumulation type on U's
    device; raises :class:`NumericalFault` above ``rtol`` (default
    ``50 * n * eps`` of the working type)."""
    u = torch.as_tensor(u)
    n = u.shape[-1]
    acc = acc_dtype(u.dtype)

    def first(x, tail):
        x = torch.as_tensor(x).to(u.device)
        return x.reshape((-1,) + x.shape[-tail:])[0].to(acc)

    a0, u0, s0, vt0 = first(a, 2), first(u, 2), first(sig, 1), first(vt, 2)
    if rtol is None:
        rtol = 50.0 * n * torch.finfo(u.dtype).eps
    denom = max(float(torch.linalg.norm(a0)), torch.finfo(acc).tiny)
    resid = float(torch.linalg.norm(a0 - (u0 * s0) @ vt0)) / denom
    if not math.isfinite(resid) or resid > rtol:
        raise NumericalFault(
            f"residual spot-check failed: ||A - USV^T||/||A|| = {resid:.3e} "
            f"> {rtol:.1e} (n={n})")


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
    ops.resolve_backend(config.backend, config.device)
    return config


def _on_device(a: torch.Tensor, device: str) -> torch.Tensor:
    return a.to(ops.check_device(device))


def _stage3_values(d: torch.Tensor, e: torch.Tensor,
                   cfg: tuning.PipelineConfig) -> torch.Tensor:
    """Stage 3, values: the config's solver for this n
    (``cfg.stage3_for``), Sturm bisection or divide and conquer."""
    if cfg.stage3_for(d.shape[-1]) == "dc":
        return s3dc.bidiag_dc_singular_values(d, e, leaf_n=cfg.dc_leaf_n,
                                              backend=cfg.backend)
    return s3.bidiag_singular_values(d, e, backend=cfg.backend)


def _stage3_svd(d: torch.Tensor, e: torch.Tensor,
                cfg: tuning.PipelineConfig):
    """Stage 3 with vectors: sigma from the config's solver, (U, V^T) from
    the same inverse iteration whichever solver gave sigma."""
    if cfg.stage3_for(d.shape[-1]) == "dc":
        return s3dc.bidiag_dc_svd(d, e, leaf_n=cfg.dc_leaf_n,
                                  backend=cfg.backend)
    return s3.bidiag_svd(d, e, backend=cfg.backend)


def _fused_path(a: torch.Tensor, cfg: tuning.PipelineConfig, *,
                compute_uv: bool):
    """The one-launch small-n tier, for any entry point whose config says
    ``backend="fused_small"``.

    Values mode is one ``ops.fused_svd`` call.  uv mode is the fused
    reduction to (d, e, U2, V2^T), then stage 3 on the bidiagonal:
    A = U2 B V2^T and B = Ub S Vb^T, so U = U2 Ub and V^T = Vb^T V2^T."""
    lead, n = a.shape[:-2], a.shape[-1]
    mats = a.reshape((-1, n, n)).contiguous()
    if not compute_uv:
        sig = ops.fused_svd(mats, bw=cfg.bw, compute_uv=False, config=cfg)
        return sig.reshape(lead + (n,))
    d, e, u2, vt2 = ops.fused_svd(mats, bw=cfg.bw, compute_uv=True,
                                  config=cfg)
    ub, sig, vtb = _stage3_svd(d, e, cfg)
    return ((u2 @ ub).reshape(lead + (n, n)), sig.reshape(lead + (n,)),
            (vtb @ vt2).reshape(lead + (n, n)))


def _solve(a: torch.Tensor, cfg: tuning.PipelineConfig, *, banded: bool,
           compute_uv: bool):
    """sigma, or (U, sigma, V^T), of a dense or (``banded``) upper-banded
    input through the fused tier or the staged pipeline, as the config
    says: the one place every entry point routes."""
    if cfg.backend == "fused_small":
        return _fused_path(a, cfg, compute_uv=compute_uv)
    if compute_uv:
        return _uv_pipeline(a, cfg, banded=banded)
    if not banded:
        a = s1.band_reduce(a, nb=cfg.bw, config=cfg)
    d, e = bc.bidiagonalize(a, bw=cfg.bw, tw=cfg.tw, config=cfg)
    return _stage3_values(d, e, cfg)


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
    sig = _solve(_on_device(a, cfg.device), cfg, banded=True,
                 compute_uv=False)
    if check:
        validate_sigma(sig)
    return sig


def singular_values(a, *, bw: int | None = None, tw: int | None = None,
                    config: tuning.PipelineConfig | None = None,
                    device: str | None = None,
                    check: bool = False) -> torch.Tensor:
    """Singular values of dense (..., n, n), descending: stage 1 to band
    ``bw`` (32 when neither it nor ``config`` is given), then stages 2 and
    3.  ``check=True`` runs :func:`validate_sigma` on the result."""
    a = _as_tensor(a)
    cfg = _config(a, bw=bw, tw=tw, config=config, device=device)
    sig = _solve(_on_device(a, cfg.device), cfg, banded=False,
                 compute_uv=False)
    if check:
        validate_sigma(sig)
    return sig


def batched_singular_values(mats, *, bw: int | None = None,
                            tw: int | None = None,
                            config: tuning.PipelineConfig | None = None,
                            device: str | None = None,
                            check: bool = False) -> torch.Tensor:
    """(B, n, n) -> (B, n), descending: the B chases share one wavefront,
    one kernel launch over all B*G windows per cycle."""
    mats = _as_tensor(mats)
    if mats.dim() != 3:
        raise ValueError(f"expected stacked (B, n, n), got "
                         f"{tuple(mats.shape)}")
    return singular_values(mats, bw=bw, tw=tw, config=config, device=device,
                           check=check)


def svd_batched(mats, config: tuning.PipelineConfig | None = None, *,
                compute_uv: bool | None = None, check: bool = False,
                **overrides):
    """Config-first batched entry point: ``svd_batched(stacked, cfg)``.

    ``overrides`` are ``bw=``, ``tw=`` and ``device=`` (a conflict with the
    config raises).  ``compute_uv=True`` (or, when it is None, a config with
    ``compute_uv=True``) returns ``(U, sigma, V^T)`` in place of sigma
    alone; sigma is bit-identical between the two.  This is the one entry
    point that reads ``config.compute_uv``: ``svd`` and ``banded_svd``
    return the vectors by name, as in the reference."""
    if compute_uv is None:
        compute_uv = config.compute_uv if config is not None else False
    if not compute_uv:
        return batched_singular_values(mats, config=config, check=check,
                                       **overrides)
    mats = _as_tensor(mats)
    if mats.dim() != 3:
        raise ValueError(f"expected stacked (B, n, n), got "
                         f"{tuple(mats.shape)}")
    return svd(mats, config=config, check=check, **overrides)


def _uv_pipeline(a: torch.Tensor, cfg: tuning.PipelineConfig, *,
                 banded: bool):
    """(U, sigma, V^T) with ``A = U diag(sigma) V^T``.

    The band arithmetic of stages 1 and 2 is the values path's own (the
    tapes are recorded beside it, never read by it), so (d, e), and sigma
    from the same stage-3 call, are bit-identical to it.  The tapes are
    replayed into transposed accumulators through ``ops.tape_apply``, and
    stage 3's bidiagonal vectors are composed on top: A = U2 B V2^T and
    B = Ub S Vb^T, so U = U2 Ub and V^T = Vb^T V2^T."""
    n = a.shape[-1]
    s1_tape = None
    band_in = a
    if not banded:
        band_in, s1_tape = s1.band_reduce(a, nb=cfg.bw, config=cfg, tape=True)
    d, e, tapes = bc.bidiagonalize(band_in, bw=cfg.bw, tw=cfg.tw, config=cfg,
                                   tape=True)
    u2, vt2 = transforms.accumulate_transforms(
        n, s1_tape=s1_tape, chase_tapes=tapes, lead=a.shape[:-2],
        dtype=a.dtype, config=cfg, device=a.device)
    ub, sig, vtb = _stage3_svd(d, e, cfg)
    return u2 @ ub, sig, vtb @ vt2


def _checked_uv(a, out, *, check: bool):
    """Post-solve guard of a full-SVD result: sigma's invariants, finite
    U and V^T, and the residual of the first matrix."""
    if check:
        u, sig, vt = out
        validate_sigma(sig)
        validate_uv(u, vt)
        spot_check_svd(a, u, sig, vt)
    return out


def svd(a, *, bw: int | None = None, tw: int | None = None,
        config: tuning.PipelineConfig | None = None,
        device: str | None = None, compute_uv: bool = True,
        check: bool = False):
    """Full SVD of dense (..., n, n): ``(U, sigma, V^T)``, sigma
    descending, on ``config.device``.

    ``compute_uv=False`` is :func:`singular_values`; sigma is bit-identical
    either way.  A batch runs batch-native end to end, the replay included
    (one ``tape_apply`` over all B*G*K slots per super-cycle).
    ``check=True`` validates sigma, checks U and V^T for non-finite entries
    and checks the residual of the first matrix (:class:`NumericalFault`).
    ``config.compute_uv`` is not read here (see :func:`svd_batched`)."""
    a = _as_tensor(a)
    cfg = _config(a, bw=bw, tw=tw, config=config, device=device)
    if not compute_uv:
        return singular_values(a, config=cfg, check=check)
    a = _on_device(a, cfg.device)
    return _checked_uv(a, _solve(a, cfg, banded=False, compute_uv=True),
                       check=check)


def banded_svd(a, *, bw: int | None = None, tw: int | None = None,
               config: tuning.PipelineConfig | None = None,
               device: str | None = None, compute_uv: bool = True,
               check: bool = False):
    """Full SVD of upper-banded (..., n, n) (stages 2 and 3 only);
    arguments as in :func:`svd`."""
    a = _as_tensor(a)
    cfg = _config(a, bw=bw, tw=tw, config=config, device=device)
    if not compute_uv:
        return banded_singular_values(a, config=cfg, check=check)
    a = _on_device(a, cfg.device)
    return _checked_uv(a, _solve(a, cfg, banded=True, compute_uv=True),
                       check=check)
