"""Carry the reference package's state across into this one.

What it carries is the SVD pipeline's configuration and packed band
storage, an LM's parameter tree and a training state, as plain Python
values and numpy arrays, so this module needs nothing from the reference
package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tuning
from repro_torch.train.tree import get_path, items, unflatten

__all__ = ["pipeline_config_from_reference", "band_from_numpy",
           "model_params_from_reference", "train_state_from_reference"]

_BACKENDS = {"pallas": "cuda", "ref": "ref", "fused_small": "fused_small"}
_KEPT = ("bw", "tw", "fuse", "dtype", "compute_uv", "stage3", "dc_leaf_n",
         "dc_n_min", "max_batch")


def pipeline_config_from_reference(fields: dict, device: str = "cuda"
                                   ) -> tuning.PipelineConfig:
    """This package's config from ``dataclasses.asdict`` of a reference
    ``PipelineConfig``.

    "pallas" becomes "cuda"; "ref" and "fused_small" keep their names (the
    fused tier runs its kernel on the card and its plain version on the
    CPU); ``bw``, ``tw``, ``fuse``, ``dtype``, ``compute_uv``, ``stage3``,
    ``dc_leaf_n``, ``dc_n_min`` and ``max_batch`` (serving's bucket size)
    are kept.  ``interpret`` and ``unroll`` (the reference's loop
    unrolling) are dropped: nothing here reads them.
    A backend this package lacks raises ``NotImplementedError``."""
    backend = fields["backend"]
    if backend not in _BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} has no counterpart here")
    kept = {k: fields[k] for k in _KEPT if k in fields}
    cfg = tuning.PipelineConfig(backend=_BACKENDS[backend], device=str(device),
                                **kept)
    tuning.dtype_of(cfg.dtype)
    if cfg.stage3 not in tuning.STAGE3_CHOICES:
        raise ValueError(f"stage3 must be one of {tuning.STAGE3_CHOICES}, "
                         f"got {cfg.stage3!r}")
    from repro_torch.kernels import ops
    ops.resolve_backend(cfg.backend, cfg.device)
    return cfg


def band_from_numpy(arr, device="cuda") -> torch.Tensor:
    """The reference's packed band storage (..., H, ncols), given as a numpy
    array, as a tensor on ``device``."""
    return torch.tensor(np.asarray(arr), device=device)


def model_params_from_reference(params_np: dict, cfg, device="cuda"):
    """This package's ``Model`` of ``cfg`` (a ``repro_torch`` ModelConfig,
    any of the ten architectures: a decoder's ``layers``, or whisper's
    ``enc_layers`` and ``dec_layers``) holding the reference's parameters,
    each in the dtype of its parameter here (the leaves kept in fp32 stay
    fp32).

    ``params_np`` is the reference's parameter tree flattened to
    ``{path: numpy array}``, the path its keys joined by "." (e.g.
    ``"layers.attn.wq"``): exactly the model's ``state_dict()`` keys, so
    conversion is a lookup.  Arrays of a type numpy cannot hand to torch
    (bfloat16) go through float32.  A missing or extra path or a shape
    mismatch raises ``ValueError``."""
    from repro_torch.models.zoo import build
    model = build(cfg, device=device)
    state = model.state_dict(keep_vars=True)
    missing, extra = sorted(set(state) - set(params_np)), sorted(
        set(params_np) - set(state))
    if missing or extra:
        raise ValueError(f"parameter paths differ: missing {missing}, "
                         f"extra {extra}")
    for path, p in state.items():
        arr = np.asarray(params_np[path])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{path}: shape {arr.shape}, expected "
                             f"{tuple(p.shape)}")
        if arr.dtype.kind not in "fiub":
            arr = arr.astype(np.float32)
        p.data.copy_(torch.from_numpy(np.array(arr)))
    return model


def train_state_from_reference(state_np: dict, cfg, device="cuda",
                               shardings=None):
    """(model, state) of this package from the reference's training state
    ``{"params", "opt": {"step", "m", "v"}[, "comp"]}`` flattened to numpy
    as the reference's checkpoints flatten it: ``{key path joined by "|":
    array}`` (``params|layers|attn|wq``, ``opt|m|...``, ``opt|step``,
    ``comp|layers|attn|wq|q``).

    The model of ``cfg`` holds the parameters, made trainable; the state is
    ``{"params": model.params, "opt": {"step": int32, "m": ..., "v":
    ...}}`` with m and v in fp32, as ``train.Trainer.init_state`` makes it.
    Under a process mesh, ``shardings`` is the ``state_shardings()`` of
    the Trainer that will step the state: m and v (and PowerSGD's "comp"
    leaves, which the reference's compressed Trainer makes: each
    compressed leaf's "q" and its (n_workers, ...) "err") keep this rank's
    block of each global array, as ``checkpoint.restore`` does.  A PowerSGD
    state needs ``shardings`` with a "comp" part.  A missing or extra key
    or a shape mismatch raises ``ValueError``."""
    def part(prefix):
        return {k[len(prefix):].replace("|", "."): v
                for k, v in state_np.items() if k.startswith(prefix)}

    def take(sh, arr):
        return arr if sh is None else sh.take(arr)

    model = model_params_from_reference(part("params|"), cfg, device=device)
    model.requires_grad_(True)
    params = model.params
    compressed = any(k.startswith("comp|") for k in state_np)
    if compressed and (shardings is None or "comp" not in shardings):
        raise ValueError("a PowerSGD state (comp|...) needs shardings= with "
                         "a 'comp' part (Trainer(compression=...)"
                         ".state_shardings())")
    state = {"params": params, "opt": {
        "step": torch.zeros((), dtype=torch.int32, device=model.device),
        "m": {}, "v": {}}}
    want = {"opt|step"} | {"|".join(("opt", mv) + path)
                           for mv in ("m", "v") for path, _ in items(params)}
    got = {k for k in state_np if k.startswith("opt|")}
    if want != got:
        raise ValueError(f"optimizer keys differ: missing "
                         f"{sorted(want - got)}, extra {sorted(got - want)}")
    state["opt"]["step"].copy_(torch.as_tensor(np.array(
        state_np["opt|step"])))
    paths = [path for path, _ in items(params)]
    for mv in ("m", "v"):
        leaves = []
        for path, p in items(params):
            arr = np.asarray(state_np["|".join(("opt", mv) + path)])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"opt|{mv}|{'|'.join(path)}: shape "
                                 f"{arr.shape}, expected {tuple(p.shape)}")
            if shardings is not None:
                arr = take(get_path(shardings["opt"][mv], path), arr)
            leaves.append(torch.tensor(np.array(arr), dtype=torch.float32,
                                       device=model.device))
        state["opt"][mv] = unflatten(paths, leaves)
    if compressed:
        state["comp"] = _comp_from_reference(state_np, params,
                                             shardings["comp"])
    return model, state


def _comp_from_reference(state_np: dict, params: dict, comp_sh: dict) -> dict:
    """PowerSGD's state keyed as ``params``: {"q", "err": this rank's
    block (1, ...) of the reference's rows} where ``comp_sh`` (the
    Trainer's) compresses the leaf, else None."""
    paths, leaves = [], []
    used = set()
    for path, p in items(params):
        key = "|".join(("comp",) + path)
        sh = get_path(comp_sh, path)
        paths.append(path)
        if sh is None:
            leaves.append(None)
            continue
        if f"{key}|q" not in state_np:
            raise ValueError(f"{key}: no PowerSGD state for a leaf the "
                             f"Trainer compresses")
        used |= {f"{key}|q", f"{key}|err"}
        q = sh["q"].take(np.asarray(state_np[f"{key}|q"]))
        err = sh["err"].take(np.asarray(state_np[f"{key}|err"]))
        if err.shape[1:] != tuple(p.shape) or len(err) != 1:
            raise ValueError(f"{key}|err: shape {err.shape}, expected (1,) "
                             f"+ {tuple(p.shape)} on this rank")
        leaves.append({k: torch.tensor(np.array(v), dtype=torch.float32,
                                       device=p.device)
                       for k, v in (("q", q), ("err", err))})
    extra = {k for k in state_np if k.startswith("comp|")} - used
    if extra:
        raise ValueError(f"PowerSGD keys with no compressed leaf: "
                         f"{sorted(extra)}")
    return unflatten(paths, leaves)
