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


def train_state_from_reference(state_np: dict, cfg, device="cuda"):
    """(model, state) of this package from the reference's training state
    ``{"params", "opt": {"step", "m", "v"}}`` flattened to numpy as the
    reference's checkpoints flatten it: ``{key path joined by "|": array}``
    (``params|layers|attn|wq``, ``opt|m|...``, ``opt|step``).

    The model of ``cfg`` holds the parameters, made trainable; the state is
    ``{"params": model.params, "opt": {"step": int32, "m": ..., "v": ...}}``
    with m and v in fp32, as ``train.Trainer.init_state`` makes it.  A
    missing or extra key or a shape mismatch raises ``ValueError``."""
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.tree import items

    def part(prefix):
        return {k[len(prefix):].replace("|", "."): v
                for k, v in state_np.items() if k.startswith(prefix)}

    model = model_params_from_reference(part("params|"), cfg, device=device)
    model.requires_grad_(True)
    params = model.params
    state = {"params": params, "opt": adamw_init(params)}
    want = {"|".join(("opt",) + path) for path, _ in items(state["opt"])}
    got = {k for k in state_np if k.startswith("opt|")}
    if want != got:
        raise ValueError(f"optimizer keys differ: missing "
                         f"{sorted(want - got)}, extra {sorted(got - want)}")
    with torch.no_grad():
        for path, leaf in items(state["opt"]):
            arr = np.asarray(state_np["|".join(("opt",) + path)])
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"opt|{'|'.join(path)}: shape {arr.shape}, "
                                 f"expected {tuple(leaf.shape)}")
            leaf.copy_(torch.from_numpy(np.array(arr)).to(leaf.dtype))
    return model, state
