"""Public model API, after the reference's ``models/zoo.py``: ``Model``
builds a ported architecture from its ``ModelConfig`` as an ``nn.Module``.

Its parameters are ``nn.Parameter``s (no gradient: inference only) whose
``state_dict()`` keys are the reference's parameter-tree paths joined by
".", e.g. ``layers.attn.wq`` of shape (L, d, nh*hd) and ``embed`` of shape
(padded_vocab, d); ``params`` gives the same tensors as the nested dict the
functional code takes.  The module lives on one explicit device, the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn as tnn

from repro_torch.kernels.ops import check_device
from repro_torch.models import modules as nn
from repro_torch.models import transformer as tf

__all__ = ["Model", "build"]


class _Tree(tnn.Module):
    """Registers a nested dict of ParamSpecs as parameters and submodules,
    uninitialized (``Model.init_params`` or ``convert`` fills them)."""

    def __init__(self, specs: dict, device: torch.device):
        super().__init__()
        for key in sorted(specs):
            spec = specs[key]
            if isinstance(spec, nn.ParamSpec):
                self.register_parameter(key, tnn.Parameter(
                    torch.empty(spec.shape, dtype=spec.dtype, device=device),
                    requires_grad=False))
            else:
                self.add_module(key, _Tree(spec, device))

    def tree(self) -> dict:
        out = dict(self.named_parameters(recurse=False))
        out.update({k: m.tree() for k, m in self.named_children()})
        return out


class Model(_Tree):
    """One dense decoder: ``init_params``, ``forward``/``prefill`` (the
    full sequence; attention through the flash kernel on the card),
    ``init_caches`` and ``decode_step`` (one token per sequence against a
    KV cache)."""

    def __init__(self, cfg, device="cuda"):
        dev = check_device(device)
        super().__init__(tf.decoder_param_specs(cfg), dev)
        self.cfg = cfg
        self.device = dev

    # ---- parameters -------------------------------------------------------
    def param_specs(self) -> dict:
        return tf.decoder_param_specs(self.cfg)

    @property
    def params(self) -> dict:
        return self.tree()

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` (on this model's device)
        by the reference's rules (``ParamSpec.std``), in sorted-path
        order."""
        state = self.state_dict(keep_vars=True)
        for path, spec in nn.spec_items(self.param_specs()):
            spec.materialize(generator, self.device, out=state[path].data)
        return self

    @torch.no_grad()
    def to_dtype(self, dtype: torch.dtype) -> "Model":
        """Every parameter cast to ``dtype`` in place, one at a time (the
        peak is the model and its largest parameter), and the config's dtype
        with them."""
        self.to(dtype)
        self.cfg = dataclasses.replace(
            self.cfg, dtype=str(dtype).removeprefix("torch."))
        return self

    # ---- serving ----------------------------------------------------------
    def _batch(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor | None]:
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        images = batch.get("images")
        if images is not None:
            images = torch.as_tensor(images, device=self.device)
        return tokens, images

    @torch.no_grad()
    def forward(self, batch: dict, *, backend: str = "auto"):
        """batch {"tokens": (b, s)[, "images": (b, n_img, d)]} ->
        (logits (b, s, padded_vocab) fp32, aux).  ``backend`` picks the
        attention op's backend ("auto": by the device)."""
        cfg = self.cfg
        tokens, images = self._batch(batch)
        logits, aux = tf.decoder_forward(self.params, cfg, tokens,
                                         extra_embeds=images, backend=backend)
        if cfg.n_img_tokens and images is not None:
            logits = logits[:, cfg.n_img_tokens:]
        return logits, aux

    def prefill(self, batch: dict, *, backend: str = "auto") -> torch.Tensor:
        """Full-sequence forward for serving (logits over the prompt)."""
        return self.forward(batch, backend=backend)[0]

    def init_caches(self, batch: int, max_seq: int) -> dict:
        return tf.init_caches(self.cfg, batch, max_seq, self.cfg.param_dtype,
                              self.device)

    @torch.no_grad()
    def decode_step(self, token, caches: dict, pos):
        """token (b, 1), pos a scalar or (b,) -> (logits (b, 1,
        padded_vocab) fp32, caches), the caches updated in place."""
        token = torch.as_tensor(token, device=self.device)
        return tf.decoder_decode_step(self.params, self.cfg, token, caches,
                                      pos)


def build(cfg, device="cuda") -> Model:
    return Model(cfg, device=device)
