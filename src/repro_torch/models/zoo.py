"""Public model API, after the reference's ``models/zoo.py``: ``Model``
builds any of the reference's architectures from its ``ModelConfig`` as an
``nn.Module``: a decoder (dense, moe, hymba, rwkv blocks) or the
encoder-decoder (whisper), by ``cfg.kind``.

Its parameters are ``nn.Parameter``s, made without gradient (serving);
``requires_grad_(True)`` (``train.Trainer.init_state``) makes them
trainable, and ``loss_fn`` then keeps the graph.  Their ``state_dict()``
keys are the reference's parameter-tree paths joined by
".", e.g. ``layers.attn.wq`` of shape (L, d, nh*hd) and ``embed`` of shape
(padded_vocab, d); ``params`` gives the same tensors as the nested dict the
functional code takes.  The leaves the reference keeps in fp32 at every
model dtype (the moe router; mamba's ``dt_bias``, ``a_log``, ``d_skip``;
rwkv's ``w0``, ``u``) stay fp32 here too, through ``init_params`` and
``to_dtype``.  The module lives on one explicit device, the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn as tnn

from repro_torch.kernels.ops import check_device
from repro_torch.models import encdec as ed
from repro_torch.models import modules as nn
from repro_torch.models import transformer as tf

__all__ = ["Model", "build", "batch_logical"]


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


def _param_specs(cfg) -> dict:
    if cfg.kind == "encdec":
        return ed.encdec_param_specs(cfg)
    return tf.decoder_param_specs(cfg)


class Model(_Tree):
    """One model: ``init_params``, ``forward``/``loss_fn`` (training: the
    full sequence with its graph kept where grad is enabled, causal
    self-attention through the flash kernel and its backward on the card),
    ``prefill`` (the same forward for serving, without a graph),
    ``init_caches`` and ``decode_step`` (one token per sequence against the
    caches: KV rows, recurrent states, whisper's cross KV),
    ``fill_cross_cache`` (whisper: the encoder's output into the cross KV
    of some batch rows) and ``admit`` (batch rows readied for new
    sequences)."""

    def __init__(self, cfg, device="cuda"):
        dev = check_device(device)
        super().__init__(_param_specs(cfg), dev)
        self.cfg = cfg
        self.device = dev

    # ---- parameters -------------------------------------------------------
    def param_specs(self) -> dict:
        return _param_specs(self.cfg)

    def param_logical(self) -> dict:
        """Each parameter's logical sharding axes (``parallel.sharding``)."""
        return nn.logical_tree(self.param_specs())

    def param_shapes(self) -> dict:
        return nn.shape_tree(self.param_specs())

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
        """Every parameter cast to the dtype its spec has at model dtype
        ``dtype`` (``dtype``, or fp32 for the leaves kept in fp32), one at a
        time (the peak is the model and its largest parameter), and the
        config's dtype with them."""
        cfg = dataclasses.replace(self.cfg,
                                  dtype=str(dtype).removeprefix("torch."))
        state = self.state_dict(keep_vars=True)
        for path, spec in nn.spec_items(_param_specs(cfg)):
            p = state[path]
            p.data = p.data.to(spec.dtype)
        self.cfg = cfg
        return self

    # ---- serving ----------------------------------------------------------
    def _batch(self, batch: dict) -> dict:
        """The batch's tensors on this model's device: "tokens" and, where
        given, "images" and "frames"."""
        return {k: torch.as_tensor(batch[k], device=self.device)
                for k in ("tokens", "images", "frames")
                if batch.get(k) is not None}

    def forward(self, batch: dict, *, backend: str = "auto"):
        """batch {"tokens": (b, s)[, "images": (b, n_img, d)][, "frames":
        (b, enc_seq, d)]} -> (logits (b, s, padded_vocab) fp32, aux).
        ``backend`` picks the attention op's backend ("auto": by the
        device).  The graph is kept where grad is enabled and a parameter
        requires it."""
        cfg = self.cfg
        bt = self._batch(batch)
        if cfg.kind == "encdec":
            return ed.encdec_forward(self.params, cfg, bt["tokens"],
                                     bt["frames"], backend=backend)
        images = bt.get("images")
        logits, aux = tf.decoder_forward(self.params, cfg, bt["tokens"],
                                         extra_embeds=images, backend=backend)
        if cfg.n_img_tokens and images is not None:
            logits = logits[:, cfg.n_img_tokens:]
        return logits, aux

    def loss_fn(self, batch: dict, *, backend: str = "auto"):
        """(loss, metrics) of the reference's ``Model.loss_fn``: ``forward``
        and ``transformer.lm_loss`` against batch["labels"] (b, s) and,
        where given, batch["mask"] (b, s); pixtral's logits are taken past
        its image tokens, as ``forward`` gives them."""
        logits, aux = self.forward(batch, backend=backend)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        mask = batch.get("mask")
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)
        return tf.lm_loss(logits, labels, mask, aux)

    @torch.no_grad()
    def prefill(self, batch: dict, *, backend: str = "auto") -> torch.Tensor:
        """Full-sequence forward for serving (logits over the prompt)."""
        return self.forward(batch, backend=backend)[0]

    def init_caches(self, batch: int, max_seq: int) -> dict:
        cfg = self.cfg
        init = (ed.init_encdec_caches if cfg.kind == "encdec"
                else tf.init_caches)
        return init(cfg, batch, max_seq, cfg.param_dtype, self.device)

    @torch.no_grad()
    def fill_cross_cache(self, frames, caches: dict, slots=None) -> dict:
        """Encoder-decoder only: encode ``frames`` and write the cross KV of
        batch rows ``slots`` (all rows when None) in place."""
        frames = torch.as_tensor(frames, device=self.device)
        return ed.fill_cross_cache(self.params, self.cfg, frames, caches,
                                   slots)

    @torch.no_grad()
    def admit(self, caches: dict, slots: list[int], frames=None) -> None:
        """Ready batch rows ``slots`` of ``caches`` for new sequences, in
        place: zero their recurrent state (rwkv's token shifts and state,
        hymba's conv window and SSM state) and, for the encoder-decoder,
        encode ``frames`` (one (enc_seq, d) array per slot, or None for
        zeros) into their cross KV.  KV rows need no reset: decode masks
        them by position."""
        cfg = self.cfg
        for i in slots:
            tf.reset_slot(cfg, caches, i)
        if cfg.kind != "encdec" or not slots:
            return
        x = torch.zeros((len(slots), cfg.enc_seq, cfg.d_model),
                        dtype=torch.float32)
        for row, f in enumerate(frames or ()):
            if f is not None:
                x[row] = torch.as_tensor(f)
        self.fill_cross_cache(x, caches, slots=list(slots))

    @torch.no_grad()
    def decode_step(self, token, caches: dict, pos):
        """token (b, 1), pos a scalar or (b,) -> (logits (b, 1,
        padded_vocab) fp32, caches), the caches updated in place."""
        token = torch.as_tensor(token, device=self.device)
        step = (ed.encdec_decode_step if self.cfg.kind == "encdec"
                else tf.decoder_decode_step)
        return step(self.params, self.cfg, token, caches, pos)


def build(cfg, device="cuda") -> Model:
    return Model(cfg, device=device)


def batch_logical(cfg, suite) -> dict:
    """Logical sharding of each batch input of a shape suite (the batch
    axis over the data-parallel ranks)."""
    if suite.mode == "decode":
        return {"token": ("batch", None)}
    out = {"tokens": ("batch", None)}
    if suite.mode == "train":
        out["labels"] = ("batch", None)
        out["mask"] = ("batch", None)
    if cfg.kind == "encdec":
        out["frames"] = ("batch", None, None)
    if cfg.n_img_tokens:
        out["images"] = ("batch", None, None)
    return out
