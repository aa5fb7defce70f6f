"""Decoder-only LM assembly, after the reference's ``models/transformer.py``:
stacked layer parameters (a leading (L,) axis), the dense block kind, and
the full-sequence (prefill) and one-token (decode) paths.

The reference scans over the stacked axis; here a Python loop walks it, one
layer's slices at a time, with no rematerialization (inference only).  The
other block kinds (moe, hymba, rwkv) and the training loss are later slices.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import LATER
from repro_torch.models import attention as attn
from repro_torch.models import modules as nn
from repro_torch.models.modules import param

__all__ = ["decoder_param_specs", "stack_layer_specs", "decoder_forward",
           "decoder_decode_step", "init_caches"]


def _dense_only(cfg) -> None:
    if cfg.kind != "dense":
        raise NotImplementedError(LATER.get(
            cfg.kind, f"block kind {cfg.kind!r} has no counterpart here"))


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _layer_specs(cfg, dtype) -> dict:
    _dense_only(cfg)
    d = cfg.d_model
    return {
        "ln1": nn.rmsnorm_p(d, dtype),
        "ln2": nn.rmsnorm_p(d, dtype),
        "attn": attn.attn_params(cfg, dtype),
        "mlp": nn.swiglu_p(d, cfg.d_ff, dtype),
    }


def _stack(tree, n_layers: int):
    if isinstance(tree, nn.ParamSpec):
        return param((n_layers,) + tree.shape, tree.dtype, init=tree.init,
                     scale=tree.scale)
    return {k: _stack(v, n_layers) for k, v in tree.items()}


def stack_layer_specs(cfg, dtype) -> dict:
    """Layer specs with a leading stacked (L,) axis."""
    return _stack(_layer_specs(cfg, dtype), cfg.n_layers)


def decoder_param_specs(cfg) -> dict:
    dtype = cfg.param_dtype
    d = cfg.d_model
    specs = {
        "embed": nn.embedding_p(cfg.padded_vocab, d, dtype),
        "layers": stack_layer_specs(cfg, dtype),
        "final_norm": nn.rmsnorm_p(d, dtype),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = param((d, cfg.padded_vocab), dtype)
    return specs


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked tree: the same dict with each leaf's view
    ``leaf[i]``."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: layer_slice(v, i) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# block bodies
# ---------------------------------------------------------------------------

def _block(x, p, cfg, backend="auto"):
    """Full-sequence dense block."""
    h = nn.rmsnorm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.attention(h, p["attn"], cfg, backend=backend)
    h = nn.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + nn.swiglu(h, p["mlp"])


def _block_decode(x, p, cfg, cache, pos):
    """Single-token dense block.  cache: this layer's slice, updated in
    place.  Returns (x, cache)."""
    h = nn.rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, kv = attn.attention_decode(h, p["attn"], cfg, cache["kv"], pos)
    x = x + a
    h = nn.rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + nn.swiglu(h, p["mlp"]), {"kv": kv}


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed_in(params, cfg, tokens, extra_embeds=None):
    x = params["embed"].to(cfg.param_dtype)[tokens]
    if extra_embeds is not None:                       # VLM stub: patch prefix
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def _logits_out(x, params, cfg):
    """Logits in fp32 over the padded vocab: the products of x.dtype values
    summed in fp32 (the reference's ``preferred_element_type``)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x.float(), head.float())
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _zero_aux(device) -> dict:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"aux_loss": z, "router_zloss": z.clone()}


def decoder_forward(params, cfg, tokens, *, extra_embeds=None,
                    backend: str = "auto"):
    """tokens: (b, s) -> (logits (b, s', padded_vocab) fp32, aux).  aux
    holds the reference's (zero, for dense blocks) auxiliary losses."""
    _dense_only(cfg)
    x = _embed_in(params, cfg, tokens, extra_embeds)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        x = _block(x, layer_slice(layers, i), cfg, backend=backend)
    x = nn.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits_out(x, params, cfg), _zero_aux(x.device)


def init_caches(cfg, batch: int, max_seq: int, dtype, device) -> dict:
    _dense_only(cfg)
    return {"kv": attn.init_kv_cache(cfg, batch, max_seq, dtype, device)}


def decoder_decode_step(params, cfg, token, caches, pos):
    """token: (b, 1) -> (logits (b, 1, padded_vocab) fp32, caches).
    ``caches`` carry a leading layer axis and are updated in place; the same
    dict is returned."""
    _dense_only(cfg)
    x = _embed_in(params, cfg, token)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        x, _ = _block_decode(x, layer_slice(layers, i), cfg,
                             layer_slice(caches, i), pos)
    x = nn.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits_out(x, params, cfg), caches
