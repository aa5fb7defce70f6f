"""Decoder-only LM assembly, after the reference's ``models/transformer.py``:
stacked layer parameters (a leading (L,) axis), four block kinds (dense,
moe, hymba, rwkv), and the full-sequence (prefill) and one-token (decode)
paths.

The reference scans over the stacked axis; here a Python loop walks it, one
layer's slices at a time, with no rematerialization (inference only).
Decode updates every cache in place through ``layer_slice`` views: the KV
rows and the recurrent states (rwkv's ``x_tm``, ``x_cm``, ``state``;
hymba's ``mamba.conv``, ``mamba.state``).  The training loss is a later
slice.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import modules as nn
from repro_torch.models import moe as moemod
from repro_torch.models import rwkv as rwkvmod
from repro_torch.models import ssm as ssmmod
from repro_torch.models.modules import param

__all__ = ["decoder_param_specs", "stack_layer_specs", "decoder_forward",
           "decoder_decode_step", "init_caches", "reset_slot"]


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _layer_specs(cfg, dtype) -> dict:
    d = cfg.d_model
    if cfg.kind == "rwkv":
        p = rwkvmod.rwkv_params(cfg, dtype)
        p["ln1"] = nn.rmsnorm_p(d, dtype)
        p["ln2"] = nn.rmsnorm_p(d, dtype)
        return p
    p = {
        "ln1": nn.rmsnorm_p(d, dtype),
        "ln2": nn.rmsnorm_p(d, dtype),
        "attn": attn.attn_params(cfg, dtype),
    }
    if cfg.kind == "moe":
        p["moe"] = moemod.moe_params(cfg, dtype)
    else:
        p["mlp"] = nn.swiglu_p(d, cfg.d_ff, dtype)
    if cfg.kind == "hymba":
        p["mamba"] = ssmmod.mamba_params(cfg, dtype)
    return p


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
    """Full-sequence block.  Returns (x, aux losses): zero but for moe."""
    if cfg.kind == "rwkv":
        x = x + rwkvmod.rwkv_time_mix(nn.rmsnorm(x, p["ln1"], cfg.norm_eps),
                                      p["tm"], cfg)
        x = x + rwkvmod.rwkv_channel_mix(nn.rmsnorm(x, p["ln2"], cfg.norm_eps),
                                         p["cm"], cfg)
        return x, None
    h = nn.rmsnorm(x, p["ln1"], cfg.norm_eps)
    a = attn.attention(h, p["attn"], cfg, backend=backend)
    if cfg.kind == "hymba":                 # parallel heads on the same h
        a = a + ssmmod.mamba(h, p["mamba"], cfg)
    x = x + a
    h = nn.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.kind == "moe":
        m, aux = moemod.moe_ffn(h, p["moe"], cfg)
        return x + m, aux
    return x + nn.swiglu(h, p["mlp"]), None


def _block_decode(x, p, cfg, cache, pos):
    """Single-token block.  cache: this layer's slice, updated in place.
    Returns (x, cache)."""
    if cfg.kind == "rwkv":
        h = nn.rmsnorm(x, p["ln1"], cfg.norm_eps)
        o, x_tm, state = rwkvmod.rwkv_time_mix_decode(
            h, p["tm"], cfg, cache["x_tm"], cache["state"])
        x = x + o
        h = nn.rmsnorm(x, p["ln2"], cfg.norm_eps)
        o, x_cm = rwkvmod.rwkv_channel_mix_decode(h, p["cm"], cfg,
                                                  cache["x_cm"])
        for key, new in (("x_tm", x_tm), ("x_cm", x_cm), ("state", state)):
            cache[key].copy_(new)
        return x + o, cache
    h = nn.rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, _ = attn.attention_decode(h, p["attn"], cfg, cache["kv"], pos)
    if cfg.kind == "hymba":
        o, new = ssmmod.mamba_decode(h, p["mamba"], cfg, cache["mamba"])
        for key in ("conv", "state"):
            cache["mamba"][key].copy_(new[key])
        a = a + o
    x = x + a
    h = nn.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.kind == "moe":
        m, _ = moemod.moe_ffn(h, p["moe"], cfg)
    else:
        m = nn.swiglu(h, p["mlp"])
    return x + m, cache


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
    holds the reference's auxiliary losses, each summed over the layers
    (zero but for moe blocks)."""
    x = _embed_in(params, cfg, tokens, extra_embeds)
    aux = _zero_aux(x.device)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        x, layer_aux = _block(x, layer_slice(layers, i), cfg, backend=backend)
        if layer_aux is not None:
            aux = {k: aux[k] + layer_aux[k] for k in aux}
    x = nn.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits_out(x, params, cfg), aux


def init_caches(cfg, batch: int, max_seq: int, dtype, device) -> dict:
    if cfg.kind == "rwkv":
        return rwkvmod.init_rwkv_cache(cfg, batch, dtype, device)
    cache = {"kv": attn.init_kv_cache(cfg, batch, max_seq, dtype, device)}
    if cfg.kind == "hymba":
        cache["mamba"] = ssmmod.init_mamba_cache(cfg, batch, dtype, device)
    return cache


def reset_slot(cfg, caches: dict, slot: int) -> None:
    """Zero batch row ``slot`` of every recurrent state in ``caches`` (rwkv's
    token shifts and state, hymba's conv window and SSM state), so that a
    sequence started there does not carry on from the last one.  KV rows
    need no reset: decode masks them by position."""
    if cfg.kind == "rwkv":
        recurrent = caches
    elif cfg.kind == "hymba":
        recurrent = caches["mamba"]
    else:
        return
    for leaf in recurrent.values():
        leaf[:, slot].zero_()


def decoder_decode_step(params, cfg, token, caches, pos):
    """token: (b, 1) -> (logits (b, 1, padded_vocab) fp32, caches).
    ``caches`` carry a leading layer axis and are updated in place; the same
    dict is returned."""
    x = _embed_in(params, cfg, token)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        x, _ = _block_decode(x, layer_slice(layers, i), cfg,
                             layer_slice(caches, i), pos)
    x = nn.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits_out(x, params, cfg), caches
