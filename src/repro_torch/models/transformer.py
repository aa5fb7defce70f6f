"""Decoder-only LM assembly, after the reference's ``models/transformer.py``:
stacked layer parameters (a leading (L,) axis), four block kinds (dense,
moe, hymba, rwkv), and the full-sequence (prefill) and one-token (decode)
paths.

The reference scans over the stacked axis; here a Python loop walks it
(``scan_layers``), one layer's views at a time.  Under autograd with
``cfg.remat == "full"`` each layer is one ``torch.utils.checkpoint``
segment, as the reference's ``jax.checkpoint`` of its scan body: only the
layer inputs are kept, and the backward runs each layer's forward again.
Decode updates every cache in place through ``layer_slice`` views: the KV
rows and the recurrent states (rwkv's ``x_tm``, ``x_cm``, ``state``;
hymba's ``mamba.conv``, ``mamba.state``).  ``lm_loss`` is the reference's
next-token cross entropy.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import modules as nn
from repro_torch.models import moe as moemod
from repro_torch.models import rwkv as rwkvmod
from repro_torch.models import ssm as ssmmod
from repro_torch.models.modules import param

__all__ = ["decoder_param_specs", "stack_layer_specs", "decoder_forward",
           "decoder_decode_step", "lm_loss", "init_caches", "reset_slot",
           "scan_layers"]


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
        return param((n_layers,) + tree.shape, tree.dtype,
                     (None,) + tree.logical, init=tree.init, scale=tree.scale)
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
        specs["lm_head"] = param((d, cfg.padded_vocab), dtype,
                                 (None, "vocab"))
    return specs


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked tree: the same dict with each leaf's view
    ``leaf[i]``."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: layer_slice(v, i) for k, v in tree.items()}


def _unstack(tree, n: int):
    """The n layers of a stacked tree, each leaf split by one ``unbind``:
    under autograd a stacked leaf then gets one backward node that stacks
    its n slices' gradients, where n ``leaf[i]`` views would each write a
    gradient of the whole stacked shape."""
    if isinstance(tree, torch.Tensor):
        return tree.unbind(0)
    parts = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: part[i] for k, part in parts.items()} for i in range(n)]


def scan_layers(body, x, layers, n: int, aux: dict, *, remat: bool):
    """x through ``body(x, layer_params) -> (x, layer aux or None)`` for
    each of the n stacked layers, each layer's aux added to ``aux``.  With
    ``remat`` and grad enabled each layer is one non-reentrant
    ``torch.utils.checkpoint`` segment (the blocks draw no random numbers,
    so no RNG state is kept).  Returns (x, aux)."""
    ckpt = remat and torch.is_grad_enabled()
    for lp in _unstack(layers, n):
        if ckpt:
            x, layer_aux = checkpoint(body, x, lp, use_reentrant=False,
                                      preserve_rng_state=False)
        else:
            x, layer_aux = body(x, lp)
        if layer_aux is not None:
            aux = {k: aux[k] + layer_aux[k] for k in aux}
    return x, aux


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
    (zero but for moe blocks).  Keeps the autograd graph where grad is
    enabled; ``cfg.remat == "full"`` then checkpoints each layer."""
    x = _embed_in(params, cfg, tokens, extra_embeds)
    x, aux = scan_layers(
        lambda h, lp: _block(h, lp, cfg, backend=backend), x,
        params["layers"], cfg.n_layers, _zero_aux(x.device),
        remat=cfg.remat == "full")
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


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def lm_loss(logits, labels, mask=None, aux=None):
    """Next-token cross entropy (labels already shifted by the data
    pipeline): the fp32 log-sum-exp of each row less its gold logit, the
    mean over ``mask``; each aux term is added to the loss and reported.
    Returns (loss, metrics {"ce", aux terms..., "loss"})."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        mask = torch.ones_like(nll)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    metrics = {"ce": loss}
    if aux:
        for k, v in aux.items():
            loss = loss + v
            metrics[k] = v
    metrics["loss"] = loss
    return loss, metrics
