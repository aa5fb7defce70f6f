"""Encoder-decoder assembly (the whisper-medium backbone), after the
reference's ``models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: the caller gives
precomputed frame embeddings (b, enc_seq, d).  Encoder: bidirectional
attention blocks with RoPE.  Decoder: causal self-attention (through the
flash-attention op, as every causal self-attention of the port), then
cross-attention to the encoder's output (dense softmax, no RoPE, no mask),
then a tanh-GELU MLP.  The encoder's and the cross attention stay plain
PyTorch: the reference computes both outside any Pallas kernel, and the
flash kernels are causal only.  Decode caches the self-attention KV and
each layer's cross KV (filled once per request by ``fill_cross_cache``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import modules as nn
from repro_torch.models.modules import param
from repro_torch.models.transformer import (_logits_out, _stack, _zero_aux,
                                            layer_slice, scan_layers)

__all__ = ["encdec_param_specs", "encode", "encdec_forward",
           "encdec_decode_step", "init_encdec_caches", "fill_cross_cache",
           "cross_kv"]


def _mlp_p(d, f, dtype):
    return {"wi": param((d, f), dtype, (None, "dff")),
            "bi": param((f,), dtype, ("dff",), init="zeros"),
            "wo": param((f, d), dtype, ("dff", None)),
            "bo": param((d,), dtype, (None,), init="zeros")}


def _mlp(x, p):
    # jax.nn.gelu's default is the tanh approximation
    return nn.dense(F.gelu(nn.dense(x, p["wi"], p["bi"]), approximate="tanh"),
                    p["wo"], p["bo"])


def _xattn_p(cfg, dtype):
    d, hd, nh, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv
    return {"wq": param((d, nh * hd), dtype, (None, "heads")),
            "wk": param((d, nkv * hd), dtype, (None, "kv_heads")),
            "wv": param((d, nkv * hd), dtype, (None, "kv_heads")),
            "wo": param((nh * hd, d), dtype, ("heads", None))}


def _enc_layer_p(cfg, dtype):
    d = cfg.d_model
    return {"ln1": nn.rmsnorm_p(d, dtype),
            "attn": attn.attn_params(cfg, dtype),
            "ln2": nn.rmsnorm_p(d, dtype), "mlp": _mlp_p(d, cfg.d_ff, dtype)}


def _dec_layer_p(cfg, dtype):
    d = cfg.d_model
    return {"ln1": nn.rmsnorm_p(d, dtype),
            "attn": attn.attn_params(cfg, dtype),
            "lnx": nn.rmsnorm_p(d, dtype), "xattn": _xattn_p(cfg, dtype),
            "ln2": nn.rmsnorm_p(d, dtype), "mlp": _mlp_p(d, cfg.d_ff, dtype)}


def encdec_param_specs(cfg) -> dict:
    dtype = cfg.param_dtype
    d = cfg.d_model
    return {
        "embed": nn.embedding_p(cfg.padded_vocab, d, dtype),
        "enc_layers": _stack(_enc_layer_p(cfg, dtype), cfg.n_enc_layers),
        "enc_norm": nn.rmsnorm_p(d, dtype),
        "dec_layers": _stack(_dec_layer_p(cfg, dtype), cfg.n_layers),
        "final_norm": nn.rmsnorm_p(d, dtype),
        "lm_head": param((d, cfg.padded_vocab), dtype, (None, "vocab")),
    }


def _attend(q, k, v, cfg, dtype):
    """Dense softmax attention without a mask: q (b,s,nh,hd), k, v
    (b,t,nkv,hd) -> (b, s, nh*hd); scores and softmax in fp32, the weights
    rounded to ``dtype`` before the product with v."""
    b, s, nh, hd = q.shape
    scores = attn._gqa_scores(q, k, cfg) / hd ** 0.5
    w = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bngst,btnh->bsngh", w, v).reshape(b, s, nh * hd)


def _bidir_attention(x, p, cfg):
    """Encoder self-attention: full (non-causal), with RoPE."""
    q, k, v = attn._qkv(x, p, cfg)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k = attn.rope(q, pos, cfg.rope_theta), attn.rope(k, pos, cfg.rope_theta)
    return nn.dense(_attend(q, k, v, cfg, x.dtype), p["wo"])


def cross_kv(enc_out, p, cfg):
    b, t, _ = enc_out.shape
    hd, nkv = cfg.head_dim, cfg.n_kv
    k = nn.dense(enc_out, p["wk"]).reshape(b, t, nkv, hd)
    v = nn.dense(enc_out, p["wv"]).reshape(b, t, nkv, hd)
    return k, v


def _cross_attention(x, k, v, p, cfg):
    """q from the decoder's x, k and v from the encoder's output (no RoPE)."""
    b, s, _ = x.shape
    q = nn.dense(x, p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    return nn.dense(_attend(q, k, v, cfg, x.dtype), p["wo"])


def _enc_block(x, lp, cfg):
    h = x + _bidir_attention(nn.rmsnorm(x, lp["ln1"], cfg.norm_eps),
                             lp["attn"], cfg)
    return h + _mlp(nn.rmsnorm(h, lp["ln2"], cfg.norm_eps), lp["mlp"]), None


def _dec_block(x, lp, enc_out, cfg, backend):
    h = x + attn.attention(nn.rmsnorm(x, lp["ln1"], cfg.norm_eps),
                           lp["attn"], cfg, backend=backend)
    k, v = cross_kv(enc_out, lp["xattn"], cfg)
    h = h + _cross_attention(nn.rmsnorm(h, lp["lnx"], cfg.norm_eps),
                             k, v, lp["xattn"], cfg)
    return h + _mlp(nn.rmsnorm(h, lp["ln2"], cfg.norm_eps), lp["mlp"]), None


def encode(params, cfg, frames):
    """frames: (b, enc_seq, d) precomputed embeddings (the stub frontend).
    Under grad with ``cfg.remat == "full"`` each layer is checkpointed."""
    x = frames.to(cfg.param_dtype)
    x, _ = scan_layers(lambda h, lp: _enc_block(h, lp, cfg), x,
                       params["enc_layers"], cfg.n_enc_layers, {},
                       remat=cfg.remat == "full")
    return nn.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def encdec_forward(params, cfg, tokens, frames, *, backend: str = "auto"):
    """Teacher-forced forward: (logits (b, s, padded_vocab) fp32, aux).
    Keeps the autograd graph where grad is enabled; ``cfg.remat ==
    "full"`` then checkpoints each encoder and decoder layer."""
    enc_out = encode(params, cfg, frames)
    x = params["embed"].to(cfg.param_dtype)[tokens]
    x, _ = scan_layers(
        lambda h, lp: _dec_block(h, lp, enc_out, cfg, backend), x,
        params["dec_layers"], cfg.n_layers, {}, remat=cfg.remat == "full")
    x = nn.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits_out(x, params, cfg), _zero_aux(x.device)


def init_encdec_caches(cfg, batch: int, max_seq: int, dtype, device) -> dict:
    hd, nkv, L = cfg.head_dim, cfg.n_kv, cfg.n_layers

    def zeros(s):
        return torch.zeros((L, batch, s, nkv, hd), dtype=dtype, device=device)

    return {"kv": {"k": zeros(max_seq), "v": zeros(max_seq)},
            "xkv": {"k": zeros(cfg.enc_seq), "v": zeros(cfg.enc_seq)}}


def fill_cross_cache(params, cfg, frames, caches, slots=None):
    """Encode ``frames`` and write each decoder layer's cross KV into
    ``caches["xkv"]`` in place; returns ``caches``.  ``slots`` (a list of
    batch rows) writes those rows only, ``frames`` holding one row each;
    without it ``frames`` covers the whole batch, as in the reference."""
    enc_out = encode(params, cfg, frames)
    rows = slice(None) if slots is None else torch.as_tensor(
        slots, dtype=torch.int64, device=enc_out.device)
    layers = params["dec_layers"]
    for i in range(cfg.n_layers):
        k, v = cross_kv(enc_out, layer_slice(layers, i)["xattn"], cfg)
        caches["xkv"]["k"][i, rows] = k
        caches["xkv"]["v"][i, rows] = v
    return caches


def encdec_decode_step(params, cfg, token, caches, pos):
    """One decoder token against the self KV cache (written in place) and
    the cross KV.  Returns (logits (b, 1, padded_vocab) fp32, caches)."""
    x = params["embed"].to(cfg.param_dtype)[token]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    layers = params["dec_layers"]
    for i in range(cfg.n_layers):
        lp = layer_slice(layers, i)
        h, _ = attn.attention_decode(nn.rmsnorm(x, lp["ln1"], cfg.norm_eps),
                                     lp["attn"], cfg,
                                     layer_slice(caches["kv"], i), pos)
        h = x + h
        xkv = layer_slice(caches["xkv"], i)
        h = h + _cross_attention(nn.rmsnorm(h, lp["lnx"], cfg.norm_eps),
                                 xkv["k"], xkv["v"], lp["xattn"], cfg)
        x = h + _mlp(nn.rmsnorm(h, lp["ln2"], cfg.norm_eps), lp["mlp"])
    x = nn.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits_out(x, params, cfg), caches
