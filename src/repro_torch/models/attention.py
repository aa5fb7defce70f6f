"""GQA attention with RoPE, after the reference's ``models/attention.py``:
the full-sequence path (prefill) through the causal flash-attention op, and
the one-token path against a KV cache (decode).  Softmax in fp32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import modules as nn
from repro_torch.models.modules import param

__all__ = ["attn_params", "rope", "attention", "attention_decode",
           "init_kv_cache"]

NEG_INF = -1e30


def attn_params(cfg, dtype) -> dict:
    d, hd, nh, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv
    p = {
        "wq": param((d, nh * hd), dtype, (None, "heads")),
        "wk": param((d, nkv * hd), dtype, (None, "kv_heads")),
        "wv": param((d, nkv * hd), dtype, (None, "kv_heads")),
        "wo": param((nh * hd, d), dtype, ("heads", None)),
    }
    if cfg.qkv_bias:
        p["bq"] = param((nh * hd,), dtype, ("heads",), init="zeros")
        p["bk"] = param((nkv * hd,), dtype, ("kv_heads",), init="zeros")
        p["bv"] = param((nkv * hd,), dtype, ("kv_heads",), init="zeros")
    return p


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); pos: (..., S) absolute positions."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[..., :, None, None].float() * freqs      # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _qkv(x, p, cfg):
    b, s, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv
    q = nn.dense(x, p["wq"], p.get("bq")).reshape(b, s, nh, hd)
    k = nn.dense(x, p["wk"], p.get("bk")).reshape(b, s, nkv, hd)
    v = nn.dense(x, p["wv"], p.get("bv")).reshape(b, s, nkv, hd)
    return q, k, v


def _gqa_scores(q, k, cfg):
    """q: (b,s,nh,hd), k: (b,t,nkv,hd) -> fp32 (b, nkv, group, s, t)."""
    b, s, nh, hd = q.shape
    nkv = cfg.n_kv
    q = q.reshape(b, s, nkv, nh // nkv, hd)
    return torch.einsum("bsngh,btnh->bngst", q.float(), k.float())


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(b, s, nh, hd) -> contiguous (b*nh, s, hd)."""
    b, s, nh, hd = x.shape
    return x.transpose(1, 2).reshape(b * nh, s, hd).contiguous()


def attention(x: torch.Tensor, p: dict, cfg, *, pos0: int = 0,
              backend: str = "auto") -> torch.Tensor:
    """Full-sequence causal attention (prefill).

    q is laid out as (b*nh, s, hd) and k, v as (b*nkv, s, hd), and all three
    go to ``ops.flash_attention``, which has query row b*nh + h read KV row
    b*nkv + h // g (g = nh / nkv: the reference's ``jnp.repeat(k, g,
    axis=2)``, each KV head serving g consecutive query heads) without a
    repeated copy: a CUDA kernel for tensors on the card, the plain version
    on the CPU (``backend="ref"`` asks for the plain version on the card
    too)."""
    b, s, _ = x.shape
    hd, nh = cfg.head_dim, cfg.n_heads
    q, k, v = _qkv(x, p, cfg)
    pos = pos0 + torch.arange(s, device=x.device)[None, :]
    q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
    o = ops.flash_attention(_heads_first(q), _heads_first(k), _heads_first(v),
                            backend=backend)
    o = o.reshape(b, nh, s, hd).transpose(1, 2).reshape(b, s, nh * hd)
    return nn.dense(o, p["wo"])


def init_kv_cache(cfg, batch: int, max_seq: int, dtype, device) -> dict:
    hd, nkv = cfg.head_dim, cfg.n_kv
    shape = (cfg.n_layers, batch, max_seq, nkv, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def attention_decode(x: torch.Tensor, p: dict, cfg, kv_layer: dict,
                     pos) -> tuple[torch.Tensor, dict]:
    """One-token decode: x (b, 1, d), kv_layer {'k','v'}: (b, S, nkv, hd),
    pos: scalar or per-sequence (b,) positions (continuous batching).
    Returns (out (b,1,d), kv_layer).

    The cache is written in place (the reference returns an updated copy):
    a scalar ``pos`` writes row ``pos`` of every sequence (clamped into the
    cache, as ``dynamic_update_slice`` does), a (b,) ``pos`` row ``pos[i]``
    of sequence i."""
    b = x.shape[0]
    hd, nh = cfg.head_dim, cfg.n_heads
    kc, vc = kv_layer["k"], kv_layer["v"]
    s_max = kc.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    posb = pos.expand(b)
    q, k_new, v_new = _qkv(x, p, cfg)
    q = rope(q, posb[:, None], cfg.rope_theta)
    k_new = rope(k_new, posb[:, None], cfg.rope_theta)
    if pos.dim() == 0:
        row = pos.clamp(0, s_max - 1).reshape(1)
        kc.index_copy_(1, row, k_new)
        vc.index_copy_(1, row, v_new)
    else:                                      # per-slot positions (engine)
        bidx = torch.arange(b, device=x.device)
        kc[bidx, pos] = k_new[:, 0]
        vc[bidx, pos] = v_new[:, 0]
    scores = _gqa_scores(q, kc, cfg) / hd ** 0.5
    valid = torch.arange(s_max, device=x.device)[None, :] <= posb[:, None]
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bngst,btnh->bsngh", w, vc).reshape(b, 1, nh * hd)
    return nn.dense(o, p["wo"]), {"k": kc, "v": vc}
