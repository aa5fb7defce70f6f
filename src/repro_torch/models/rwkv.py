"""RWKV6 ("Finch") block, after the reference's ``models/rwkv.py``: a
data-dependent-decay linear recurrence (time-mix) and a squared-ReLU
channel-mix.  Attention-free: O(1) state per token.

Time-mix:
    y_t = r_t . (S_{t-1} + u (x) k_t v_t),   S_t = diag(w_t) S_{t-1} + k_t v_t
with w_t = exp(-exp(w0 + lora(x_mix))) per channel.  The sequence path runs
``ssm.chunked_decay_scan`` through the shift trick (q.S_{t-1} is the
inclusive scan over right-shifted (k, v, w)); decode is one recurrence step.
The token-shift lerps are static per projection, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import modules as nn
from repro_torch.models.modules import param
from repro_torch.models.ssm import chunked_decay_scan

__all__ = ["rwkv_params", "rwkv_time_mix", "rwkv_channel_mix",
           "rwkv_time_mix_decode", "rwkv_channel_mix_decode",
           "init_rwkv_cache"]

_LORA = 64


def rwkv_params(cfg, dtype) -> dict:
    d = cfg.d_model
    f = cfg.d_ff
    f32 = torch.float32                          # fp32 at every model dtype
    return {
        "tm": {
            "mu": param((5, d), dtype, (None, None),   # r, k, v, w, g
                        init="zeros"),
            "wr": param((d, d), dtype, (None, "heads")),
            "wk": param((d, d), dtype, (None, "heads")),
            "wv": param((d, d), dtype, (None, "heads")),
            "wg": param((d, d), dtype, (None, "heads")),
            "w0": param((d,), f32, (None,), init="zeros"),
            "w_a": param((d, _LORA), dtype, (None, None)),
            "w_b": param((_LORA, d), dtype, (None, None), init="zeros"),
            "u": param((d,), f32, (None,), init="zeros"),
            "ln_g": param((d,), dtype, (None,), init="ones"),
            "wo": param((d, d), dtype, ("heads", None)),
        },
        "cm": {
            "mu": param((2, d), dtype, (None, None), init="zeros"),
            "wk": param((d, f), dtype, (None, "dff")),
            "wv": param((f, d), dtype, ("dff", None)),
            "wr": param((d, d), dtype, (None, None)),
        },
    }


def _shift(x):
    """Right-shift along the sequence axis with a zero first row: x_{t-1}."""
    return torch.cat([x.new_zeros((x.shape[0], 1) + x.shape[2:]),
                      x[:, :-1]], 1)


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def _heads(x, hsz):
    b, t, d = x.shape
    return x.reshape(b, t, d // hsz, hsz)


def _decay(xw, p):
    lora = torch.tanh(nn.dense(xw, p["w_a"])) @ p["w_b"].to(xw.dtype)
    return -torch.exp(torch.clamp(p["w0"] + lora.float(), -8, 4))


def _group_norm(y):
    """Per-head normalisation over the last axis (variance with ddof 0)."""
    return (y - y.mean(-1, keepdim=True)) * torch.rsqrt(
        y.var(-1, keepdim=True, correction=0) + 1e-5)


def rwkv_time_mix(x, p, cfg, *, chunk: int = 128):
    """x: (b, t, d) -> (b, t, d)."""
    hsz = cfg.rwkv_head
    xp = _shift(x)
    mu = p["mu"]
    xr, xk, xv, xw, xg = (_lerp(x, xp, mu[i]) for i in range(5))
    r = _heads(nn.dense(xr, p["wr"]), hsz)
    k = _heads(nn.dense(xk, p["wk"]), hsz)
    v = _heads(nn.dense(xv, p["wv"]), hsz)
    g = nn.dense(xg, p["wg"])
    log_w = _heads(_decay(xw, p), hsz)                      # (b,t,h,hsz) <= 0

    # shift trick: q . S_{t-1} == inclusive scan over shifted (k, v, w)
    ks, vs, ws = (_heads(_shift(z.flatten(2)), hsz) for z in (k, v, log_w))
    y, _ = chunked_decay_scan(r, ks, vs, ws, chunk=chunk)
    u = p["u"].reshape(1, 1, -1, hsz)
    bonus = torch.sum(r.float() * u * k.float(), -1, keepdim=True) * v.float()
    y = y.float() + bonus
    y = _group_norm(y).reshape(x.shape).to(x.dtype) * p["ln_g"].to(x.dtype)
    return nn.dense(y * F.silu(g), p["wo"])


def rwkv_channel_mix(x, p, cfg):
    xp = _shift(x)
    xk = _lerp(x, xp, p["mu"][0])
    xr = _lerp(x, xp, p["mu"][1])
    k = torch.square(torch.relu(nn.dense(xk, p["wk"])))
    return torch.sigmoid(nn.dense(xr, p["wr"])) * nn.dense(k, p["wv"])


def init_rwkv_cache(cfg, batch: int, dtype, device) -> dict:
    d = cfg.d_model
    hsz = cfg.rwkv_head
    h = d // hsz
    L = cfg.n_layers
    return {
        "x_tm": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "x_cm": torch.zeros((L, batch, d), dtype=dtype, device=device),
        "state": torch.zeros((L, batch, h, hsz, hsz), dtype=torch.float32,
                             device=device),
    }


def rwkv_time_mix_decode(x, p, cfg, x_prev, state):
    """One token: x (b,1,d); x_prev (b,d); state (b,h,hsz,hsz) fp32.
    Returns (out (b,1,d), the new x_prev, the new state)."""
    hsz = cfg.rwkv_head
    xp = x_prev[:, None]
    mu = p["mu"]
    xr, xk, xv, xw, xg = (_lerp(x, xp, mu[i]) for i in range(5))
    r = _heads(nn.dense(xr, p["wr"]), hsz)[:, 0]            # (b,h,hsz)
    k = _heads(nn.dense(xk, p["wk"]), hsz)[:, 0]
    v = _heads(nn.dense(xv, p["wv"]), hsz)[:, 0]
    g = nn.dense(xg, p["wg"])
    log_w = _heads(_decay(xw, p), hsz)[:, 0]
    u = p["u"].reshape(1, -1, hsz)
    rf, kf, vf = r.float(), k.float(), v.float()
    y = torch.einsum("bhk,bhkv->bhv", rf, state) + torch.sum(
        rf * u * kf, -1, keepdim=True) * vf
    state = state * torch.exp(log_w.float())[..., None] + torch.einsum(
        "bhk,bhv->bhkv", kf, vf)
    y = _group_norm(y).reshape(x.shape[0], 1, -1).to(x.dtype) * \
        p["ln_g"].to(x.dtype)
    out = nn.dense(y * F.silu(g), p["wo"])
    return out, x[:, 0], state


def rwkv_channel_mix_decode(x, p, cfg, x_prev):
    """One token: x (b,1,d); x_prev (b,d).  Returns (out, the new x_prev)."""
    xp = x_prev[:, None]
    xk = _lerp(x, xp, p["mu"][0])
    xr = _lerp(x, xp, p["mu"][1])
    k = torch.square(torch.relu(nn.dense(xk, p["wk"])))
    out = torch.sigmoid(nn.dense(xr, p["wr"])) * nn.dense(k, p["wv"])
    return out, x[:, 0]
