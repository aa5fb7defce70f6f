"""Selective state-space (Mamba) block and the chunked decay scan, after the
reference's ``models/ssm.py``.

Two evaluators of the data-dependent-decay linear recurrence
``S_t = diag(a_t) S_{t-1} + k_t v_t^T ; y_t = S_t q_t``:

* ``chunked_decay_scan``: the multi-head (dk, dv) form RWKV6 uses: an
  intra-chunk quadratic form and the state carried from chunk to chunk by a
  Python loop.
* Mamba's per-channel form (h = d_inner, dk = ssm_state, dv = 1) expands the
  (chunk, d_inner, n) tensors inside the chunk loop, so the whole sequence
  holds only (b, t, d_inner).  Inside a chunk the prefix states come from a
  log-step (Hillis-Steele) scan with the reference's combine
  ``(a_l + a_r, s_l * exp(a_r) + s_r)``: log2(chunk) steps.

One departure on purpose: ``chunked_decay_scan`` forms its intra-chunk
scores from the pairwise decays ``exp(acc_c - acc_d)`` (d <= c, each at most
1) where the reference multiplies ``q * exp(acc)`` by ``k * exp(-acc)``.
The latter overflows once a chunk's decays sum past about -88 (unit decay
for 88 steps, RWKV6's value at init) and gives inf * 0 = NaN, so the
reference's RWKV6 prefill is NaN from about 88 tokens on.  Where the
reference is finite the two agree to rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import modules as nn
from repro_torch.models.modules import param

__all__ = ["chunked_decay_scan", "decay_step", "mamba_params", "mamba",
           "mamba_decode", "init_mamba_cache"]


def _pad_seq(x, pad: int):
    """x (b, t, ...) with ``pad`` zero steps appended along t."""
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)


def chunked_decay_scan(q, k, v, log_a, *, chunk: int = 128, state0=None):
    """Multi-head decay recurrence.  q, k: (b,t,h,dk); v: (b,t,h,dv);
    log_a: (b,t,h,dk) (<= 0).  Returns (y (b,t,h,dv) in v.dtype, state
    (b,h,dk,dv) fp32)."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    pad = (-t) % chunk
    q, k, v, log_a = (_pad_seq(x, pad) for x in (q, k, v, log_a))
    state = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
             if state0 is None else state0)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=q.device).tril()
    ys = []
    for c0 in range(0, t + pad, chunk):
        qi, ki, vi, lai = (x[:, c0:c0 + chunk].float()
                           for x in (q, k, v, log_a))      # (b,chunk,h,d*)
        acc = torch.cumsum(lai, dim=1)                     # incl. self
        total = acc[:, -1:]
        y_state = torch.einsum("bchk,bhkv->bchv", qi * torch.exp(acc), state)
        # pairwise decays exp(acc_c - acc_d) for d <= c: (b, c, d, h, dk)
        rel = acc[:, :, None] - acc[:, None]
        rel = rel.masked_fill(~causal[None, :, :, None, None], float("-inf"))
        scores = (qi[:, :, None] * ki[:, None] * torch.exp(rel)).sum(-1)
        y_intra = torch.einsum("bcdh,bdhv->bchv", scores, vi)
        k_tail = ki * torch.exp(total - acc)
        state = state * torch.exp(total).squeeze(1)[..., None] + torch.einsum(
            "bchk,bchv->bhkv", k_tail, vi)
        ys.append((y_state + y_intra).to(v.dtype))
    return torch.cat(ys, 1)[:, :t], state


def decay_step(q, k, v, log_a, state):
    """Single-token recurrence step (decode).  q, k, log_a: (b,h,dk); v:
    (b,h,dv); state: (b,h,dk,dv) fp32."""
    a = torch.exp(log_a.float())[..., None]
    state = state * a + torch.einsum("bhk,bhv->bhkv", k.float(), v.float())
    y = torch.einsum("bhk,bhkv->bhv", q.float(), state)
    return y.to(v.dtype), state


# ---------------------------------------------------------------------------
# Mamba (selective SSM) block: the SSM path of hymba
# ---------------------------------------------------------------------------

def mamba_params(cfg, dtype) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    f32 = torch.float32                          # fp32 at every model dtype
    return {
        "in_proj": param((d, 2 * di), dtype, (None, "dff")),
        "conv_w": param((cfg.ssm_conv, di), dtype, (None, "dff")),
        "conv_b": param((di,), dtype, ("dff",), init="zeros"),
        "w_b": param((di, n), dtype, ("dff", None)),    # x -> B (input gate)
        "w_c": param((di, n), dtype, ("dff", None)),    # x -> C (output gate)
        "w_dt": param((di, 1), dtype, ("dff", None)),
        "dt_bias": param((di,), f32, ("dff",), init="zeros"),
        "a_log": param((di, n), f32, ("dff", None), init="ones"),
        "d_skip": param((di,), f32, ("dff",), init="ones"),
        "out_proj": param((di, d), dtype, ("dff", None)),
    }


def _causal_conv(x, w, b, state=None):
    """x: (b, t, c); w: (k, c) depthwise causal conv; state: (b, k-1, c).
    Returns (out, the last k-1 inputs: the next call's state)."""
    kw = w.shape[0]
    if state is None:
        xp = torch.cat([x.new_zeros((x.shape[0], kw - 1, x.shape[2])), x], 1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    out = xp[:, 0:t] * w[0].to(x.dtype)
    for i in range(1, kw):
        out = out + xp[:, i:i + t] * w[i].to(x.dtype)
    new_state = xp[:, xp.shape[1] - (kw - 1):]
    return out + b.to(x.dtype), new_state


def _dt_b_c(xc, p):
    """(b, *, di) -> dt (b,*,di), bmat/cmat (b,*,n), all fp32; the (di, n)
    expansion waits for the chunk loop."""
    bmat = nn.dense(xc, p["w_b"]).float()
    cmat = nn.dense(xc, p["w_c"]).float()
    # scalar dt per position, per channel through the bias (dt_rank = 1)
    dt = F.softplus(nn.dense(xc, p["w_dt"]).float() + p["dt_bias"])
    return dt, bmat, cmat


def _prefix_states(log_a, kv):
    """Inclusive scan over axis 1 of the pairs (log_a, kv) under
    ``(a_l, s_l) . (a_r, s_r) = (a_l + a_r, s_l * exp(a_r) + s_r)``:
    log2(n) steps, each combining position i with position i - o."""
    n = kv.shape[1]
    o = 1
    while o < n:
        a_r, s_r = log_a[:, o:], kv[:, o:]
        s_new = kv[:, :-o] * torch.exp(a_r).to(kv.dtype) + s_r
        a_new = log_a[:, :-o] + a_r
        kv = torch.cat([kv[:, :o], s_new], 1)
        log_a = torch.cat([log_a[:, :o], a_new], 1)
        o *= 2
    return kv


def _mamba_scan(xc, dt, bmat, cmat, a, *, chunk: int, state0):
    """Chunked selective scan.  xc: (b,t,di); dt: (b,t,di) fp32; bmat/cmat:
    (b,t,n) fp32; a: (di,n) negative; state0: (b,di,n) fp32.  Returns
    (y (b,t,di) in xc.dtype, state)."""
    t = xc.shape[1]
    pad = (-t) % chunk
    xc, dt, bmat, cmat = (_pad_seq(x, pad) for x in (xc, dt, bmat, cmat))
    state = state0
    ys = []
    for c0 in range(0, t + pad, chunk):
        xi, dti, bi, ci = (x[:, c0:c0 + chunk] for x in (xc, dt, bmat, cmat))
        # scan inputs in the model's dtype (bf16 at bf16); the
        # chunk-boundary correction and the carried state stay fp32
        kv = ((dti * xi.float())[..., None] * bi[:, :, None, :]).to(xi.dtype)
        log_a = dti[..., None] * a                        # (b,c,di,n) fp32
        s_pref = _prefix_states(log_a, kv)                # model dtype
        acc_dt = torch.cumsum(dti, dim=1)                 # (b,c,di)
        corr = torch.exp(acc_dt[..., None] * a) * state[:, None]
        s_tot = s_pref + corr.to(s_pref.dtype)
        y = torch.einsum("bcdn,bcn->bcd", s_tot, ci.to(s_tot.dtype))
        state = s_pref[:, -1].float() + torch.exp(
            acc_dt[:, -1][..., None] * a) * state
        ys.append(y.to(xc.dtype))
    return torch.cat(ys, 1)[:, :t], state


def mamba(x, p, cfg, *, chunk: int = 128):
    """Full-sequence Mamba path.  x: (b, t, d) -> (b, t, d)."""
    xz = nn.dense(x, p["in_proj"])
    xi, z = xz.chunk(2, dim=-1)
    xc, _ = _causal_conv(xi, p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    dt, bmat, cmat = _dt_b_c(xc, p)
    a = -torch.exp(p["a_log"].float())
    state0 = torch.zeros((x.shape[0], p["a_log"].shape[0], cfg.ssm_state),
                         dtype=torch.float32, device=x.device)
    y, _ = _mamba_scan(xc, dt, bmat, cmat, a, chunk=chunk, state0=state0)
    y = y.float() + p["d_skip"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    return nn.dense(y, p["out_proj"])


def init_mamba_cache(cfg, batch: int, dtype, device) -> dict:
    di = cfg.ssm_expand * cfg.d_model
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, di),
                            dtype=dtype, device=device),
        "state": torch.zeros((cfg.n_layers, batch, di, cfg.ssm_state),
                             dtype=torch.float32, device=device),
    }


def mamba_decode(x, p, cfg, cache_layer):
    """One-token step.  x: (b, 1, d) -> (out (b,1,d), new cache
    {'conv', 'state'})."""
    xz = nn.dense(x, p["in_proj"])
    xi, z = xz.chunk(2, dim=-1)
    xc, conv_state = _causal_conv(xi, p["conv_w"], p["conv_b"],
                                  state=cache_layer["conv"])
    xc = F.silu(xc)
    dt, bmat, cmat = _dt_b_c(xc[:, 0], p)                   # (b, di), (b, n)
    a = -torch.exp(p["a_log"].float())
    log_a = dt[..., None] * a                               # (b, di, n)
    kv = (dt * xc[:, 0].float())[..., None] * bmat[:, None, :]
    state = cache_layer["state"] * torch.exp(log_a) + kv
    y = torch.einsum("bdn,bn->bd", state, cmat)
    y = y + p["d_skip"] * xc[:, 0].float()
    y = y[:, None].to(x.dtype) * F.silu(z)
    out = nn.dense(y, p["out_proj"])
    return out, {"conv": conv_state, "state": state}
