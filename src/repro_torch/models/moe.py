"""Mixture-of-Experts FFN, after the reference's ``models/moe.py``.

Routing: top-k softmax in fp32.  Dispatch: sort-based capacity bucketing per
example (a stable sort of the token-major (token, choice) pairs by expert,
the first ``cap`` of each expert kept), so memory scales as
``s * top_k * d`` and shapes are static.  Optional shared experts
(DeepSeekMoE), the Switch aux loss and the router z-loss.  The expert
products are plain batched matmuls: the reference computes them outside any
Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import modules as nn
from repro_torch.models.modules import param

__all__ = ["moe_params", "moe_ffn"]


def moe_params(cfg, dtype) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": param((d, e), torch.float32,     # fp32 at every dtype
                        (None, "expert")),
        "wi": param((e, d, 2 * f), dtype, ("expert", None, "dff")),
        "wo": param((e, f, d), dtype, ("expert", "dff", None)),
    }
    if cfg.n_shared_experts:
        p["shared"] = nn.swiglu_p(d, f * cfg.n_shared_experts, dtype)
    return p


def _capacity(s: int, cfg) -> int:
    cap = int(cfg.top_k * s * cfg.capacity_factor / cfg.n_experts) + 1
    return min(max(cap, min(4, s * cfg.top_k)), s)


def _route_one(gate_idx, gate_vals, *, e: int, cap: int):
    """Dispatch indices of each example.  gate_*: (b, s, k).

    Returns (tok (b, e, cap) token ids, w (b, e, cap) combine weights,
    valid (b, e, cap)).  A stable sort by expert id groups the
    (token, choice) pairs in token-major order; pairs past an expert's
    capacity are dropped (first come, as GShard/Switch)."""
    b, s, k = gate_idx.shape
    dev = gate_idx.device
    flat_e = gate_idx.reshape(b, s * k)                  # token-major
    flat_w = gate_vals.reshape(b, s * k)
    flat_tok = torch.arange(s * k, device=dev) // k
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    sorted_tok = flat_tok[order]
    sorted_w = flat_w.gather(-1, order)
    counts = torch.zeros((b, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(-1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, -1) - counts
    ar = torch.arange(cap, device=dev)
    slot = starts[..., None] + ar                        # (b, e, cap)
    valid = ar < counts[..., None]
    slot = slot.clamp(0, s * k - 1).reshape(b, e * cap)
    # safety: slots past the end of an expert's range belong to others
    experts = torch.arange(e, device=dev)[:, None]
    valid &= sorted_e.gather(-1, slot).reshape(b, e, cap) == experts
    tok = sorted_tok.gather(-1, slot).reshape(b, e, cap)
    w = torch.where(valid, sorted_w.gather(-1, slot).reshape(b, e, cap), 0.0)
    return tok, w, valid


def moe_ffn(x: torch.Tensor, p: dict, cfg) -> tuple[torch.Tensor, dict]:
    """x: (b, s, d) -> (out, {'aux_loss', 'router_zloss'})."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(s, cfg)

    logits = torch.matmul(x.float(), p["router"].float())       # (b, s, e)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    tok, w, valid = _route_one(gate_idx, gate_vals, e=e, cap=cap)
    # gather: (b, e, cap, d), zeroed beyond capacity
    bidx = torch.arange(b, device=x.device)[:, None, None]
    xe = torch.where(valid[..., None], x[bidx, tok], 0)
    # per expert, (b*cap, d) @ (d, 2f): x.dtype products summed in fp32,
    # rounded to x.dtype (the reference's preferred_element_type, then
    # astype)
    xe = xe.transpose(0, 1).reshape(e, b * cap, d)
    gu = torch.bmm(xe, p["wi"].to(x.dtype))
    g, u = gu.chunk(2, dim=-1)
    # the second product stays in fp32 until after the scatter-add
    ye = torch.bmm((F.silu(g) * u).float(), p["wo"].float())   # (e, b*cap, d)
    ye = ye.reshape(e, b, cap, d).transpose(0, 1) * w[..., None]
    # scatter-add back to tokens (duplicates accumulate, in fp32)
    rows = (tok + torch.arange(b, device=x.device)[:, None, None] * s)
    out = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, rows.reshape(-1), ye.reshape(-1, d))
    out = out.reshape(b, s, d).to(x.dtype)

    if cfg.n_shared_experts:
        out = out + nn.swiglu(x, p["shared"])

    # Switch aux loss + router z-loss
    me = probs.mean((0, 1))                                       # (e,)
    ce = F.one_hot(gate_idx, e).float().sum(2).mean((0, 1))
    aux = cfg.aux_loss_coef * e * torch.sum(me * ce)
    zloss = cfg.router_zloss * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    return out, {"aux_loss": aux, "router_zloss": zloss}
