"""Architecture config schema and registry, copied from the reference's
``configs/base.py``.

One file per ported architecture lives next to this module; each registers a
``ModelConfig`` under its public id (``--arch <id>`` in the launcher) and a
``smoke`` variant (same family, tiny widths) that the CPU tests use.  All
ten of the reference's architectures are registered: five dense decoders,
two MoE decoders, the hybrid (hymba), RWKV6 and the encoder-decoder
(whisper).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

__all__ = ["ModelConfig", "register", "get_config", "list_configs", "smoke_of"]

BlockKind = Literal["dense", "moe", "hymba", "rwkv", "encdec"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: BlockKind                    # layer family
    n_layers: int
    d_model: int
    n_heads: int                       # query heads (0 for attention-free)
    n_kv: int                          # KV heads (GQA); == n_heads -> MHA
    d_ff: int
    vocab: int
    d_head: int = 0                    # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_zloss: float = 1e-3
    aux_loss_coef: float = 1e-2
    # --- SSM / linear recurrence ---
    ssm_state: int = 0                 # mamba state size N
    ssm_conv: int = 4                  # causal conv width
    ssm_expand: int = 2                # mamba inner expansion
    rwkv_head: int = 64                # rwkv6 head size
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0                   # encoder frames (precomputed stub embeds)
    # --- VLM stub ---
    n_img_tokens: int = 0              # prepended precomputed patch embeddings
    # --- misc knobs ---
    qkv_bias: bool = False
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: str = "full"                # "none" | "full" — activation ckpt policy
    # long-context capability: attention-free/hybrid archs handle 500k decode
    subquadratic: bool = False

    # embedding tables are padded to a shardable multiple (production vocab
    # padding); logits carry the padded width, labels never reference the pad
    vocab_pad: int = 256

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // self.vocab_pad) * self.vocab_pad

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def active_params(self) -> int:
        """Approximate active parameter count (MoE counts top_k experts)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv
        attn = d * hd * nh + 2 * d * hd * nkv + hd * nh * d
        if self.kind == "rwkv":
            attn = 4 * d * d
        if self.kind == "hymba":
            attn += 2 * d * d * self.ssm_expand
        ffn = 3 * d * f
        if self.n_experts:
            ffn = 3 * d * f * (self.top_k + self.n_shared_experts) + d * self.n_experts
        emb = v * d * (1 if self.tie_embeddings else 2)
        enc = self.n_enc_layers * (attn + ffn)
        return L * (attn + ffn) + emb + enc

    def total_params(self) -> int:
        if not self.n_experts:
            return self.active_params()
        d, f = self.d_model, self.d_ff
        per_layer_extra = 3 * d * f * (self.n_experts - self.top_k)
        return self.active_params() + self.n_layers * per_layer_extra


_REGISTRY: dict[str, ModelConfig] = {}
_SMOKE: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig):
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _REGISTRY[name]


def smoke_of(name: str) -> ModelConfig:
    _ensure_loaded()
    return _SMOKE[name]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        codeqwen15_7b, deepseek_moe_16b, granite_3_2b, granite_moe_3b_a800m,
        hymba_1_5b, llama3_8b, phi3_medium_14b, pixtral_12b, rwkv6_1_6b,
        whisper_medium)
