"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
Backbone only; the pixtral-ViT frontend is a stub — input_specs() provides
precomputed patch embeddings (256 tokens) [hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(name="pixtral-12b", kind="dense", n_layers=40, d_model=5120,
                n_heads=32, n_kv=8, d_ff=14336, vocab=131072,
                n_img_tokens=256, rope_theta=1000000000.0),
    smoke=ModelConfig(name="pixtral-12b-smoke", kind="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv=2, d_ff=160, vocab=193,
                      n_img_tokens=8, dtype="float32", remat="none"),
)
