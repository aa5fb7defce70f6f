"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert
vocab=49155, 40 experts top-8 [hf:ibm-granite/granite-3.0 family]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(name="granite-moe-3b-a800m", kind="moe", n_layers=32,
                d_model=1536, n_heads=24, n_kv=8, d_ff=512, vocab=49155,
                n_experts=40, top_k=8, rope_theta=10000.0),
    smoke=ModelConfig(name="granite-moe-3b-a800m-smoke", kind="moe",
                      n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=48,
                      vocab=151, n_experts=8, top_k=2, dtype="float32",
                      remat="none"),
)
