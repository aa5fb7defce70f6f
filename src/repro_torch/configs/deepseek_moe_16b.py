"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) d_ff=1408/expert
vocab=102400, 2 shared + 64 routed top-6, fine-grained [arXiv:2401.06066]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(name="deepseek-moe-16b", kind="moe", n_layers=28, d_model=2048,
                n_heads=16, n_kv=16, d_ff=1408, vocab=102400, n_experts=64,
                n_shared_experts=2, top_k=6, rope_theta=10000.0),
    smoke=ModelConfig(name="deepseek-moe-16b-smoke", kind="moe", n_layers=2,
                      d_model=64, n_heads=4, n_kv=4, d_ff=32, vocab=163,
                      n_experts=8, n_shared_experts=2, top_k=2,
                      dtype="float32", remat="none"),
)
