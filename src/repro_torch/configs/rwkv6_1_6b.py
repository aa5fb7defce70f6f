"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.
Finch: data-dependent decay [arXiv:2404.05892].  O(1)-state decode ->
long_500k runs for this arch."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(name="rwkv6-1.6b", kind="rwkv", n_layers=24, d_model=2048,
                n_heads=0, n_kv=0, d_ff=7168, vocab=65536, rwkv_head=64,
                subquadratic=True),
    smoke=ModelConfig(name="rwkv6-1.6b-smoke", kind="rwkv", n_layers=2,
                      d_model=64, n_heads=0, n_kv=0, d_ff=160, vocab=131,
                      rwkv_head=16, subquadratic=True, dtype="float32",
                      remat="none"),
)
