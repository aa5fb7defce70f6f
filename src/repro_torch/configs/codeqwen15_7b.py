"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (GQA kv=32 == MHA) d_ff=13440
vocab=92416.  qwen1.5 arch: QKV bias [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(name="codeqwen1.5-7b", kind="dense", n_layers=32, d_model=4096,
                n_heads=32, n_kv=32, d_ff=13440, vocab=92416, qkv_bias=True,
                rope_theta=1000000.0),
    smoke=ModelConfig(name="codeqwen1.5-7b-smoke", kind="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv=4, d_ff=160, vocab=211,
                      qkv_bias=True, dtype="float32", remat="none"),
)
