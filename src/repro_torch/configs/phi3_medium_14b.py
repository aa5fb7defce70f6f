"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352.  RoPE SwiGLU GQA [arXiv:2404.14219]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(name="phi3-medium-14b", kind="dense", n_layers=40, d_model=5120,
                n_heads=40, n_kv=10, d_ff=17920, vocab=100352,
                rope_theta=10000.0),
    smoke=ModelConfig(name="phi3-medium-14b-smoke", kind="dense", n_layers=2,
                      d_model=80, n_heads=4, n_kv=2, d_ff=192, vocab=173,
                      dtype="float32", remat="none"),
)
