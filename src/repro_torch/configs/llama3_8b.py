"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
GQA + 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(name="llama3-8b", kind="dense", n_layers=32, d_model=4096,
                n_heads=32, n_kv=8, d_ff=14336, vocab=128256,
                rope_theta=500000.0),
    smoke=ModelConfig(name="llama3-8b-smoke", kind="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv=2, d_ff=160, vocab=256,
                      dtype="float32", remat="none"),
)
