"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
Tied embeddings + logit scaling [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(name="granite-3-2b", kind="dense", n_layers=40, d_model=2048,
                n_heads=32, n_kv=8, d_ff=8192, vocab=49155,
                tie_embeddings=True, rope_theta=10000.0),
    smoke=ModelConfig(name="granite-3-2b-smoke", kind="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=199,
                      tie_embeddings=True, dtype="float32", remat="none"),
)
