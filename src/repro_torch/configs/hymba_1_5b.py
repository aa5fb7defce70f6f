"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attention + mamba heads per layer [arXiv:2411.13676].
Sub-quadratic SSM path -> long_500k decode runs for this arch."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(name="hymba-1.5b", kind="hymba", n_layers=32, d_model=1600,
                n_heads=25, n_kv=5, d_ff=5504, vocab=32001, ssm_state=16,
                ssm_expand=2, subquadratic=True, rope_theta=10000.0),
    smoke=ModelConfig(name="hymba-1.5b-smoke", kind="hymba", n_layers=2,
                      d_model=64, n_heads=4, n_kv=2, d_ff=160, vocab=127,
                      ssm_state=4, ssm_expand=2, subquadratic=True,
                      dtype="float32", remat="none"),
)
