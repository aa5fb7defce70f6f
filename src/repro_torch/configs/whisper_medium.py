"""whisper-medium [audio]: enc-dec, 24L(+24 enc) d_model=1024 16H (kv=16)
d_ff=4096 vocab=51865 [arXiv:2212.04356].  Conv/mel frontend is a stub:
input_specs() provides precomputed frame embeddings (1500 frames).
Decoder is the sequence axis for decode shapes; long_500k skipped."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(name="whisper-medium", kind="encdec", n_layers=24,
                d_model=1024, n_heads=16, n_kv=16, d_ff=4096, vocab=51865,
                n_enc_layers=24, enc_seq=1500, rope_theta=10000.0),
    smoke=ModelConfig(name="whisper-medium-smoke", kind="encdec", n_layers=2,
                      d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=117,
                      n_enc_layers=2, enc_seq=24, dtype="float32",
                      remat="none"),
)
