"""The LM substrate of the port: the reference's ten architectures
(``zoo.Model``: dense, MoE, hybrid and RWKV6 decoders, and the whisper
encoder-decoder) with the full-sequence path, causal self-attention
through the flash-attention kernel, and one-token decode against the
caches."""
from repro_torch.models.zoo import Model, batch_logical, build

__all__ = ["Model", "build", "batch_logical"]
