"""The LM substrate of the port: dense decoders (``zoo.Model``) with the
full-sequence path through the flash-attention kernel and one-token decode
against a KV cache."""
from repro_torch.models.zoo import Model, build

__all__ = ["Model", "build"]
