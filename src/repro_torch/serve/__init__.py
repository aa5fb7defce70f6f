"""Serving of the port: the token ``Engine`` for the dense decoders.  The
SVD serve tiers are a later slice."""
from repro_torch.serve.engine import Engine, Request, ServeConfig

__all__ = ["Engine", "Request", "ServeConfig"]
