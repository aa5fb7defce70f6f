"""Hand-written CUDA kernels of the SVD pipeline and of the LM's attention,
their wrappers, their plain PyTorch versions and the backend registry.
Sources are built on first use on a CUDA tensor, never on import."""
