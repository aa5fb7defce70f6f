"""PyTorch and CUDA port of the JAX package ``repro``, for the NVIDIA H100.

It holds the banded SVD pipeline (the entry points below) and the LM
serving path: the dense decoders (``repro_torch.models``, configs in
``repro_torch.configs``), their prefill through the causal flash-attention
kernel, and the token ``Engine`` (``repro_torch.serve``, driven by
``python -m repro_torch.launch.serve``).  Those modules are imported only
when asked for, so importing this package stays light.

The JAX package ``repro`` is the reference; this package imports nothing of
it and nothing of JAX.  Entry points run on the card unless the caller asks
for the CPU (``device="cpu"``), where the plain PyTorch versions of the
kernels run.
"""

from repro_torch.core.svd import (NumericalFault, banded_singular_values,
                                  banded_svd, batched_singular_values,
                                  bidiagonal_of, singular_values,
                                  spot_check_svd, svd, svd_batched,
                                  validate_sigma, validate_uv)
from repro_torch.core.tuning import PipelineConfig

__all__ = ["singular_values", "batched_singular_values", "svd_batched",
           "svd", "banded_svd", "banded_singular_values", "bidiagonal_of",
           "validate_sigma", "validate_uv", "spot_check_svd",
           "NumericalFault", "PipelineConfig"]
