"""PyTorch and CUDA port of the banded SVD pipeline, for the NVIDIA H100.

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
