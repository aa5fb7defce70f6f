"""PyTorch and CUDA port of the banded SVD pipeline, for the NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it and nothing of JAX.  Entry points run on the card unless the caller asks
for the CPU (``device="cpu"``), where the plain PyTorch versions of the
kernels run.
"""

from repro_torch.core.svd import (NumericalFault, banded_singular_values,
                                  bidiagonal_of, validate_sigma)
from repro_torch.core.tuning import PipelineConfig

__all__ = ["banded_singular_values", "bidiagonal_of", "validate_sigma",
           "NumericalFault", "PipelineConfig"]
