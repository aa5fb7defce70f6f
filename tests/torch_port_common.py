"""Helpers shared by the port's test files (``test_torch_*.py``).

Imports no JAX at module level: ``test_torch_kernels.py`` uses it on the
card, where JAX is not installed."""

import functools

import numpy as np
import pytest
import torch

# the reference's kernel-test tolerances (tests/test_kernels.py), times scale
DTYPES = [("float32", 3e-5), ("float64", 1e-12), ("bfloat16", 8e-2)]


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``:
    rounded once, by jax, so both sides start bit-equal."""
    import jax.numpy as jnp
    j = jnp.asarray(x, getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32) if dtype == "bfloat16"
                                  else j)).to(torch_dtype(dtype))
    return j, t


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float64).numpy()
    return np.asarray(x, np.float64)


def close(got, want, tol):
    want = to_np(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(to_np(got), want, atol=tol * scale, rtol=0)


def jit_ref(fn, **static):
    """The reference's plain version, jitted: one compilation instead of one
    per operation."""
    import jax
    return jax.jit(functools.partial(fn, **static))


def windows(b_in, tw, g, seed):
    h, w = b_in + 2 * tw + 1, b_in + tw + 1
    rng = np.random.default_rng(seed)
    return rng.standard_normal((g, h, w)), np.arange(g) % 2 == 0
