"""Helpers shared by the port's test files (``test_torch_*.py``).

Imports no JAX at module level: ``test_torch_kernels.py`` uses it on the
card, where JAX is not installed."""

import functools

import numpy as np
import pytest
import torch

# the reference's kernel-test tolerances (tests/test_kernels.py), times scale
DTYPES = [("float32", 3e-5), ("float64", 1e-12), ("bfloat16", 8e-2)]


def wy_tol(dtype: str, tol: float, k: int) -> float:
    """Tolerance of the compact-WY apply, times the output's scale: the
    reference's ``tol * max(1, k // 4)`` at fp64 and fp32; at bf16, where
    both sides accumulate in fp32 and round once at the store, 1e-2 (a
    bf16 ulp of the scale is at most 2**-7) whatever k."""
    return 1e-2 if dtype == "bfloat16" else tol * max(1, k // 4)


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def deflation_runs(p, m, chunk, seed, dtype, device="cpu"):
    """P rows of a merge's columns for the Givens scan, built around steps
    of ``chunk`` (the kernel's chunk starts 1 + k * chunk): near-equal
    poles in runs across chunk starts, one run longer than two chunks, the
    columns past 7/8 of m deflated; at the last chunk start b before them,
    step b - 1 merges a light column into a heavy carry, so a run from
    column b - 1 as it came in merges at b where the true one (from the
    heavy carry, 1e-5 away) does not; the third row's flags are not a
    prefix.  (d, z, fe, le, active, tol) as tensors of ``dtype``."""
    rng = np.random.default_rng(seed)
    d = np.sort(rng.standard_normal((p, m)), -1)
    tail = m - m // 8
    starts = [b for b in range(1 + chunk, tail - 1, chunk) if b >= 3]
    runs = [(b - 2, b + 2) for b in starts[:-1][::max(2, 8 // chunk)]]
    runs.append((m // 8 + 1, m // 8 + 2 * chunk + 4))
    runs.append((m - 6, m - 2))
    for s, e in runs:
        e = min(e, m)
        d[:, s:e] = d[:, s:s + 1] + 1e-13 * np.arange(e - s)
    d = np.sort(d, -1)
    z = rng.standard_normal((p, m)) * 10.0 ** rng.integers(-3, 1, (p, m))
    if starts:
        b = starts[-1]
        d[:, b - 3:b] = d[:, b - 3:b - 2] + 1e-13 * np.arange(3)
        d[:, b] = d[:, b - 3] + 1e-5
        z[:, b - 3:b + 1] = [1.0, 1.0, 1e-9, 1.0]
    act = np.repeat(np.arange(m)[None, :] < tail, p, 0)
    if p > 2:
        act[2] &= rng.random(m) < 0.9
    to = lambda x: torch.from_numpy(x).to(device, dtype)  # noqa: E731
    return (to(d), to(z), to(rng.standard_normal((p, m))),
            to(rng.standard_normal((p, m))),
            torch.from_numpy(act).to(device), to(np.full(p, 1e-6)))


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


def check_svd(a, u, s, vt, tol):
    """Reconstruction, orthogonality and descending order, in fp64."""
    a, u, s, vt = (np.asarray(x, np.float64) for x in (a, u, s, vt))
    n = a.shape[-1]
    scale = max(1.0, float(np.max(s)))
    recon = np.abs(np.einsum("...ij,...j,...jk->...ik", u, s, vt) - a).max()
    uerr = np.abs(np.einsum("...ji,...jk->...ik", u, u) - np.eye(n)).max()
    verr = np.abs(np.einsum("...ij,...kj->...ik", vt, vt) - np.eye(n)).max()
    assert recon < tol * scale, ("reconstruction", recon)
    assert uerr < tol, ("U orthogonality", uerr)
    assert verr < tol, ("V orthogonality", verr)
    assert np.all(np.diff(s, axis=-1) <= 1e-12 * scale), "sigma not descending"


def agree(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=tol * max(1.0, np.abs(want).max()),
                               rtol=0)


def flat_params(tree, prefix: str = "") -> dict:
    """A nested dict of arrays (the reference's parameter tree) as
    ``{path: numpy array}``, the path its keys joined by "."."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat_params(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


# the reference's architectures, whose smoke configs the LM tests compare:
# the dense decoders, and the other families (moe, hymba, rwkv, encdec)
DENSE_ARCHS = ["llama3-8b", "granite-3-2b", "codeqwen1.5-7b",
               "phi3-medium-14b", "pixtral-12b"]
FAMILY_ARCHS = ["deepseek-moe-16b", "granite-moe-3b-a800m", "hymba-1.5b",
                "rwkv6-1.6b", "whisper-medium"]
LM_ARCHS = DENSE_ARCHS + FAMILY_ARCHS


def _perturbed(tree, rng):
    """The tree with every leaf that is constant at init moved by N(0, 0.1):
    the norm gains and biases, rwkv's ``mu``, ``w_b``, ``u``, ``w0`` (the
    token-shift lerps and the LoRA decay), mamba's ``a_log``, ``d_skip``,
    ``dt_bias``, ``conv_b``."""
    import jax.numpy as jnp
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _perturbed(val, rng)
        elif np.all(np.asarray(val) == np.asarray(val).flat[0]):
            out[key] = val + jnp.asarray(
                0.1 * rng.standard_normal(val.shape), val.dtype)
        else:
            out[key] = val
    return out


@functools.lru_cache(maxsize=None)
def lm_models(arch: str):
    """(reference model, its params, the port's model holding them) of the
    smoke config of ``arch``, on the CPU.  Every leaf constant at init (norm
    gains, biases, rwkv's and mamba's constant leaves) is moved off its
    constant, so that those paths count."""
    import jax

    from repro.configs.base import smoke_of as jsmoke_of
    from repro.models import build as jbuild
    from repro_torch.configs import smoke_of
    from repro_torch.convert import model_params_from_reference
    jm = jbuild(jsmoke_of(arch))
    params = _perturbed(jm.init(jax.random.PRNGKey(1)),
                        np.random.default_rng(2))
    tm = model_params_from_reference(flat_params(params), smoke_of(arch),
                                     device="cpu")
    return jm, params, tm
