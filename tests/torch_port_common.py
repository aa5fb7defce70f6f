"""Helpers shared by the port's test files (``test_torch_*.py``).

Imports no JAX at module level: ``test_torch_kernels.py`` uses it on the
card, where JAX is not installed."""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core import bidiag_dc as tdc
from repro_torch.core.tuning import DC_FALLBACK_ITERS

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


def bisect_descend(j, lo, hi):
    """The brackets of nodes j (heap order, >= 1) under [lo, hi]: the
    halvings of each node's path, top bit first, as ``descend`` in
    ``csrc/sturm_device.cuh`` makes them (the Sturm kernels' and the dc
    leaves' bisection schedule)."""
    depth = torch.floor(torch.log2(j.double())).long()
    for i in range(int(depth.max()) if j.numel() else 0):
        pos = depth - 1 - i
        on = pos >= 0
        bit = (j >> pos.clamp(min=0)) & 1
        mid = 0.5 * (lo + hi)
        lo = torch.where(on & (bit == 1), mid, lo)
        hi = torch.where(on & (bit == 0), mid, hi)
    return lo, hi


def bisect_walk(lo, hi, counts_of, levels, n, k):
    """Down ``levels`` levels of a counted tree from [lo, hi], each k by its
    own path: node jj's count is ``counts_of(jj)``."""
    jj = torch.ones_like(k).expand_as(lo).clone()
    for _ in range(levels):
        mid = 0.5 * (lo + hi)
        left = counts_of(jj) - n >= k
        hi = torch.where(left, mid, hi)
        lo = torch.where(left, lo, mid)
        jj = 2 * jj + (~left).long()
    return lo, hi


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


def leaf_factor(a, b, lam, tg):
    """The leaf kernel's factors of T - lam I for every (leaf, index):
    multipliers (lm - 1, P, K) and reciprocal pivots (lm, P, K), pivots
    guarded at tg (P, 1)."""
    lm = a.shape[-1]
    cs = a.new_empty((lm - 1,) + lam.shape)
    rs = a.new_empty((lm,) + lam.shape)
    r = 1 / tdc._guard(a[:, :1] - lam, tg)
    rs[0] = r
    for i in range(1, lm):
        bi = b[:, i - 1, None]
        c = bi * r
        r = 1 / tdc._guard((a[:, i, None] - lam) - bi * c, tg)
        cs[i - 1], rs[i] = c, r
    return cs, rs


def leaf_apply(cs, rs, b, x):
    """x (P, K, lm) = (T - lam I)^-1 x from ``leaf_factor``'s factors."""
    lm = x.shape[-1]
    ys = [x[..., 0] * rs[0]]
    for i in range(1, lm):
        ys.append((x[..., i] - b[:, i - 1, None] * ys[-1]) * rs[i])
    out = [ys[-1]]
    for i in range(lm - 2, -1, -1):
        out.append(ys[i] - cs[i] * out[-1])
    return torch.stack(out[::-1], -1)


def gram_schmidt_by_runs_model(a, b, lam, ctol, x0, *, inv_iters):
    """``dc_leaf_kernel`` after its bisection, in plain torch: inverse
    iteration with T - lam_k I factored once (reciprocal pivots); a vector
    with no earlier eigenvalue within ctol normalised once more; then each
    cluster run (consecutive gaps below ctol) in k order, vector k less its
    projections on its window (the earlier vectors of the run within ctol
    of lam_k, classical Gram-Schmidt), and where that leaves less than
    0.01, e_k projected and taken through DC_FALLBACK_ITERS steps of
    inverse iteration with vector k's factors, each projected again and
    normalised.  Returns f, l (P, lm), the vectors (P, lm, lm), row k
    vector k, and the collapses per leaf."""
    p, lm = a.shape
    tiny = torch.finfo(a.dtype).tiny
    eps = torch.finfo(a.dtype).eps
    tg = (eps * torch.maximum(a.abs().amax(-1), b.abs().amax(-1)).clamp(
        min=1))[:, None]
    cs, rs = leaf_factor(a, b, lam, tg)

    def unit(w):
        return w * (1 / torch.linalg.vector_norm(
            w, dim=-1, keepdim=True).clamp(min=tiny))

    vec = x0.expand(p, lm, lm).clone()
    for _ in range(inv_iters):
        vec = unit(leaf_apply(cs, rs, b, vec))
    alone = torch.zeros((p, lm), dtype=torch.bool)
    alone[:, 1:] = ~(lam[:, 1:] - lam[:, :-1] < ctol[:, None])
    vec = torch.where(alone[..., None], unit(vec), vec)
    collapses = [0] * p
    for q in range(p):
        lq, ct = lam[q], ctol[q]
        r0 = 0
        while r0 < lm:
            r1 = r0 + 1
            while r1 < lm and bool(lq[r1] - lq[r1 - 1] < ct):
                r1 += 1
            for k in range(r0 + 1, r1):
                jw = k
                while jw > r0 and bool(lq[k] - lq[jw - 1] < ct):
                    jw -= 1
                win = vec[q, jw:k].clone()

                def clean(v, win=win):
                    return v - (win @ v) @ win

                w = clean(vec[q, k])
                if not bool(torch.linalg.vector_norm(w) > 0.01):
                    collapses[q] += 1
                    w = clean(torch.eye(lm, dtype=a.dtype)[k])
                    for _ in range(DC_FALLBACK_ITERS):
                        y = leaf_apply(cs[:, q:q + 1, k:k + 1],
                                        rs[:, q:q + 1, k:k + 1], b[q:q + 1],
                                        unit(w)[None, None])
                        w = clean(y[0, 0])
                vec[q, k] = unit(w)
            r0 = r1
    return vec[:, :, 0], vec[:, :, -1], vec, collapses
