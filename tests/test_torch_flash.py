"""The port's causal attention (``flash_attention_ref`` and
``ops.flash_attention`` on the CPU) against the reference's.

The reference's Pallas kernel cannot run here (interpret mode needs
``pl.load``, which this jax lacks), so the port is held against the
reference's plain ``kernels/ref.py::flash_attention_ref`` and its
``ops.flash_attention(backend="ref")``, on the reference kernel test's grid
(``tests/test_kernels.py``) at its tolerances: 3e-6 at fp32, 3e-2 at bf16,
absolute (the outputs are O(1)).  With grouped KV heads (k, v of BH / g
rows) the reference is given ``jnp.repeat(k, g, axis=0)``, the order of its
model's ``jnp.repeat(k, g, axis=2)`` once heads are flattened, and each
query row is held to its own size (``flash_attention.row_error`` within
``flash_attention.CHECK_TOLS``).  An emulation of the wgmma kernel's
arithmetic (P rounded to bf16 before P.V) is held to the same.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import pair, to_np

from repro.kernels import ops as jops
from repro.kernels.ref import flash_attention_ref as jflash_ref
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref

torch.set_num_threads(2)

# (bh, s, d, bq, bk) of the reference's kernel test
FLASH_SHAPES = [(4, 256, 64, 64, 64), (2, 128, 32, 32, 64),
                (2, 256, 64, 128, 32), (1, 64, 16, 64, 64),
                (3, 192, 64, 64, 32)]
TOLS = [("float32", 3e-6), ("bfloat16", 3e-2)]


def _qkv(bh, s, d, seed, dtype):
    rng = np.random.default_rng(seed)
    return [pair(rng.standard_normal((bh, s, d)), dtype) for _ in range(3)]


def _err(got, want) -> float:
    return float(np.max(np.abs(to_np(got) - to_np(want))))


@pytest.mark.parametrize("bh,s,d,bq,bk", FLASH_SHAPES)
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_flash_ref_matches_reference(bh, s, d, bq, bk, dtype, tol):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(bh, s, d, s + d, dtype)
    want = jflash_ref(jq, jk, jv)
    got = flash_attention_ref(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert _err(got, want) < tol
    # the op, with the reference's block keywords (ignored: the tile is the
    # kernel's own), against the reference's op on its "ref" backend
    got_op = ops.flash_attention(tq, tk, tv, block_q=bq, block_k=bk)
    want_op = jops.flash_attention(jq, jk, jv, backend="ref", block_q=bq,
                                   block_k=bk)
    assert _err(got_op, want_op) < tol


@pytest.mark.parametrize("bh,s,d", [(2, 100, 64), (3, 37, 16), (1, 1, 8),
                                    (2, 65, 128)])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_flash_ref_ragged_length(bh, s, d, dtype, tol):
    """Any S, as the reference's full-sequence attention takes (the Pallas
    wrapper's ``s % bq == 0`` comes from its static blocks)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(bh, s, d, 7 * s + d, dtype)
    assert _err(flash_attention_ref(tq, tk, tv), jflash_ref(jq, jk, jv)) < tol


def test_flash_attention_is_causal():
    """Perturbing future tokens must not change earlier outputs (the
    reference's ``test_flash_attention_is_causal``, on the port's op)."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 32))).float()
               for _ in range(3))
    o1 = ops.flash_attention(q, k, v, block_q=32, block_k=32)
    k2, v2 = k.clone(), v.clone()
    k2[:, 96:] += 5.0
    v2[:, 96:] += 5.0
    o2 = ops.flash_attention(q, k2, v2, block_q=32, block_k=32)
    np.testing.assert_allclose(o1[:, :96].numpy(), o2[:, :96].numpy(),
                               atol=1e-6)
    assert float((o1[:, 96:] - o2[:, 96:]).abs().max()) > 1e-3


def test_flash_on_cpu_runs_the_plain_version_and_the_kernel_raises():
    """``ops`` sends CPU tensors to the plain version, also under the
    "fused_small" backend, and launches nothing; the kernel's wrapper and
    the "cuda" backend take CUDA tensors only."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 70, 16))).float()
               for _ in range(3))
    before = ops.launch_counts()["flash_attention"]
    want = flash_attention_ref(q, k, v)
    for backend in ("auto", "ref", "fused_small"):
        torch.testing.assert_close(ops.flash_attention(q, k, v,
                                                       backend=backend),
                                   want, rtol=0, atol=0)
    assert ops.launch_counts()["flash_attention"] == before
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, backend="cuda")


# ---------------------------------------------------------------------------
# grouped KV heads, the rule that picks the kernel, and the wgmma arithmetic
# ---------------------------------------------------------------------------

def _grouped(bh_kv, g, s, d, seed, dtype):
    """q (bh_kv * g, s, d) and k, v (bh_kv, s, d) as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    q = pair(rng.standard_normal((bh_kv * g, s, d)), dtype)
    k, v = (pair(rng.standard_normal((bh_kv, s, d)), dtype) for _ in "kv")
    return q, k, v


def _row_err(got, want) -> float:
    return tflash.row_error(got, torch.from_numpy(to_np(want)))


@pytest.mark.parametrize("g", [1, 2, 4, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_flash_ref_matches_reference_on_repeated_kv(g, dtype):
    """Query row bh reads KV row bh // g: the reference on
    ``jnp.repeat(k, g, axis=0)`` (its model's head order, flattened)."""
    (jq, tq), (jk, tk), (jv, tv) = _grouped(2, g, 70, 32, 11 * g, dtype)
    want = jflash_ref(jq, jnp.repeat(jk, g, axis=0), jnp.repeat(jv, g, axis=0))
    tol = tflash.CHECK_TOLS[dtype]
    got = flash_attention_ref(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert _row_err(got, want) <= tol
    assert _row_err(ops.flash_attention(tq, tk, tv), want) <= tol


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float16, 64, "wgmma"), (torch.float16, 128, "wgmma"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 96, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float16, 16, "simt"), (torch.float16, 256, "simt")])
def test_kernel_for_routes_by_dtype_and_head_width(dtype, d, kernel):
    """bf16 and fp16 at D in {64, 128} go to the wgmma kernel; fp32 (no
    tensor-core route at fp32 precision) and every other D to
    ``flash_attn.cu``."""
    assert tflash.kernel_for(dtype, d) == kernel


def test_kv_rows_must_divide_query_rows():
    """k, v whose rows do not divide q's, or whose (S, D) differ, raise
    ``ValueError`` on the CPU path (and in both wrappers, which share the
    check)."""
    q = torch.zeros(8, 16, 32)
    for k in (torch.zeros(3, 16, 32), torch.zeros(16, 16, 32),
              torch.zeros(0, 16, 32)):
        with pytest.raises(ValueError, match="do not divide"):
            ops.flash_attention(q, k, k)
        with pytest.raises(ValueError, match="do not divide"):
            flash_attention_ref(q, k, k)
    with pytest.raises(ValueError, match="must be q's"):
        ops.flash_attention(q, torch.zeros(4, 15, 32), torch.zeros(4, 15, 32))
    with pytest.raises(ValueError, match="expected q"):
        ops.flash_attention(q, torch.zeros(4, 16, 32), torch.zeros(2, 16, 32))


def _emulate_wgmma(q, k, v):
    """The arithmetic of ``csrc/flash_attn_wgmma.cu`` on the CPU: 128-row
    query tiles against 128-key tiles up to the diagonal, Q.K^T of the
    16-bit inputs summed in fp32, scores times log2(e)/sqrt(D) and exp2,
    the online max and rescale, P rounded to the storage type before P.V,
    P.V summed in fp32, l summed from the fp32 P, one rounding at the
    store."""
    bh, s, d = q.shape
    g = bh // k.shape[0]
    qf = q.float()
    kf, vf = (x.repeat_interleave(g, dim=0).float() for x in (k, v))
    sl2 = math.log2(math.e) / math.sqrt(d)
    out = torch.empty(bh, s, d)
    for q0 in range(0, s, 128):
        rows = torch.arange(q0, min(q0 + 128, s))
        m = torch.full((bh, len(rows)), -1e30)
        l = torch.zeros(bh, len(rows))
        acc = torch.zeros(bh, len(rows), d)
        for k0 in range(0, q0 + 1, 128):
            cols = torch.arange(k0, min(k0 + 128, s))
            sc = qf[:, rows] @ kf[:, cols].mT
            sc = sc.masked_fill(cols[None, :] > rows[:, None], -math.inf)
            m_new = torch.maximum(m, sc.amax(-1) * sl2)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(sc * sl2 - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p.to(q.dtype).float() @ vf[:, cols]
            m = m_new
        out[:, rows] = acc / l[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("s", [1, 127, 129, 300])
def test_wgmma_arithmetic_within_the_bf16_tolerance(s):
    """Rounding P to bf16 before P.V, where the reference keeps it in fp32,
    costs less than the reference's bf16 tolerance at the LM's head width
    (D = 128, g = 4)."""
    (jq, tq), (jk, tk), (jv, tv) = _grouped(2, 4, s, 128, s, "bfloat16")
    want = jflash_ref(jq, jnp.repeat(jk, 4, axis=0), jnp.repeat(jv, 4, axis=0))
    got = _emulate_wgmma(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    assert _row_err(got, want) <= tflash.CHECK_TOLS["bfloat16"]
