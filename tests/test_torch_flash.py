"""The port's causal attention (``flash_attention_ref`` and
``ops.flash_attention`` on the CPU) against the reference's.

The reference's Pallas kernel cannot run here (interpret mode needs
``pl.load``, which this jax lacks), so the port is held against the
reference's plain ``kernels/ref.py::flash_attention_ref`` and its
``ops.flash_attention(backend="ref")``, on the reference kernel test's grid
(``tests/test_kernels.py``) at its tolerances: 3e-6 at fp32, 3e-2 at bf16,
absolute (the outputs are O(1)).
"""

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
