"""The port's compact-WY apply (plain version) against the reference.

``tape_apply_ref`` / ``hh_block_apply_ref`` of ``repro_torch.kernels.ref``
against the reference's plain versions and its Pallas kernel run in
interpret mode, at the reference's shapes (``tests/test_kernels.py``
``WY_SHAPES``) with S in {1, 5} slots, at its tolerance: fp32 3e-5 and fp64
1e-12 times the output's scale and max(1, k // 4); bf16 1e-2 times the
scale, about one bf16 ulp, since every side rounds once at the end
(``wy_tol``).  The CUDA kernel is held against the plain version in
``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import DTYPES, close, jit_ref, pair, wy_tol

from repro.kernels import hh_apply as jhh
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

WY_SHAPES = [(64, 8, 100), (128, 16, 64), (33, 4, 7), (256, 32, 512),
             (16, 1, 5)]


def wy(s, m, k, w, seed):
    rng = np.random.default_rng(seed)
    v = np.tril(rng.standard_normal((s, m, k)), -1)
    v[:, np.arange(k), np.arange(k)] = 1.0
    t = np.triu(rng.standard_normal((s, k, k))) * 0.2
    return v, t, rng.standard_normal((s, m, w))


@pytest.mark.parametrize("slots", [1, 5])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("m,k,w", WY_SHAPES)
def test_tape_apply_plain_matches_reference(m, k, w, dtype, tol, slots):
    (jv, tv), (jt, tt), (jc, tc) = (pair(x, dtype)
                                    for x in wy(slots, m, k, w, m + k + w))
    want = jit_ref(jref.tape_apply_ref)(jv, jt, jc)
    pallas = jhh.tape_apply_pallas(jv, jt, jc, interpret=True, block_cols=64)
    got = tref.tape_apply_ref(tv, tt, tc)
    assert got.dtype == tc.dtype and got.shape == tc.shape
    for ref in (want, pallas):
        close(got, ref, wy_tol(dtype, tol, k))
    one = tref.hh_block_apply_ref(tv[0], tt[0], tc[0])
    close(one, jref.hh_block_apply_ref(jv[0], jt[0], jc[0]),
          wy_tol(dtype, tol, k))
    # ops sends CPU tensors to the plain versions, bit for bit; the block
    # apply takes the leading axes as slots
    np.testing.assert_array_equal(ops.tape_apply(tv, tt, tc).float().numpy(),
                                  got.float().numpy())
    np.testing.assert_array_equal(
        ops.hh_block_apply(tv, tt, tc).float().numpy(), got.float().numpy())
    np.testing.assert_array_equal(
        ops.hh_block_apply(tv[0], tt[0], tc[0]).float().numpy(),
        one.float().numpy())


def test_identity_and_zero_tau():
    """tau = 0 (the chase tape's inactive slots) leaves C exactly as it
    was; V = e_0, T = 2 flips the sign of C's first row."""
    _, _, c = wy(4, 9, 1, 6, 1)
    c = torch.from_numpy(c)
    v = torch.zeros(4, 9, 1, dtype=torch.float64)
    v[:, 0] = 1.0
    assert torch.equal(tref.tape_apply_ref(v, torch.zeros(4, 1, 1,
                                                          dtype=c.dtype), c),
                       c)
    out = tref.tape_apply_ref(v, torch.full((4, 1, 1), 2.0,
                                            dtype=c.dtype), c)
    assert torch.equal(out[:, 0], -c[:, 0]) and torch.equal(out[:, 1:],
                                                            c[:, 1:])
    assert jnp.allclose(jref.tape_apply_ref(jnp.asarray(v.numpy()),
                                            jnp.full((4, 1, 1), 2.0),
                                            jnp.asarray(c.numpy())),
                        out.numpy())
