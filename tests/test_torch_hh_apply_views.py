"""The compact-WY apply's in-place addressing, on the CPU.

``ops.tape_apply`` on the plain backend with strided views of V and C (as
stage 1 and its replay pass them) and with a row table into an
accumulator (as the chase replay passes it), against the reference
composed the same way: gather, then ``tape_apply_pallas(interpret=True)``
and ``jref.tape_apply_ref``, then scatter.  The reference's shapes
(``tests/test_kernels.py`` ``WY_SHAPES``), fp64, fp32 and bf16, at
``wy_tol`` (fp32 3e-5 and fp64 1e-12 times the output's scale and
max(1, k // 4); bf16 1e-2 of the scale).  Then stage 1, which now applies
its QR update to the trailing block only, against the reference's
``band_reduce`` at ``tests/test_torch_stage1.py``'s 1e-12, and the launch
plans of the CUDA kernels (``hh_apply.launch_shape``).  The CUDA kernels
themselves are held to the plain version in ``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import DTYPES, close, jit_ref, pair, wy_tol

from repro.core import stage1 as js1
from repro.kernels import hh_apply as jhh
from repro.kernels import ref as jref
from repro_torch.core import stage1 as ts1
from repro_torch.core.tuning import SMEM_PER_BLOCK
from repro_torch.kernels import hh_apply as thh
from repro_torch.kernels import ops

torch.set_num_threads(2)

WY_SHAPES = [(64, 8, 100), (128, 16, 64), (33, 4, 7), (256, 32, 512),
             (16, 1, 5)]


def wy(rng, s, m, k):
    """A unit-lower-trapezoidal V and an upper-triangular T (times 0.2) per
    slot, as the reference's kernel test makes them."""
    v = np.tril(rng.standard_normal((s, m, k)), -1)
    v[:, np.arange(k), np.arange(k)] = 1.0
    return v, np.triu(rng.standard_normal((s, k, k))) * 0.2


def reference(jv, jt, jc):
    """The reference's plain version and its Pallas kernel (interpret
    mode) on gathered slots."""
    return (jit_ref(jref.tape_apply_ref)(jv, jt, jc),
            jhh.tape_apply_pallas(jv, jt, jc, interpret=True, block_cols=64))


@pytest.mark.parametrize("slots", [1, 5])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("m,k,w", WY_SHAPES)
def test_strided_views_match_reference(m, k, w, dtype, tol, slots):
    """V and C as views into larger tensors, offset in rows and columns (a
    row stride other than the width, the innermost stride 1), the result
    written back into C's view, as stage 1 does with its trailing block."""
    rng = np.random.default_rng(m * k + w + slots)
    r0, c0 = 3, 5
    v, t = wy(rng, slots, m, k)
    vpar = rng.standard_normal((slots, r0 + m, k + 2))
    vpar[:, r0:, :k] = v
    cpar = rng.standard_normal((slots, r0 + m + 2, c0 + w + 3))
    (jvp, tvp), (jt, tt), (jcp, tcp) = (pair(x, dtype)
                                        for x in (vpar, t, cpar))
    tv, tc = tvp[:, r0:, :k], tcp[:, r0:r0 + m, c0:c0 + w]
    assert not tv.is_contiguous() and not tc.is_contiguous()
    assert tv.stride(-1) == 1 and tc.stride(-1) == 1
    out = ops.tape_apply(tv, tt, tc)
    assert out.shape == tc.shape and out.dtype == tc.dtype
    tc.copy_(out)
    jv, jc = jvp[:, r0:, :k], jcp[:, r0:r0 + m, c0:c0 + w]
    for want in reference(jv, jt, jc):
        close(tcp, jcp.at[:, r0:r0 + m, c0:c0 + w].set(want),
              wy_tol(dtype, tol, k))


@pytest.mark.parametrize("b,spm", [(1, 1), (5, 1), (1, 5), (2, 3)])
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("m,k,w", WY_SHAPES)
def test_row_table_matches_reference(m, k, w, dtype, tol, b, spm):
    """Slot s applies to rows ``rows[s % spm]`` of matrix ``s // spm`` of an
    accumulator (b, R, w), in place: the rows of a matrix's slots are
    disjoint, and the rows no slot names stay as they were."""
    rng = np.random.default_rng(m + k * w + b * spm)
    s = b * spm
    r_acc = spm * m + 7
    v, t = wy(rng, s, m, k)
    acc = rng.standard_normal((b, r_acc, w))
    rows = rng.permutation(r_acc)[:spm * m].reshape(spm, m)
    (jv, tv), (jt, tt), (jacc, tacc) = (pair(x, dtype) for x in (v, t, acc))
    table = torch.from_numpy(rows).to(torch.int32)
    before = tacc.clone()
    got = ops.tape_apply(tv, tt, tacc, rows=table)
    assert got is tacc
    free = np.setdiff1d(np.arange(r_acc), rows.ravel())
    assert torch.equal(tacc[:, free], before[:, free])
    sl = jacc[:, rows].reshape(s, m, w)
    for want in reference(jv, jt, sl):
        close(tacc, jacc.at[:, rows].set(want.reshape(b, spm, m, w)),
              wy_tol(dtype, tol, k))


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("n,nb", [(40, 6), (17, 16), (64, 8)])
def test_band_reduce_trailing_block_matches_reference(n, nb, lead):
    """Stage 1 with its QR update on the trailing block only: the band and
    the tape agree with the reference's within 1e-12."""
    a = np.random.default_rng(n + nb).standard_normal(lead + (n, n))
    want, want_tape = js1.band_reduce(jnp.asarray(a), nb=nb, backend="ref",
                                      tape=True)
    got, tape = ts1.band_reduce(torch.from_numpy(a), nb=nb, backend="ref",
                                tape=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12,
                               rtol=0)
    for g, w in zip(tape, want_tape):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12,
                                   rtol=0)


def test_stage1_applies_to_the_trailing_block(monkeypatch):
    """Each QR update gets the rows from the panel's first pivot and the
    columns right of the panel, a view of the padded matrix, and V's rows
    from that pivot: nothing left of or above the block is read or
    restored."""
    seen = []
    plain = ops._REGISTRY["ref"]["hh_block_apply"]

    def spy(v, t, c):
        seen.append((tuple(v.shape), tuple(c.shape), c.is_contiguous()))
        return plain(v, t, c)

    monkeypatch.setitem(ops._REGISTRY["ref"], "hh_block_apply", spy)
    n, nb = 33, 8
    big = (4 + 2) * nb                       # 4 panels, padded
    a = np.random.default_rng(1).standard_normal((n, n))
    ts1.band_reduce(torch.from_numpy(a), nb=nb, backend="ref")
    assert seen == [((1, big - p * nb, nb), (1, big - p * nb,
                                            big - (p + 1) * nb), False)
                    for p in range(4)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("m", [0, 1, 16, 64, 65, 4224])
def test_launch_shape_fits_and_splits(m, dtype):
    """For every k the kernels take: the path follows m and k, every
    kernel's shared memory fits a block, and the large-m path's splits
    cover the m rows in whole ring stages with scratch rows padded to 128
    columns (an empty operand, m = 0, gets a plan too: the last LQ panel's
    replay has no rows below its pivot)."""
    for k in range(1, thh.MAX_K + 1):
        for w in (1, 7, 4224):
            p = thh.launch_shape(m, k, w, dtype)
            assert max(p.smem) <= SMEM_PER_BLOCK
            small = m <= thh.SMALL_M and k <= thh.SMALL_K
            assert (p.path, p.kernels) == (("small", 1) if small
                                           else ("large", 3))
            if small:
                continue
            assert p.kp in thh.KP_CLASSES and p.kp >= k
            assert p.rows_per_split % thh.W1_TK == 0
            assert (p.nsplit - 1) * p.rows_per_split < max(m, 1)
            assert m <= p.nsplit * p.rows_per_split
            assert p.wp % 128 == 0 and p.wp >= w
