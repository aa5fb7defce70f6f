"""The port's chase-cycle kernel and its plain version.

The plain version (``repro_torch.kernels.ref``) against the reference's
plain version and its Pallas kernel run in interpret mode, tape included, at
the reference's kernel-test tolerances (``tests/test_kernels.py``: fp32
3e-5, fp64 1e-12, bf16 8e-2, times the output's scale).  The CUDA kernel is
held against the plain version in ``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import DTYPES, close, jit_ref, pair, to_np, windows

from repro.kernels import bulge_chase as jkern
from repro.kernels import ref as jref
from repro_torch.kernels import bulge_chase as tkern
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

CHASE_SHAPES = [(4, 2, 3), (6, 2, 4), (8, 3, 5), (12, 4, 3), (16, 8, 2),
                (32, 8, 2), (5, 4, 6), (2, 1, 8)]


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b_in,tw,G", CHASE_SHAPES)
def test_chase_cycle_plain_matches_reference(b_in, tw, G, dtype, tol):
    x, first = windows(b_in, tw, G, b_in * 1000 + tw)
    jw, tt = pair(x, dtype)
    jf, tf = jnp.asarray(first), torch.from_numpy(first)
    want = jit_ref(jref.chase_cycle_ref, b_in=b_in, tw=tw, with_tape=True)(jw, jf)
    pallas = jkern.chase_cycle_pallas(jw, jf, b_in=b_in, tw=tw,
                                      interpret=True, with_tape=True)
    got = tref.chase_cycle_ref(tt, tf, b_in=b_in, tw=tw, with_tape=True)
    assert got[0].dtype == tt.dtype and got[1].shape == (G, 2, tw + 1)
    for ref in (want, pallas):
        for g_, r_ in zip(got, ref):
            close(g_, r_, tol)
    # ops sends a CPU tensor to the plain version; the kernel's wrapper
    # takes CUDA tensors only
    out = ops.chase_cycle(tt.clone(), tf, b_in=b_in, tw=tw)
    np.testing.assert_array_equal(to_np(out), to_np(got[0]))
    with pytest.raises(ValueError, match="CUDA"):
        tkern.chase_cycle_cuda(tt.clone(), tf, b_in=b_in, tw=tw)


@pytest.mark.parametrize("b_in,tw", [(6, 2), (12, 4)])
def test_zero_window_is_a_noop(b_in, tw):
    """Padding semantics: all-zero windows and blocks stay exactly zero and
    record tau = 0."""
    h, w = b_in + 2 * tw + 1, b_in + tw + 1
    first = torch.tensor([True, False, True])
    out, _, taus = tref.chase_cycle_ref(torch.zeros(3, h, w), first,
                                        b_in=b_in, tw=tw, with_tape=True)
    assert float(out.abs().max()) == 0.0 and float(taus.abs().max()) == 0.0
    blocks = torch.zeros(3, h, 2 * b_in + tw + 1, dtype=torch.float64)
    out = tref.chase_superstep_ref(blocks, first, torch.ones(3, 2, dtype=bool),
                                   b_in=b_in, tw=tw, fuse=2)
    assert float(out.abs().max()) == 0.0


def test_ops_dispatch_and_backend_rules():
    x, first = windows(8, 3, 4, 0)
    win = torch.from_numpy(x)
    tf = torch.from_numpy(first)
    a = ops.chase_cycle(win, tf, b_in=8, tw=3, backend="ref")
    b = ops.chase_cycle(win, tf, b_in=8, tw=3)           # auto on the CPU
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="CUDA"):
        ops.chase_cycle(win, tf, b_in=8, tw=3, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.chase_cycle(win, tf, b_in=8, tw=3, backend="nope")
    c = ops.chase_cycle(win, tf, b_in=8, tw=3, backend="fused_small")
    np.testing.assert_array_equal(a.numpy(), c.numpy())  # "ref" on the CPU


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_householder_matches_reference(dtype, tol):
    from repro.core import householder as jh
    from repro_torch.core import householder as th
    rng = np.random.default_rng(5)
    for x in (rng.standard_normal(7), np.r_[2.0, np.zeros(6)], np.zeros(7),
              np.r_[-1.5, rng.standard_normal(6)]):
        jx, tx = pair(x, dtype)
        jv, jtau, jbeta = jh.make_reflector(jx)
        tv, ttau, tbeta = th.make_reflector(tx)
        for got, want in ((tv, jv), (ttau, jtau), (tbeta, jbeta)):
            close(got, want, tol)
        assert (float(ttau) == 0.0) == (float(jtau) == 0.0)
    c = rng.standard_normal((7, 5))
    jc, tc = pair(c, dtype)
    close(th.apply_left(tv.to(tc.dtype), ttau, tc),
          jh.apply_left(jv, jtau, jc), tol)
    close(th.apply_right(tv.to(tc.dtype), ttau, tc.T.contiguous()),
          jh.apply_right(jv, jtau, jc.T), tol)
