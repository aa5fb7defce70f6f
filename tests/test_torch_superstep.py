"""The port's chase-superstep kernel (K cycles per launch) and its plain
version.

The plain version against the reference's plain version and its Pallas
kernel in interpret mode, tape included, at the reference's kernel-test
tolerances.  The CUDA kernel is held against the plain version in
``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import DTYPES, close, jit_ref, pair

from repro.kernels import bulge_chase as jkern
from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

SUPER_SHAPES = [(4, 2, 3), (8, 3, 4), (5, 4, 3)]
FUSES = [2, 4]


def _superstep_inputs(b_in, tw, G, fuse, dtype):
    h, wk = b_in + 2 * tw + 1, fuse * b_in + tw + 1
    rng = np.random.default_rng(b_in * 100 + tw * 10 + fuse)
    x = rng.standard_normal((G, h, wk))
    first = np.arange(G) % 2 == 0
    n_live = rng.integers(0, fuse + 1, size=G)      # a prefix mask per slot
    n_live[0] = fuse
    active = np.arange(fuse)[None, :] < n_live[:, None]
    jb, tb = pair(x, dtype)
    return ((jb, jnp.asarray(first), jnp.asarray(active)),
            (tb, torch.from_numpy(first), torch.from_numpy(active)))


@pytest.mark.parametrize("fuse", FUSES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b_in,tw,G", SUPER_SHAPES)
def test_chase_superstep_plain_matches_reference(b_in, tw, G, dtype, tol,
                                                 fuse):
    args_j, args_t = _superstep_inputs(b_in, tw, G, fuse, dtype)
    kw = dict(b_in=b_in, tw=tw, fuse=fuse, with_tape=True)
    want = jit_ref(jref.chase_superstep_ref, **kw)(*args_j)
    pallas = jkern.chase_superstep_pallas(*args_j, interpret=True, **kw)
    got = tref.chase_superstep_ref(*args_t, **kw)
    assert got[1].shape == (G, fuse, 2, tw + 1) and got[2].shape == (G, fuse, 2)
    for ref in (want, pallas):
        for g_, r_ in zip(got, ref):
            close(g_, r_, tol)
