"""The port's ``banded_svd``, and its full SVD on clustered and orthogonal
spectra, on the CPU at fp64, with inputs made by numpy from fixed seeds.

``banded_svd`` against the reference's: U and V^T within 1e-9, sigma within
1e-12 * sigma_max, sigma bit-identical to ``banded_singular_values``;
reconstruction and orthogonality below 1e-10, the bounds of
``tests/test_transforms.py``, whose degenerate spectra are repeated here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import agree, check_svd

from repro.core import svd as jsvd
from repro.core.tuning import PipelineConfig as JConfig
from repro_torch.core import svd as tsvd
from repro_torch.core.tuning import PipelineConfig

torch.set_num_threads(2)


def cpu_config(bw, tw, fuse=1):
    return PipelineConfig.resolve(bw=bw, tw=tw, dtype=torch.float64,
                                  fuse=fuse, device="cpu")


@pytest.mark.parametrize("fuse", [1, 4])
def test_banded_svd_matches_reference(fuse):
    n, bw, tw = 40, 6, 2
    a = np.triu(np.random.default_rng(9).standard_normal((n, n)))
    a = a - np.triu(a, bw + 1)
    jcfg = JConfig.resolve(bw=bw, tw=tw, backend="ref", dtype=np.float64, n=n,
                           fuse=fuse)
    u_j, s_j, vt_j = jsvd.banded_svd(jnp.asarray(a), config=jcfg)
    cfg = cpu_config(bw, tw, fuse)
    u, s, vt = tsvd.banded_svd(a, config=cfg, check=True)
    agree(s, s_j, 1e-12)
    agree(u, u_j, 1e-9)
    agree(vt, vt_j, 1e-9)
    check_svd(a, u, s, vt, 1e-10)
    assert torch.equal(s, tsvd.banded_singular_values(a, config=cfg))
    assert torch.equal(tsvd.banded_svd(a, config=cfg, compute_uv=False), s)


@pytest.mark.parametrize("case", ["identity", "orthogonal", "repeated",
                                  "near-degenerate", "rank-deficient",
                                  "zero"])
def test_svd_degenerate_spectra(case):
    """Repeated and clustered sigma: the cluster reorthogonalization and
    the u = Bv/||Bv|| re-pairing must still give a valid SVD, as in the
    reference's ``test_svd_degenerate_spectra``."""
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.standard_normal((8, 8)))
    lowrank = rng.standard_normal((8, 3)) @ rng.standard_normal((3, 8))
    a = {"identity": np.eye(8), "orthogonal": q,
         "repeated": np.diag([3.0, 2.0, 2.0, 1.0]),
         "near-degenerate": np.diag([1.0, 1.0 + 1e-9, 0.5, 0.3]),
         "rank-deficient": lowrank, "zero": np.zeros((6, 6))}[case]
    n = a.shape[0]
    bw = max(2, n // 4)
    tw = max(1, bw // 2)
    u, s, vt = tsvd.svd(a, bw=bw, tw=tw, device="cpu")
    check_svd(a, u, s, vt, 1e-10)
    s0 = np.linalg.svd(a, compute_uv=False)
    np.testing.assert_allclose(s.numpy(), s0, atol=1e-9 * max(s0[0], 1))
