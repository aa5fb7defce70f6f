"""Packed band storage of the port against the reference (exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import band as jband
from repro_torch.core import band as tband

torch.set_num_threads(2)

CASES = [(1, 8, 1, 1), (1, 20, 5, 2), (3, 20, 5, 2), (2, 33, 7, 3),
         (1, 64, 8, 4), (4, 17, 1, 1), (2, 9, 8, 8)]


def _banded(lead, n, bw, seed):
    a = np.random.default_rng(seed).standard_normal(lead + (n, n))
    return np.triu(a) - np.triu(a, bw + 1)


@pytest.mark.parametrize("B,n,bw,tw", CASES)
def test_pack_unpack_extract_match_reference(B, n, bw, tw):
    mats = _banded((B,), n, bw, n + bw)
    ref = np.array(jband.pack(jnp.asarray(mats), bw, tw))
    got = tband.pack(torch.from_numpy(mats), bw, tw).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (B, tband.band_height(bw, tw), n)

    padded = np.array(jband.pad_columns(jnp.asarray(ref), 5))
    got_p = tband.pad_columns(torch.from_numpy(ref), 5).numpy()
    np.testing.assert_array_equal(got_p, padded)

    back_ref = np.array(jband.unpack(jnp.asarray(padded), bw, tw, n))
    back = tband.unpack(torch.from_numpy(padded), bw, tw, n).numpy()
    np.testing.assert_array_equal(back, back_ref)
    np.testing.assert_array_equal(back, mats)

    for k in (0, 1):
        d_ref = np.array(jband.band_extract_diag(jnp.asarray(ref), tw, k, n))
        d = tband.band_extract_diag(torch.from_numpy(ref), tw, k, n).numpy()
        np.testing.assert_array_equal(d, d_ref)


def test_pack_unbatched_and_float32():
    a = _banded((), 24, 5, 3).astype(np.float32)
    ref = np.array(jband.pack(jnp.asarray(a), 5, 2))
    got = tband.pack(torch.from_numpy(a), 5, 2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
