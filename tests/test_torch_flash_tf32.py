"""The arithmetic of ``flash_attn.cu`` (3xTF32 products), emulated in torch
on the CPU, against the reference's plain ``flash_attention_ref``.

Each fp32 operand, and the softmax weights P, is split into hi = x rounded
to TF32 (10 mantissa bits, to nearest, ties away from zero: ``cvt.rna``)
and lo = (x - hi) rounded to TF32; a product is lo*hi + hi*lo + hi*hi with
fp32 sums, as the tensor cores form it (a TF32 product is exact in fp32).
With the three terms every query row lies within
``flash_attention.CHECK_TOLS["float32"]`` (1e-5) of its own size from the
reference (``flash_attention.row_error``); with the hi*hi term alone
(1xTF32) every case lies above it, which is why the kernel carries the lo
terms.
"""

import numpy as np
import pytest
import torch
from torch_port_common import pair

from repro.kernels.ref import flash_attention_ref as jflash_ref
from repro_torch.kernels import flash_attention as tflash

torch.set_num_threads(2)

# (bh, s, d) of the reference's kernel test, and a ragged S at D = 40
SHAPES = [(4, 256, 64), (2, 128, 32), (1, 64, 16), (3, 192, 64),
          (2, 100, 40)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32, to nearest with ties away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b on TF32 parts with fp32 sums: 3 terms (3xTF32) or 1."""
    a_hi, b_hi = tf32(a), tf32(b)
    out = a_hi @ b_hi
    if terms == 3:
        a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
        out = a_lo @ b_hi + a_hi @ b_lo + out
    return out


def flash_tf32_emulated(q, k, v, terms: int) -> torch.Tensor:
    """Causal attention of fp32 q, k, v (BH, S, D) as the kernel computes
    it: scores on the TF32 parts, scaled by 1/sqrt(D), masked, an
    unnormalised softmax in fp32, P V on the TF32 parts, divided by the
    row sums."""
    s_len, d = q.shape[1], q.shape[2]
    scores = _mm(q, k.transpose(1, 2), terms) * (1.0 / d ** 0.5)
    future = torch.ones((s_len, s_len), dtype=torch.bool).triu(1)
    scores = scores.masked_fill(future, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    return _mm(p, v, terms) / p.sum(-1, keepdim=True)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11,
                      -(1 + 2.0 ** -11), 3.0e-30, 1 + 2.0 ** -12])
    want = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -10,
                         1 + 2 * 2.0 ** -10, -(1 + 2.0 ** -10), 3.0e-30,
                         1.0])
    got = tf32(x)
    assert torch.equal(got[[0, 1, 2, 3, 4, 6]], want[[0, 1, 2, 3, 4, 6]])
    assert abs(float(got[5]) / 3.0e-30 - 1) < 2.0 ** -10
    hi = tf32(x)
    assert torch.equal(hi + tf32(x - hi), x)   # two parts hold these exactly


@pytest.mark.parametrize("bh,s,d", SHAPES)
def test_3xtf32_emulation_matches_reference(bh, s, d):
    rng = np.random.default_rng(s + d)
    (jq, tq), (jk, tk), (jv, tv) = (
        pair(rng.standard_normal((bh, s, d)), "float32") for _ in range(3))
    want = torch.from_numpy(np.array(jflash_ref(jq, jk, jv)))
    tol = tflash.CHECK_TOLS["float32"]
    three = tflash.row_error(flash_tf32_emulated(tq, tk, tv, 3), want)
    one = tflash.row_error(flash_tf32_emulated(tq, tk, tv, 1), want)
    assert three <= tol, three
    assert one > tol, one
