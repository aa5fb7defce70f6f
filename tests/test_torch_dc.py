"""The port's divide-and-conquer stage 3 (``repro_torch.core.bidiag_dc``,
plain path, on the CPU) against the reference's ``core/bidiag_dc.py``, and
the ``stage3=`` policy of the pipeline.

The same inputs, made with numpy from fixed seeds, go to both packages.
Tolerances: sigma within 1e-13 * sigma_max at fp64 (rounding of a
backward-stable solve whose sums run in another order); 1e-4 * sigma_max
at fp32, whose sums run in another order over log2(m / lm) merge levels
(the port's own fp32 yardstick is 5e-4 at n = 256).  Leaf eigenvalues
within 1e-14 of the leaf's scale, their first and last eigenvector rows
within 1e-12.  Each distinct shape of the jitted reference costs seconds
to compile, so the reference runs at few shapes."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch_port_common import (bisect_descend, bisect_walk, check_svd,
                               deflation_runs, gram_schmidt_by_runs_model)

from repro.core import bidiag_dc as jdc
from repro.core.tuning import PipelineConfig as JConfig
from repro_torch import convert
from repro_torch.core import bidiag_dc as tdc
from repro_torch.core import bidiag_svd as ts3
from repro_torch.core import svd as tsvd
from repro_torch.core import tuning
from repro_torch.core.tuning import PipelineConfig
from repro_torch.kernels import dc as tdc_kern

torch.set_num_threads(2)


def lapack_sigma(d, e):
    b = np.diag(np.asarray(d, float))
    if len(d) > 1:
        b += np.diag(np.asarray(e, float)[1:], 1)
    return np.linalg.svd(b, compute_uv=False)


def port_sigma(d, e, leaf_n, **kw):
    return tdc.bidiag_dc_singular_values(torch.from_numpy(np.asarray(d)),
                                         torch.from_numpy(np.asarray(e)),
                                         leaf_n=leaf_n, **kw).numpy()


def ref_sigma(d, e, leaf_n):
    return np.asarray(jdc.bidiag_dc_singular_values(
        jnp.asarray(d), jnp.asarray(e), leaf_n=leaf_n))


def within(got, want, tol):
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * scale)


# ---------------------------------------------------------------------------
# the parts: leaves, the secular roots, one merge
# ---------------------------------------------------------------------------

def test_leaf_eigen_matches_reference():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 32))
    b = rng.standard_normal((5, 31))
    b[2, 10] = 0.0                                   # a split leaf
    a[3] = 1.0 + 1e-9 * np.arange(32)               # nearly one eigenvalue
    b[3] = 1e-6
    jl, jf, jlast = jax.jit(jax.vmap(functools.partial(
        jdc._leaf_eigen, bisect_iters=60, inv_iters=2)))(a, b)
    lam, f, last = tdc._leaf_eigen(torch.from_numpy(a), torch.from_numpy(b),
                                   bisect_iters=60, inv_iters=2,
                                   backend="ref")
    rad = np.abs(np.pad(b, ((0, 0), (1, 0)))) + np.abs(np.pad(b, ((0, 0),
                                                                  (0, 1))))
    scale = np.maximum(np.abs(a) + rad, 1).max(-1, keepdims=True)
    assert (np.abs(lam.numpy() - np.asarray(jl)) <= 1e-14 * scale).all()
    for got, want, rows in ((f, jf, "first"), (last, jlast, "last")):
        # leaf 3 is a cluster: its vectors are any basis of it, so only
        # the leaves with separated eigenvalues are held row for row
        sep = [0, 1, 2, 4]
        np.testing.assert_allclose(got.numpy()[sep], np.asarray(want)[sep],
                                   rtol=0, atol=1e-12, err_msg=rows)


def _secular_problem(rng, p, m, nact):
    """A merge's secular equation as _merge_pair hands it over: poles
    ascending on the active prefix, weights rho * z^2 there and 0 after."""
    d = np.sort(rng.standard_normal((p, m)), axis=-1)
    z = rng.standard_normal((p, m))
    act = np.arange(m)[None, :] < nact[:, None]
    w = np.where(act, z * z, 0.0)
    eps = np.finfo(np.float64).eps
    norm_scale = np.abs(d).max(-1, keepdims=True) + 2
    d_next = np.pad(d[:, 1:], ((0, 0), (0, 1)))
    a_next = np.pad(act[:, 1:], ((0, 0), (0, 1)))
    gap = np.where(a_next, d_next - d, w.sum(-1, keepdims=True)
                   * (1 + 4 * eps) + 4 * eps * norm_scale)
    return d, w, gap, act, d_next, a_next


def test_secular_roots_match_reference():
    rng = np.random.default_rng(1)
    p, m = 3, 160
    nact = np.array([160, 97, 40])
    d, w, gap, act, d_next, a_next = _secular_problem(rng, p, m, nact)
    janc, jtau = jax.jit(functools.partial(jdc._secular_roots,
                                           newton_iters=30))(
        d, w, gap, act, d_next, a_next)
    t = [torch.from_numpy(x) for x in (d, w, gap, act, d_next, a_next)]
    k = int(nact.max())
    hidx = torch.topk(t[1][:, :k], min(32, k), dim=-1)[1]
    anc, tau = tdc.secular_plain(*t, hidx, nact=k, newton_iters=30)
    scale = np.abs(d).max() + w.sum(-1).max()
    mu_j = (np.asarray(janc) + np.asarray(jtau))[:, :k]
    np.testing.assert_allclose((anc + tau).numpy(), mu_j, rtol=0,
                               atol=1e-13 * scale)


def _merge_inputs():
    rng = np.random.default_rng(2)
    p, h = 4, 64
    d1, d2 = (np.sort(rng.standard_normal((p, h)), -1) for _ in range(2))
    f1, l1, f2, l2 = (rng.standard_normal((p, h)) / np.sqrt(h)
                      for _ in range(4))
    rho_b = rng.standard_normal(p)
    return d1, f1, l1, d2, f2, l2, rho_b


def test_merge_pair_matches_reference():
    args = _merge_inputs()
    d1, _, _, d2, _, _, rho_b = args
    want = jax.jit(functools.partial(jdc._merge_pair, newton_iters=30))(
        *args)
    got = tdc._merge_pair(*(torch.from_numpy(x) for x in args),
                          newton_iters=30, backend="ref")
    scale = np.abs(np.concatenate([d1, d2], -1)).max() + 2 * np.abs(
        rho_b).max()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-13 * scale)
    for g, w_ in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0,
                                   atol=1e-11)


def test_merge_passes_split_by_the_byte_budget(monkeypatch):
    """A byte budget of five rows splits the Loewner product and the f/l
    rows into blocks of their target axis: the parent's triple stays
    within rounding of the one-block pass and of the reference's
    _merge_pair (test_merge_pair_matches_reference's tolerances)."""
    args = _merge_inputs()
    targs = [torch.from_numpy(x) for x in args]
    one = tdc._merge_pair(*targs, newton_iters=30, backend="ref")
    blocks = []
    real = tdc._row_blocks

    def spy(p, nact, dtype):
        out = real(p, nact, dtype)
        blocks.append(len(out))
        return out

    monkeypatch.setattr(tdc, "DC_MERGE_BLOCK_BYTES", 4 * 128 * 8 * 5)
    monkeypatch.setattr(tdc, "_row_blocks", spy)
    split = tdc._merge_pair(*targs, newton_iters=30, backend="ref")
    assert len(blocks) == 2 and min(blocks) >= 10, blocks
    assert torch.equal(split[0], one[0])
    for g, w_ in zip(split[1:], one[1:]):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=0,
                                   atol=1e-13)
    want = jax.jit(functools.partial(jdc._merge_pair, newton_iters=30))(
        *args)
    d1, _, _, d2, _, _, rho_b = args
    scale = np.abs(np.concatenate([d1, d2], -1)).max() + 2 * np.abs(
        rho_b).max()
    np.testing.assert_allclose(split[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-13 * scale)
    for g, w_ in zip(split[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0,
                                   atol=1e-11)


@pytest.mark.parametrize("m,last,want", [
    (8192, 8191, (512, 16)),        # the top level of fp64 n = 4096
    (32768, 32767, (512, 64)),      # the top level of fp32 n = 16384
    (8192, 6000, (512, 16)), (128, 127, (32, 16)), (64, 20, (32, 16)),
    (2, 1, (32, 16)), (1, -1, (32, 16))])
def test_deflate_schedule(m, last, want):
    assert tuning.dc_deflate_schedule(m, last) == want


def deflate_schedule_model(d, z, fe, le, active, tol, chunk):
    """``dc_deflate_kernel``'s schedule in plain torch, one row at a time:
    the steps 1 ... last (the last active column) in chunks of ``chunk``,
    each run from its first column as it came in (the speculative run),
    then the chunk boundaries in order, each chunk whose previous step
    merged run again from the true carry until a step where neither run
    merged.  Returns the outputs of ``deflate_plain`` and the steps run
    again."""
    outs = [x.clone() for x in (d, z, fe, le, active)]
    fixup = 0
    for p in range(d.shape[0]):
        flags = [bool(x) for x in active[p]]
        last = max((i for i, a in enumerate(flags) if a), default=-1)
        if last < 1:
            continue
        t = tol[p:p + 1]
        src = [x[p] for x in (d, z, fe, le)]
        scr = [x[p] for x in outs]          # the scratch, then the output

        def column(i):
            return tuple(x[i:i + 1] for x in src)

        def run(i0, i1, carry, rerun):
            dc, zc, fc, lc = carry
            mrg, steps = False, 0
            for i in range(i0, i1):
                di, zi, fi, li = column(i)
                ac, ai = flags[i - 1], flags[i]
                spec = rerun and ac and not bool(scr[4][i - 1])
                r = torch.sqrt(zc * zc + zi * zi)
                pos = r > 0
                rs = torch.where(pos, r, 1)
                cg = torch.where(pos, zi / rs, 1)
                sg = torch.where(pos, zc / rs, 0)
                off = (cg * sg * (di - dc)).abs()
                mrg = ac and ai and bool(off <= t)
                cc, ss = cg * cg, sg * sg
                steps += 1
                if mrg:
                    emit = (cc * dc + ss * di, torch.zeros_like(zc),
                            cg * fc - sg * fi, cg * lc - sg * li)
                    dc, zc, fc, lc = (ss * dc + cc * di, r,
                                      sg * fc + cg * fi, sg * lc + cg * li)
                else:
                    emit = (dc, zc, fc, lc)
                    dc, zc, fc, lc = di, zi, fi, li
                for k in range(4):
                    scr[k][i - 1] = emit[k][0]
                scr[4][i - 1] = ac and not mrg
                if rerun and not mrg and not spec:
                    return (dc, zc, fc, lc), mrg, True, steps
            return (dc, zc, fc, lc), mrg, False, steps

        def put_last(carry):
            for k in range(4):
                scr[k][last] = carry[k][0]
            scr[4][last] = flags[last]

        bounds = [(i0, min(i0 + chunk, last + 1))
                  for i0 in range(1, last + 1, chunk)]
        spec = []
        for i0, i1 in bounds:
            carry, mrg, _, _ = run(i0, i1, column(i0 - 1), False)
            spec.append((carry, mrg))
            if i1 == last + 1:
                put_last(carry)
        carry, mrg = spec[0]
        for k in range(1, len(bounds)):
            if mrg:
                carry, mrg, met, steps = run(*bounds[k], carry, True)
                fixup += steps
                if not met:
                    if bounds[k][1] == last + 1:
                        put_last(carry)
                    continue
            carry, mrg = spec[k]
    return tuple(outs), fixup


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("chunk", [1, 3, 32])
def test_deflate_schedule_model_is_bitwise_plain(chunk, dtype):
    """The kernel's chunk-and-repair schedule gives the plain scan's
    columns bit for bit, with merge runs across chunk boundaries (so the
    repair runs) and a deflated suffix left as it came in."""
    m = 8 * chunk + 40 if chunk > 1 else 60
    args = deflation_runs(3, m, chunk, chunk, dtype)
    want = tdc.deflate_plain(*args)
    got, fixup = deflate_schedule_model(*args, chunk=chunk)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert fixup > 0
    merged = args[4] & ~want[4]
    assert int(merged.sum()) > 2 * chunk
    tail = m - m // 8
    for x, y in zip(args, want):
        assert torch.equal(x[:2, tail:], y[:2, tail:])


# ---------------------------------------------------------------------------
# the leaf kernel's schedule and its Gram-Schmidt by cluster runs
# ---------------------------------------------------------------------------

# the leaf kernel against its plain version (tests/test_torch_kernels.py):
# rows and cluster sums within 10 times these
DC_TOLS = {torch.float64: 1e-13, torch.float32: 1e-5}


def leaf_schedule_model(a, b, lo0, hi0, *, iters, d, s):
    """``dc_leaf_kernel``'s bisection in plain torch: the 2^d - 1 nodes of
    the tree's top under each leaf's [lo0, hi0] counted once with the
    leaf's recurrence (``_tridiag_count``), each index k walked down them,
    then rounds of s levels (1 where s = 0) whose 2^s - 1 nodes under k's
    bracket are counted at once and walked; index k goes left where the
    count is at least k + 1."""
    p, lm = a.shape
    k1 = torch.arange(1, lm + 1)
    nodes = torch.arange(1, 2 ** d)
    tlo, thi = bisect_descend(nodes, lo0[:, None].expand(p, nodes.numel()),
                              hi0[:, None].expand(p, nodes.numel()))
    top = tdc._tridiag_count(a, b, 0.5 * (tlo + thi))
    lo, hi = bisect_walk(lo0[:, None].expand(p, lm), hi0[:, None].expand(
        p, lm), lambda jj: top.gather(1, jj - 1), d, 0, k1)
    done = d
    while done < iters:
        lev = min(max(s, 1), iters - done)
        sub = torch.arange(1, 2 ** lev)
        m = sub.numel()
        slo, shi = bisect_descend(sub, lo[..., None].expand(p, lm, m),
                                  hi[..., None].expand(p, lm, m))
        cnt = tdc._tridiag_count(a, b, (0.5 * (slo + shi)).reshape(
            p, lm * m)).reshape(p, lm, m)
        lo, hi = bisect_walk(lo, hi, lambda jj: cnt.gather(
            2, (jj - 1)[..., None])[..., 0], lev, 0, k1)
        done += lev
    return 0.5 * (lo + hi)


def _leaves(lm, dtype, seed):
    """Four leaves of lm rows: random; split (a zero coupling in the
    middle); clustered (a run of eigenvalues 1e-9 apart); degenerate (two
    uncoupled copies of one block, so every eigenvalue is double).
    Returns a, b and each leaf's bracket and cluster width."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((4, lm))
    b = rng.standard_normal((4, lm - 1))
    b[1, lm // 2 - 1] = 0.0
    c0, c1 = lm // 4, max(lm // 2, lm // 4 + 2)
    a[2, c0:c1] = 1.0 + 1e-9 * np.arange(c1 - c0)
    b[2, c0 - 1:c1] = 1e-9
    h = lm // 2
    a[3, h:] = a[3, :h]
    b[3, h:] = b[3, :h - 1]
    b[3, h - 1] = 0.0
    a, b = (torch.from_numpy(x).to(dtype) for x in (a, b))
    return (a, b) + tdc._leaf_bracket(a, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("lm,s", [
    (lm, s) for lm in (4, 16, 64, 128) for s in (0, 2, 3, 4, 5)
    if lm << s <= tuning.DC_LEAF_THREADS])
def test_leaf_schedule_model_is_bitwise_plain(lm, s, dtype):
    """The tree's top counted once per leaf, then s levels a round: the
    plain bisection's midpoints, so its eigenvalues bit for bit, at every
    s the block's threads allow, on split, clustered and degenerate
    leaves."""
    a, b, lo0, hi0, ctol = _leaves(lm, dtype, lm + s)
    iters = tdc.default_bisect_iters(dtype)
    d = tdc_kern.leaf_schedule(4, lm, iters)[0]
    assert d == min(lm.bit_length() - 1, iters)
    got = leaf_schedule_model(a, b, lo0, hi0, iters=iters, d=d, s=s)
    want = tdc.leaf_eigen_plain(a, b, lo0, hi0, ctol,
                                tdc.leaf_start(lm, dtype, "cpu"),
                                bisect_iters=iters, inv_iters=0)[0]
    assert torch.equal(got, want)
    # the degenerate leaf's eigenvalues come in pairs, bit for bit
    assert torch.equal(want[3, ::2], want[3, 1::2])


@pytest.mark.parametrize("iters", [1, 3, 6])
def test_leaf_schedule_model_short_runs(iters):
    """Fewer bisection steps than the tree's top is deep (d = iters) and
    than one round of s levels still give the plain version's bits."""
    a, b, lo0, hi0, ctol = _leaves(16, torch.float64, iters)
    d = tdc_kern.leaf_schedule(4, 16, iters)[0]
    want = tdc.leaf_eigen_plain(a, b, lo0, hi0, ctol,
                                tdc.leaf_start(16, a.dtype, "cpu"),
                                bisect_iters=iters, inv_iters=0)[0]
    for s in (0, 2, 5):
        assert torch.equal(leaf_schedule_model(
            a, b, lo0, hi0, iters=iters, d=d, s=s), want)


@pytest.mark.parametrize("p,lm,iters,want", [
    (128, 64, 60, (6, 3)),     # fp64 n = 4096, dc_leaf_n 32: 512 threads
    (512, 64, 40, (6, 2)),     # fp32 n = 16384: 256 threads, one wave
    (64, 128, 60, (7, 2)),     # fp64 n = 4096, dc_leaf_n 64: 512 threads
    (128, 128, 60, (7, 2)),
    (512, 128, 40, (7, 0)),
    (3, 4, 60, (2, 5)),
    (1, 128, 60, (7, 2))])     # s capped: 5 uncapped, lm 2^s <= 512
def test_leaf_schedule_choice(p, lm, iters, want):
    """(d, s) of the leaf kernel: the Sturm kernels' schedule for P leaves
    of lm indices, s capped so that a block's lm 2^s threads stay within
    DC_LEAF_THREADS."""
    got = tdc_kern.leaf_schedule(p, lm, iters)
    assert got == want
    assert lm << got[1] <= tuning.DC_LEAF_THREADS


def _cluster_sums(lam, f, l, ctol):
    """(3, P, lm): per cluster run of each leaf, the sums of f^2, f*l and
    l^2 over it, which no rotation inside the run changes."""
    start = torch.ones_like(lam, dtype=torch.bool)
    start[:, 1:] = ~(lam[:, 1:] - lam[:, :-1] < ctol[:, None])
    cid = (torch.cumsum(start.to(torch.int64), -1) - 1).expand(3, -1, -1)
    return torch.zeros((3,) + tuple(lam.shape), dtype=lam.dtype).scatter_add_(
        -1, cid, torch.stack((f * f, f * l, l * l)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_gram_schmidt_by_runs_model_matches_plain(dtype):
    """The kernel's inverse iteration and Gram-Schmidt by runs against
    ``leaf_eigen_plain`` at its own eigenvalues: the rows of a leaf with no
    cluster within DC_TOLS, every run's cluster sums within the same, on a
    leaf with several separate runs and on one whose start vectors repeat
    in two runs of a double eigenvalue, so that the fallback fires in both
    runs at once (and nowhere else); every run's vectors orthonormal."""
    lm = 16
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, lm))
    b = rng.standard_normal((3, lm - 1))
    # leaf 1: runs of three, two and two eigenvalues `gap` apart, which
    # the type resolves
    gap = 1e-9 if dtype == torch.float64 else 1e-4
    for c0, c1, v in ((1, 4, 2.5), (7, 9, -1.5), (12, 14, 4.0)):
        a[1, c0:c1] = v + gap * np.arange(c1 - c0)
        b[1, c0 - 1:c1] = gap
    # leaf 2: two uncoupled copies of a block with eigenvalues ~1 apart
    a[2, :8] = a[2, 8:] = np.arange(8.0)
    b[2, :7] = b[2, 8:] = 0.3
    b[2, 7] = 0.0
    a, b = (torch.from_numpy(x).to(dtype) for x in (a, b))
    lo0, hi0, ctol = tdc._leaf_bracket(a, b)
    iters = tdc.default_bisect_iters(dtype)
    x0 = tdc.leaf_start(lm, dtype, "cpu")
    lam = tdc.leaf_eigen_plain(a, b, lo0, hi0, ctol, x0, bisect_iters=iters,
                               inv_iters=0)[0]
    assert torch.equal(lam[2, ::2], lam[2, 1::2])       # eight runs of two
    close = lam[:, 1:] - lam[:, :-1] < ctol[:, None]
    starts = close & ~torch.nn.functional.pad(close, (1, 0))[:, :-1]
    assert starts.sum(-1).tolist() == [0, 3, 8]
    x0 = x0.clone()
    x0[3], x0[11] = x0[2], x0[10]       # repeated in two runs of leaf 2
    want = tdc.leaf_eigen_plain(a, b, lo0, hi0, ctol, x0, bisect_iters=iters,
                                inv_iters=2)
    f, l, vec, collapses = gram_schmidt_by_runs_model(a, b, lam, ctol, x0,
                                                      inv_iters=2)
    assert collapses == [0, 0, 2]
    tol = DC_TOLS[dtype] * 10
    for got_, want_ in ((f, want[1]), (l, want[2])):
        torch.testing.assert_close(got_[0], want_[0], rtol=0, atol=tol)
    sums = [_cluster_sums(lam, *x, ctol) for x in ((f, l), want[1:])]
    torch.testing.assert_close(sums[0], sums[1], rtol=0, atol=tol)
    gram = vec @ vec.transpose(-1, -2)
    eye = torch.eye(lm, dtype=dtype).expand_as(gram)
    same_run = (lam[:, :, None] - lam[:, None, :]).abs() < ctol[:, None, None]
    err = (gram - eye)[same_run].abs().max()
    assert float(err) <= (1e-12 if dtype == torch.float64 else 1e-5)


# ---------------------------------------------------------------------------
# sigma against the reference: the reference test's inputs
# ---------------------------------------------------------------------------

def _random(n=100):
    rng = np.random.default_rng(0)
    return rng.standard_normal(n), rng.standard_normal(n), 16


def _clustered():
    n = 96
    return np.ones(n) + 1e-14 * np.arange(n), np.full(n, 1e-13), 16


def _extreme():
    n = 64
    rng = np.random.default_rng(2)
    d = np.logspace(-300, 300, n) * np.sign(rng.standard_normal(n))
    return d, 0.5 * np.logspace(-300, 300, n), 16


def _deflated():
    n = 128
    rng = np.random.default_rng(3)
    d = rng.standard_normal(n)
    e = np.zeros(n)
    e[::7] = rng.standard_normal(len(e[::7])) * 1e-3
    return d, e, 16


def _degenerate():
    d = np.array([1.0, -4.0, 2.0, 0.0, -0.5] * 16)
    return d, np.zeros_like(d), 8


@pytest.mark.parametrize("case", [_random, _clustered, _extreme, _deflated,
                                  _degenerate],
                         ids=lambda f: f.__name__.strip("_"))
def test_sigma_matches_reference(case):
    d, e, leaf = case()
    got = port_sigma(d, e, leaf)
    want = ref_sigma(d, e, leaf)
    within(got, want, 1e-13)
    within(got, lapack_sigma(d, e), 1e-13)


def test_sigma_fp32_matches_reference():
    rng = np.random.default_rng(0)
    d, e = (rng.standard_normal(100).astype(np.float32) for _ in range(2))
    got = port_sigma(d, e, 16)
    assert got.dtype == np.float32
    within(got, ref_sigma(d, e, 16), 1e-4)
    within(got, lapack_sigma(d, e), 1e-4)


def test_batched_matches_reference_and_one_at_a_time():
    rng = np.random.default_rng(4)
    d = rng.standard_normal((3, 48))
    e = rng.standard_normal((3, 48))
    got = port_sigma(d, e, 16)
    assert got.shape == (3, 48)
    want = ref_sigma(d, e, 16)
    for i in range(3):
        within(got[i], want[i], 1e-13)
        within(got[i], port_sigma(d[i], e[i], 16), 1e-13)


@settings(max_examples=4, deadline=None)
@given(st.integers(2, 90), st.integers(0, 2**31 - 1))
def test_dc_agrees_with_bisection_property(n, seed):
    rng = np.random.default_rng(seed)
    d, e = rng.standard_normal(n), rng.standard_normal(n)
    s_bi = ts3.bidiag_singular_values(torch.from_numpy(d),
                                      torch.from_numpy(e)).numpy()
    within(port_sigma(d, e, 16), s_bi, 1e-12)


def test_dc_agrees_with_bisection_on_banded_bidiagonals():
    """What stage 2 makes of banded_input(512, 64, batch=4) (fp64, seed 0):
    in one leaf of its third matrix a vector collapses in the Gram-Schmidt;
    with the reference's fallback (e_k projected, as it is) sigma is
    2.4e-11 * sigma_max off, with the port's (two inverse-iteration steps
    on it) within rounding."""
    from repro_torch.autotune import measure
    a = measure.banded_input(512, 64, batch=4, dtype=torch.float64,
                             device="cpu")
    d, e = tsvd.bidiagonal_of(a, bw=64, device="cpu")
    got = tdc.bidiag_dc_singular_values(d, e)
    want = ts3.bidiag_singular_values(d, e)
    err = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max()
    assert float(err) <= 1e-12


def test_small_n_is_the_bisection_bit_for_bit():
    rng = np.random.default_rng(1)
    d, e = (torch.from_numpy(rng.standard_normal((2, 20))) for _ in range(2))
    assert torch.equal(tdc.bidiag_dc_singular_values(d, e, leaf_n=32),
                       ts3.bidiag_singular_values(d, e))
    s = tdc.bidiag_dc_singular_values(torch.tensor([-3.0]),
                                      torch.tensor([0.0]))
    assert torch.equal(s, torch.tensor([3.0]))


def test_leaf_n_validation():
    d = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="leaf_n"):
        tdc.bidiag_dc_singular_values(d, d, leaf_n=1)
    with pytest.raises(ValueError, match="leaf_n"):
        tdc.bidiag_dc_svd(d, d, leaf_n=0)


def test_dc_svd_reconstructs():
    rng = np.random.default_rng(5)
    n = 80
    d, e = rng.standard_normal(n), rng.standard_normal(n)
    u, s, vt = tdc.bidiag_dc_svd(torch.from_numpy(d), torch.from_numpy(e),
                                 leaf_n=16)
    u, s, vt = u.numpy(), s.numpy(), vt.numpy()
    b = np.diag(d) + np.diag(e[1:], 1)
    np.testing.assert_allclose(u @ np.diag(s) @ vt, b, atol=1e-12 * s[0])
    np.testing.assert_allclose(u.T @ u, np.eye(n), atol=1e-10)
    np.testing.assert_allclose(vt @ vt.T, np.eye(n), atol=1e-10)
    within(s, port_sigma(d, e, 16), 0)


# ---------------------------------------------------------------------------
# the stage3= policy of the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage3", ["bisect", "dc"])
def test_pipeline_stage3_backends_agree(stage3):
    rng = np.random.default_rng(6)
    n = 48
    a = rng.standard_normal((n, n))
    cfg = PipelineConfig.resolve(bw=4, tw=2, dtype=torch.float64, n=n,
                                 stage3=stage3, dc_n_min=1, dc_leaf_n=16,
                                 device="cpu")
    assert cfg.stage3 == stage3
    s = tsvd.singular_values(a, config=cfg).numpy()
    s0 = np.linalg.svd(a, compute_uv=False)
    np.testing.assert_allclose(s, s0, rtol=0, atol=1e-11 * s0[0])
    # the full SVD's sigma is the values path's, bit for bit
    u, s_uv, vt = tsvd.svd(a, config=cfg)
    assert np.array_equal(s_uv.numpy(), s)
    check_svd(a, u, s_uv, vt, 1e-10)


def test_pipeline_stage3_dc_uv_path():
    rng = np.random.default_rng(7)
    n = 32
    a = rng.standard_normal((n, n))
    cfg = PipelineConfig.resolve(bw=4, tw=2, dtype=torch.float64, n=n,
                                 compute_uv=True, stage3="dc", dc_n_min=1,
                                 dc_leaf_n=8, device="cpu")
    u, s, vt = tsvd.svd_batched(a[None], cfg)
    u, s, vt = u[0].numpy(), s[0].numpy(), vt[0].numpy()
    np.testing.assert_allclose(u @ np.diag(s) @ vt, a, atol=1e-10 * s[0])


def test_stage3_auto_resolution():
    lo = PipelineConfig.resolve(bw=4, dtype=torch.float64, n=64,
                                stage3="auto", dc_n_min=128, device="cpu")
    hi = PipelineConfig.resolve(bw=4, dtype=torch.float64, n=256,
                                stage3="auto", dc_n_min=128, device="cpu")
    assert lo.stage3 == "bisect" and hi.stage3 == "dc"
    free = PipelineConfig.resolve(bw=4, dtype=torch.float64, stage3="auto",
                                  dc_n_min=128, device="cpu")
    assert free.stage3 == "auto"
    assert free.stage3_for(64) == "bisect" and free.stage3_for(128) == "dc"
    assert lo.stage3_for(10_000) == "bisect"
    with pytest.raises(ValueError, match="stage3"):
        PipelineConfig.resolve(bw=4, stage3="qr", device="cpu")
    cfg = PipelineConfig.resolve(bw=4, dtype=torch.float64, device="cpu")
    assert (cfg.stage3, cfg.dc_leaf_n, cfg.dc_n_min) == (
        "bisect", tdc.DEFAULT_DC_LEAF_N, tdc.DEFAULT_DC_N_MIN)
    # an "auto" config routes per n through the entry points
    rng = np.random.default_rng(8)
    d = rng.standard_normal((40, 40))
    s = tsvd.singular_values(d, config=dataclasses.replace(free,
                                                           dc_n_min=40))
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(d, compute_uv=False),
                               rtol=0, atol=1e-11 * float(s.max()))


def test_leaf_budget_raises_for_a_cuda_config():
    # the leaf block holds the vectors only (the factors of the inverse
    # iteration live in device memory): dc_leaf_n 64 fits at fp64, and
    # the last widths that fit are 83 fp64 and 119 fp32
    for leaf_n, dtype in ((64, torch.float64), (83, torch.float64),
                          (119, torch.float32)):
        cfg = PipelineConfig.resolve(bw=4, stage3="dc", dc_leaf_n=leaf_n,
                                     dtype=dtype, device="cuda")
        assert cfg.dc_leaf_n == leaf_n
        assert tuning.dc_leaf_smem_bytes(leaf_n, dtype) <= \
            tuning.SMEM_PER_BLOCK
    for leaf_n, dtype in ((84, torch.float64), (120, torch.float32)):
        with pytest.raises(ValueError, match="dc_leaf_n"):
            PipelineConfig.resolve(bw=4, stage3="dc", dc_leaf_n=leaf_n,
                                   dtype=dtype, device="cuda")
    # the CPU runs the plain version, which has no such budget
    assert PipelineConfig.resolve(bw=4, stage3="dc", dc_leaf_n=200,
                                  device="cpu").dc_leaf_n == 200


def test_convert_carries_the_stage3_fields():
    jcfg = JConfig.resolve(bw=8, tw=3, backend="ref", dtype=jnp.float64,
                           n=40, stage3="dc", dc_leaf_n=16, dc_n_min=100)
    cfg = convert.pipeline_config_from_reference(dataclasses.asdict(jcfg),
                                                 device="cpu")
    assert (cfg.stage3, cfg.dc_leaf_n, cfg.dc_n_min) == ("dc", 16, 100)
    auto = convert.pipeline_config_from_reference(dataclasses.asdict(
        JConfig.resolve(bw=8, backend="ref", stage3="auto", dc_n_min=64)),
        device="cpu")
    assert auto.stage3 == "auto" and auto.stage3_for(64) == "dc"
