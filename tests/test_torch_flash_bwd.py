"""The plain flash-attention backward and the differentiable flash op, on
the CPU.

``kernels.ref.flash_attention_bwd_ref`` (the kernel's plain version,
written out, not autograd) against ``jax.vjp`` of the reference's
``repro.kernels.ref.flash_attention_ref``, with g = 1 and with g > 1 as the
reference's models make it (KV heads repeated g times, their cotangents
summed over the group), at ragged S:

* fp32 inputs: within 2e-5 of max(1, max|want|) (both in fp32, summed in
  different orders over up to 77 keys);
* fp64 inputs: the reference's function computes in fp32 whatever its
  inputs, so it is held within 1e-5 there, and to 1e-12 of max(1,
  max|want|) against ``jax.vjp`` of the same function with its fp32 casts
  at fp64 (``_attention_f64``), which the plain backward computes in fp64
  given that function's output (D = rowsum(dO * O) needs O at fp64).

``ops.flash_attention`` under autograd gives exactly the plain backward's
gradients on the CPU (its backward is that function), and without a
gradient to track it saves nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)
jax.config.update("jax_enable_x64", True)

SHAPES = [(1, 1, 1, 8), (2, 1, 37, 16), (1, 4, 77, 32), (3, 2, 64, 8),
          (2, 3, 65, 24), (1, 4, 33, 160), (2, 1, 17, 256)]  # (BH / g, g, S, D)


def _inputs(bkv, g, s, d, seed, dtype):
    rng = np.random.default_rng(seed)
    q, o_grad = (rng.standard_normal((bkv * g, s, d)) for _ in "qo")
    k, v = (rng.standard_normal((bkv, s, d)) for _ in "kv")
    return [x.astype(dtype) for x in (q, k, v, o_grad)]


def _attention_f64(q, k, v):
    """The reference's flash_attention_ref with its fp32 casts at fp64."""
    s_len = q.shape[1]
    scores = jnp.einsum("bsd,btd->bst", q, k) / np.sqrt(q.shape[-1])
    mask = jnp.tril(jnp.ones((s_len, s_len), bool))
    w = jax.nn.softmax(jnp.where(mask[None], scores, -1e30), axis=-1)
    return jnp.einsum("bst,btd->bsd", w, v)


def _vjp(fn, q, k, v, do, g):
    """Cotangents of q and of the grouped k, v: k, v repeated to BH rows
    (row bh reads KV row bh // g), their cotangents summed back."""
    def grouped(q, k, v):
        return fn(q, jnp.repeat(k, g, axis=0), jnp.repeat(v, g, axis=0))
    out, pull = jax.vjp(grouped, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in pull(jnp.asarray(do))]


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    err = float(np.abs(got.double().numpy() - want).max()) if want.size \
        else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max(initial=0.0))), err


def _plain(q, k, v, do, o=None):
    """The plain backward given the forward's output ``o`` (default: the
    plain forward's)."""
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = (tref.flash_attention_ref(tq, tk, tv) if o is None
         else torch.from_numpy(o))
    return tref.flash_attention_bwd_ref(tq, tk, tv, o, tdo)


@pytest.mark.parametrize("bkv,g,s,d", SHAPES)
def test_bwd_ref_matches_reference_vjp_fp32(bkv, g, s, d):
    q, k, v, do = _inputs(bkv, g, s, d, s + d, np.float32)
    _, want = _vjp(jref.flash_attention_ref, q, k, v, do, g)
    got = _plain(q, k, v, do)
    for x, w in zip(got, want):
        assert x.dtype == torch.float32 and tuple(x.shape) == w.shape
        _close(x, w, 2e-5)


@pytest.mark.parametrize("bkv,g,s,d", SHAPES)
def test_bwd_ref_matches_reference_vjp_fp64(bkv, g, s, d):
    q, k, v, do = _inputs(bkv, g, s, d, 2 * s + d, np.float64)
    _, want32 = _vjp(jref.flash_attention_ref, q, k, v, do, g)
    o64, want64 = _vjp(_attention_f64, q, k, v, do, g)
    got = _plain(q, k, v, do, o64)
    for x, w32, w64 in zip(got, want32, want64):
        assert x.dtype == torch.float64
        _close(x, w32, 1e-5)
        _close(x, w64, 1e-12)


def test_bwd_ref_low_precision_within_storage_rounding():
    """bf16 inputs: computed in fp32 and rounded once, so within a bf16 ulp
    or two (8e-3 of the scale) of the fp32 computation on the same values."""
    q, k, v, do = _inputs(2, 2, 50, 16, 3, np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    o = tref.flash_attention_ref(tq, tk, tv)
    got = tref.flash_attention_bwd_ref(tq, tk, tv, o, tdo)
    want = tref.flash_attention_bwd_ref(*(x.float() for x in
                                          (tq, tk, tv, o, tdo)))
    for x, w in zip(got, want):
        assert x.dtype == torch.bfloat16
        _close(x, w.numpy(), 8e-3)


def test_bwd_ref_walks_kv_rows_in_chunks(monkeypatch):
    """The chunked walk over KV rows gives what one chunk gives."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(5, 3, 33, 8, 4, np.float64))
    o = tref.flash_attention_ref(q, k, v)
    whole = tref.flash_attention_bwd_ref(q, k, v, o, do)
    monkeypatch.setattr(tref, "_BWD_CHUNK", 3 * 33 * 33 * 2)
    parts = tref.flash_attention_bwd_ref(q, k, v, o, do)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("g", [1, 4])
def test_autograd_op_equals_plain_backward(g, dtype):
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in
                   _inputs(2, g, 45, 16, g, np.float64))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = ops.launch_counts()
    o = ops.flash_attention(*leaves)
    assert o.grad_fn is not None
    o.backward(do)
    want = tref.flash_attention_bwd_ref(q, k, v, o.detach(), do)
    for x, w in zip(leaves, want):
        assert torch.equal(x.grad, w)
    assert ops.launch_counts() == before        # no kernel on the CPU


def test_op_without_grad_keeps_no_graph():
    q, k, v, _ = (torch.from_numpy(x) for x in
                  _inputs(1, 2, 9, 8, 0, np.float32))
    assert ops.flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None
    assert torch.equal(out, tref.flash_attention_ref(q, k, v))


def test_bwd_op_on_the_cpu_is_the_plain_version():
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(1, 2, 20, 8, 1, np.float32))
    o = tref.flash_attention_ref(q, k, v)
    got = ops.flash_attention_bwd(q, k, v, o, do)
    for a, b in zip(got, tref.flash_attention_bwd_ref(q, k, v, o, do)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_bwd(q, k, v, o, do, backend="cuda")


# ---------------------------------------------------------------------------
# the backward's route on the card: which kernel takes which dtype and D
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float16, 64, "wgmma"), (torch.float16, 128, "wgmma"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 32, "simt"), (torch.float16, 96, "simt"),
    (torch.bfloat16, 8, "simt"), (torch.float32, 32, "simt"),
    (torch.bfloat16, 160, "simt"), (torch.float16, 160, "simt"),
    (torch.float32, 160, "simt"), (torch.bfloat16, 256, "simt"),
    (torch.float32, 256, "simt")])
def test_bwd_kernel_for_names_the_route(dtype, d, want):
    from repro_torch.kernels import flash_attention as fa
    assert fa.bwd_kernel_for(dtype, d) == want


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.float16, 128, "wgmma"),
    (torch.float32, 64, "simt"), (torch.bfloat16, 96, "simt"),
    (torch.bfloat16, 160, "simt"), (torch.float32, 256, "simt")])
def test_cuda_backend_calls_the_routed_backward(monkeypatch, dtype, d, want):
    """``ops._cuda_flash_bwd`` calls the wrapper that ``bwd_kernel_for``
    names, and only that one."""
    from repro_torch.kernels import flash_attention as fa
    calls = []
    for name, fn in (("wgmma", "flash_attention_bwd_wgmma_cuda"),
                     ("simt", "flash_attention_bwd_cuda")):
        monkeypatch.setattr(fa, fn, lambda *a, _n=name: calls.append(_n)
                            or "ran")
    q = torch.zeros(2, 5, d, dtype=dtype)
    k = torch.zeros(1, 5, d, dtype=dtype)
    assert ops._cuda_flash_bwd(q, k, k, q, q) == "ran"
    assert calls == [want]


@pytest.mark.parametrize("dtype,d,match", [
    (torch.bfloat16, 64, "CUDA"), (torch.float16, 128, "CUDA"),
    (torch.float32, 64, "dtype"), (torch.float64, 64, "dtype"),
    (torch.bfloat16, 32, "head dim"), (torch.float16, 96, "head dim")])
def test_bwd_wgmma_wrapper_raises_on_what_it_does_not_take(dtype, d, match):
    """The wgmma backward's wrapper takes CUDA tensors of bf16 and fp16 at
    D in {64, 128} only; it never falls back to ``flash_attn_bwd.cu`` or
    the plain version, and counts nothing."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros(2, 8, d, dtype=dtype)
    k = torch.zeros(1, 8, d, dtype=dtype)
    before = dict(fa.launches)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_bwd_wgmma_cuda(q, k, k, q, q)
    assert fa.launches == before


@pytest.mark.parametrize("dtype,d", [
    (torch.float32, 264), (torch.bfloat16, 264), (torch.float16, 264),
    (torch.float32, 4), (torch.bfloat16, 100), (torch.float16, 161),
    (torch.float32, 0)])
def test_bwd_wrapper_refuses_head_widths_it_does_not_take(dtype, d):
    """``flash_attention_bwd_cuda`` takes 8 <= D <= MAX_BWD_D = 256 with D
    % 8 == 0 and refuses any other width before it looks at the device,
    with nothing counted; there is no fallback to the plain version."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.MAX_BWD_D == 256 == fa.MAX_D
    q = torch.zeros(2, 8, d, dtype=dtype)
    k = torch.zeros(1, 8, d, dtype=dtype)
    before = dict(fa.launches)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bwd_cuda(q, k, k, q, q)
    assert fa.launches == before


def test_launch_counts_have_both_backward_kernels():
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    counts = ops.launch_counts()
    for key in ("flash_attention_bwd", "flash_attention_bwd_wgmma"):
        assert key in fa.launches and key in counts
    assert _build.SOURCES["flash_attn_bwd_wgmma"] == "flash_attn_bwd_wgmma.cu"
    assert (_build.CSRC / "flash_attn_bwd_wgmma.cu").is_file()


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bwd_planted_faults_edit_their_sources():
    """Each fault of ``chip_smoke.FLASH_BWD_FAULTS`` names a backward source
    and edits text that occurs there as often as it says; each source has
    the same three faults."""
    from repro_torch.kernels import _build
    smoke = _chip_smoke()
    by_source = {}
    for fault, (source, edits) in smoke.FLASH_BWD_FAULTS.items():
        text = (_build.CSRC / _build.SOURCES[source]).read_text()
        for old, new, times in edits:
            assert old != new and text.count(old) == times, (fault, old)
        by_source.setdefault(source, []).append(
            fault.removeprefix("wgmma_"))
    assert by_source["flash_attn_bwd"] == by_source["flash_attn_bwd_wgmma"]
    assert set(smoke.BWD_ROUTES) == {"wgmma", "simt"}


def test_bwd_check_cases_reach_both_routes():
    """``chip_smoke.bwd_check_cases`` holds the wgmma backward at granite's
    shape, at D = 128 and at a ragged S with g > 1 in bf16 and fp16, and
    ``flash_attn_bwd.cu`` at every fp32 case and at pixtral's shape (D =
    160) and at D = 256 in every dtype."""
    from repro_torch.kernels import flash_attention as fa
    smoke = _chip_smoke()
    routed = {}
    for bh, s, d, g, dname in smoke.bwd_check_cases():
        route = fa.bwd_kernel_for(getattr(torch, dname), d)
        routed.setdefault(route, []).append((bh, s, d, g, dname))
    assert all(c[4] != "float32" for c in routed["wgmma"])
    assert sum(c[4] == "float32" for c in routed["simt"]) == len(
        smoke.bwd_check_cases()) // 3
    for dname in ("bfloat16", "float16"):
        cases = [c for c in routed["wgmma"] if c[4] == dname]
        assert smoke.BWD_MAIN + (dname,) in cases
        assert any(c[2] == 128 for c in cases)
        assert any(c[1] % 128 and c[3] > 1 for c in cases)
    assert smoke.BWD_PIXTRAL[2] == 160
    for dname in ("float32", "bfloat16", "float16"):
        assert smoke.BWD_PIXTRAL + (dname,) in routed["simt"]
        assert any(c[2] == 256 and c[3] > 1 and c[4] == dname
                   for c in routed["simt"])
