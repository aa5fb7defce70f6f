"""The port's MoE, SSM (mamba), RWKV6 and encoder-decoder modules against
the reference's, function by function, on the CPU.

Each function gets the same numpy inputs, made from a seed, at fp32, and
the parameters of the smoke configs (every leaf constant at init moved off
its constant, so the LoRA decay, the token-shift lerps, mamba's skip and
decay leaves and whisper's biases count), carried across by
``convert.model_params_from_reference``.  Tolerance: within 1e-4 of
max(1, max|want|); ``_route_one`` agrees exactly.  The whole models
(prefill logits and aux, eight decode steps at scalar and per-slot
positions, every cache entry after them) are held in ``test_torch_lm.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import jit_ref
from torch_port_common import lm_models as models
from torch_port_common import to_np

from repro.models import encdec as jed
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro_torch.models import encdec as ted
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import layer_slice

torch.set_num_threads(2)

TOL = 1e-4
MOE_ARCHS = ["deepseek-moe-16b", "granite-moe-3b-a800m"]


def _close(got, want, tol=TOL):
    want = to_np(want)
    assert to_np(got).shape == want.shape
    err = float(np.max(np.abs(to_np(got) - want)))
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _layer(arch, key, i=1, group="layers"):
    """Layer ``i``'s ``key`` subtree of both models' parameters."""
    _, params, tm = models(arch)
    want = jax.tree_util.tree_map(lambda a: a[i], params[group][key])
    return want, layer_slice(tm.params[group], i)[key], tm.cfg


def _x(shape, seed, scale=1.0):
    x = scale * np.random.default_rng(seed).standard_normal(shape)
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,k,e,cap", [(9, 2, 8, 3), (16, 6, 8, 4),
                                       (5, 2, 4, 5), (12, 8, 40, 2)])
def test_route_one_matches_reference_exactly(s, k, e, cap):
    """Token ids, combine weights and valid flags, per example, at
    capacities that drop (first come, token-major) and one that does not."""
    b = 3
    rng = np.random.default_rng(s * e + k)
    probs = jax.nn.softmax(jnp.asarray(rng.standard_normal((b, s, e)),
                                       jnp.float32), -1)
    gv, gi = jax.lax.top_k(probs, k)
    want = jax.vmap(lambda i, v: jmoe._route_one(None, i, v, e=e, cap=cap))(
        gi, gv)
    got = tmoe._route_one(torch.from_numpy(np.array(gi)).long(),
                          torch.from_numpy(np.array(gv)), e=e, cap=cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(np.asarray(want[2]).sum()) <= b * s * k


def test_capacity_matches_reference():
    from repro_torch.configs import get_config
    for arch in MOE_ARCHS:
        full = get_config(arch)
        for s in (1, 2, 4, 5, 11, 2048):
            assert tmoe._capacity(s, full) == jmoe._capacity(s, full)
    assert tmoe._capacity(4, full) == 4           # s <= 4: nothing drops


@pytest.mark.parametrize("s", [1, 4, 13])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_reference(arch, s):
    """Output and both aux losses; s = 13 drops tokens past capacity."""
    want_p, got_p, cfg = _layer(arch, "moe")
    x = _x((2, s, cfg.d_model), s)
    want, waux = jit_ref(jmoe.moe_ffn, cfg=cfg)(jnp.asarray(x), want_p)
    got, aux = tmoe.moe_ffn(torch.from_numpy(x), got_p, cfg)
    _close(got, want)
    assert sorted(aux) == sorted(waux)
    for key in aux:
        _close(aux[key], waux[key])


# ---------------------------------------------------------------------------
# the decay scans
# ---------------------------------------------------------------------------

def _scan_inputs(b, t, h, dk, dv, seed, with_state):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, t, h, dk)).astype(np.float32)
            for _ in "qk")
    v = rng.standard_normal((b, t, h, dv)).astype(np.float32)
    log_a = -rng.uniform(0.0, 1.0, (b, t, h, dk)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, dk, dv)).astype(np.float32)
          if with_state else None)
    return q, k, v, log_a, s0


@pytest.mark.parametrize("t,chunk,with_state", [(50, 16, True),
                                                (37, 128, False),
                                                (64, 8, False)])
def test_chunked_decay_scan_matches_reference(t, chunk, with_state):
    q, k, v, log_a, s0 = _scan_inputs(2, t, 3, 4, 5, t + chunk, with_state)
    want, wstate = jssm.chunked_decay_scan(
        *map(jnp.asarray, (q, k, v, log_a)), chunk=chunk,
        state0=None if s0 is None else jnp.asarray(s0))
    got, state = tssm.chunked_decay_scan(
        *map(torch.from_numpy, (q, k, v, log_a)), chunk=chunk,
        state0=None if s0 is None else torch.from_numpy(s0))
    _close(got, want)
    _close(state, wstate)


def test_chunked_decay_scan_stays_finite_where_the_reference_overflows():
    """Unit decay for 200 steps in one chunk of 256: the reference's
    ``exp(-acc)`` overflows (NaN from step ~88 on); the port's pairwise
    decays stay finite and agree with the recurrence run step by step in
    fp64."""
    q, k, v, log_a, _ = _scan_inputs(1, 200, 2, 4, 3, 9, False)
    log_a[:] = -1.0
    want, _ = jssm.chunked_decay_scan(*map(jnp.asarray, (q, k, v, log_a)),
                                      chunk=256)
    assert not bool(jnp.isfinite(want).all())
    got, state = tssm.chunked_decay_scan(
        *map(torch.from_numpy, (q, k, v, log_a)), chunk=256)
    assert bool(torch.isfinite(got).all())
    tq, tk, tv, ta = (torch.from_numpy(z).double() for z in (q, k, v, log_a))
    st = torch.zeros((1, 2, 4, 3), dtype=torch.float64)
    steps = []
    for i in range(200):
        st = st * torch.exp(ta[:, i])[..., None] + tk[:, i, :, :, None] * \
            tv[:, i, :, None, :]
        steps.append(torch.einsum("bhk,bhkv->bhv", tq[:, i], st))
    _close(got, torch.stack(steps, 1))
    _close(state, st)


def test_decay_step_matches_reference():
    q, k, v, log_a, s0 = _scan_inputs(2, 1, 3, 4, 5, 3, True)
    args = [z[:, 0] for z in (q, k, v, log_a)] + [s0]
    want, wstate = jssm.decay_step(*map(jnp.asarray, args))
    got, state = tssm.decay_step(*map(torch.from_numpy, args))
    _close(got, want)
    _close(state, wstate)


# ---------------------------------------------------------------------------
# mamba (hymba's SSM heads)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,chunk", [(11, 128), (21, 8), (32, 4)])
def test_mamba_matches_reference(t, chunk):
    """The full-sequence path across chunk boundaries (the log-step scan
    inside a chunk, the fp32 carry between them)."""
    want_p, got_p, cfg = _layer("hymba-1.5b", "mamba")
    x = _x((2, t, cfg.d_model), t)
    want = jit_ref(jssm.mamba, cfg=cfg, chunk=chunk)(jnp.asarray(x), want_p)
    got = tssm.mamba(torch.from_numpy(x), got_p, cfg, chunk=chunk)
    _close(got, want)


def test_prefix_states_is_the_inclusive_scan():
    """The log-step scan against the sequential recurrence s_i = s_{i-1} *
    exp(a_i) + kv_i, at lengths that are and are not powers of two."""
    rng = np.random.default_rng(5)
    for n in (1, 5, 8, 13):
        la = torch.from_numpy(-rng.uniform(0, 1, (2, n, 3))).double()
        kv = torch.from_numpy(rng.standard_normal((2, n, 3)))
        got = tssm._prefix_states(la, kv)
        s, want = torch.zeros_like(kv[:, 0]), []
        for i in range(n):
            s = s * torch.exp(la[:, i]) + kv[:, i]
            want.append(s)
        _close(got, torch.stack(want, 1), tol=1e-12)


def test_mamba_decode_matches_reference():
    """Eight one-token steps from the zero cache: outputs and the conv
    window and SSM state after each."""
    want_p, got_p, cfg = _layer("hymba-1.5b", "mamba")
    xs = _x((2, 8, cfg.d_model), 8)
    jc = jax.tree_util.tree_map(lambda a: a[0],
                                jssm.init_mamba_cache(cfg, 2, jnp.float32))
    tc = {k: v[0] for k, v in tssm.init_mamba_cache(
        cfg, 2, torch.float32, "cpu").items()}
    for i in range(8):
        want, jc = jssm.mamba_decode(jnp.asarray(xs[:, i:i + 1]), want_p,
                                     cfg, jc)
        got, tc = tssm.mamba_decode(torch.from_numpy(xs[:, i:i + 1]),
                                    got_p, cfg, tc)
        _close(got, want)
        for key in ("conv", "state"):
            _close(tc[key], jc[key])


# ---------------------------------------------------------------------------
# rwkv6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,chunk", [(9, 128), (40, 16)])
def test_rwkv_time_mix_matches_reference(t, chunk):
    want_p, got_p, cfg = _layer("rwkv6-1.6b", "tm")
    x = _x((2, t, cfg.d_model), t)
    want = jit_ref(jrwkv.rwkv_time_mix, cfg=cfg, chunk=chunk)(
        jnp.asarray(x), want_p)
    got = trwkv.rwkv_time_mix(torch.from_numpy(x), got_p, cfg, chunk=chunk)
    _close(got, want)


def test_rwkv_channel_mix_matches_reference():
    want_p, got_p, cfg = _layer("rwkv6-1.6b", "cm")
    x = _x((2, 10, cfg.d_model), 2)
    _close(trwkv.rwkv_channel_mix(torch.from_numpy(x), got_p, cfg),
           jrwkv.rwkv_channel_mix(jnp.asarray(x), want_p, cfg))


def test_rwkv_decode_steps_match_reference():
    """Eight steps of both mixes from a nonzero state: outputs, token
    shifts and the recurrent state after each."""
    tm_w, tm_g, cfg = _layer("rwkv6-1.6b", "tm")
    cm_w, cm_g, _ = _layer("rwkv6-1.6b", "cm")
    h = cfg.d_model // cfg.rwkv_head
    xs = _x((2, 8, cfg.d_model), 3)
    x_tm, x_cm = _x((2, cfg.d_model), 4), _x((2, cfg.d_model), 5)
    st = _x((2, h, cfg.rwkv_head, cfg.rwkv_head), 6, 0.3)
    j = [jnp.asarray(z) for z in (x_tm, x_cm, st)]
    t = [torch.from_numpy(z) for z in (x_tm, x_cm, st)]
    for i in range(8):
        xj, xt = jnp.asarray(xs[:, i:i + 1]), torch.from_numpy(xs[:, i:i + 1])
        wo, j[0], j[2] = jrwkv.rwkv_time_mix_decode(xj, tm_w, cfg, j[0], j[2])
        go, t[0], t[2] = trwkv.rwkv_time_mix_decode(xt, tm_g, cfg, t[0], t[2])
        _close(go, wo)
        wc, j[1] = jrwkv.rwkv_channel_mix_decode(xj, cm_w, cfg, j[1])
        gc, t[1] = trwkv.rwkv_channel_mix_decode(xt, cm_g, cfg, t[1])
        _close(gc, wc)
        for g, w in zip(t, j):
            _close(g, w)


def test_rwkv_decode_continues_the_time_mix():
    """The port's one-token steps reproduce its own full-sequence time mix
    (the shift trick against the recurrence)."""
    _, p, cfg = _layer("rwkv6-1.6b", "tm")
    h = cfg.d_model // cfg.rwkv_head
    x = torch.from_numpy(_x((2, 12, cfg.d_model), 7))
    full = trwkv.rwkv_time_mix(x, p, cfg, chunk=4)
    x_prev = torch.zeros((2, cfg.d_model))
    st = torch.zeros((2, h, cfg.rwkv_head, cfg.rwkv_head))
    for i in range(12):
        o, x_prev, st = trwkv.rwkv_time_mix_decode(x[:, i:i + 1], p, cfg,
                                                   x_prev, st)
        _close(o[:, 0], full[:, i])


# ---------------------------------------------------------------------------
# whisper's encoder and cross attention
# ---------------------------------------------------------------------------

def _frames(cfg, b, seed):
    return _x((b, cfg.enc_seq, cfg.d_model), seed)


def test_encode_matches_reference():
    jm, params, tm = models("whisper-medium")
    fr = _frames(tm.cfg, 2, 1)
    _close(ted.encode(tm.params, tm.cfg, torch.from_numpy(fr)),
           jed.encode(params, jm.cfg, jnp.asarray(fr)))


def test_mlp_is_tanh_gelu():
    want_p, got_p, cfg = _layer("whisper-medium", "mlp", 0, "dec_layers")
    x = _x((2, 5, cfg.d_model), 3)
    _close(ted._mlp(torch.from_numpy(x), got_p), jed._mlp(jnp.asarray(x),
                                                          want_p))


def test_bidir_and_cross_attention_match_reference():
    want_a, got_a, cfg = _layer("whisper-medium", "attn", 1, "enc_layers")
    x = _x((2, 7, cfg.d_model), 4)
    _close(ted._bidir_attention(torch.from_numpy(x), got_a, cfg),
           jed._bidir_attention(jnp.asarray(x), want_a, cfg))
    want_x, got_x, _ = _layer("whisper-medium", "xattn", 1, "dec_layers")
    enc = _x((2, cfg.enc_seq, cfg.d_model), 5)
    jk, jv = jed.cross_kv(jnp.asarray(enc), want_x, cfg)
    tk, tv = ted.cross_kv(torch.from_numpy(enc), got_x, cfg)
    _close(tk, jk)
    _close(tv, jv)
    _close(ted._cross_attention(torch.from_numpy(x), tk, tv, got_x, cfg),
           jed._cross_attention(jnp.asarray(x), jk, jv, want_x, cfg))


def test_fill_cross_cache_matches_reference():
    """All rows at once, as the reference fills them, and then rows 2 and 0
    alone (``slots``), which leaves row 1 as it was."""
    jm, params, tm = models("whisper-medium")
    fr = _frames(tm.cfg, 3, 6)
    want = jed.fill_cross_cache(params, jm.cfg, jnp.asarray(fr),
                                jm.init_caches(3, 8))["xkv"]
    caches = tm.init_caches(3, 8)
    tm.fill_cross_cache(fr, caches)
    for key in ("k", "v"):
        _close(caches["xkv"][key], want[key])
    fr2 = _frames(tm.cfg, 3, 7)
    want2 = jed.fill_cross_cache(params, jm.cfg, jnp.asarray(fr2),
                                 jm.init_caches(3, 8))["xkv"]
    row1 = caches["xkv"]["k"][:, 1].clone()
    tm.fill_cross_cache(fr2[[2, 0]], caches, slots=[2, 0])
    for key in ("k", "v"):
        _close(caches["xkv"][key][:, [0, 2]], want2[key][:, [0, 2]])
    assert torch.equal(caches["xkv"]["k"][:, 1], row1)
