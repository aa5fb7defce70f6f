"""The port's models against the reference's, on the CPU.

For each of the ten smoke configs (five dense decoders, two MoE, hymba,
RWKV6, whisper) the reference's model is built and initialised by JAX; its
parameters (every leaf constant at init moved off its constant, so that
those paths count) are carried across by
``convert.model_params_from_reference``, and both models see the same numpy
inputs at fp32.  Tolerances: logits, aux losses and caches of the
full-sequence and the decode paths within 1e-4 of max(1, max|want|) (fp32;
the two frameworks sum in different orders), and the port's decode against
its own prefill within 2e-3 absolute (the reference's
``test_decode_matches_prefill``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import LM_ARCHS as ARCHS
from torch_port_common import flat_params, lm_models as models
from torch_port_common import to_np

from repro.configs.base import get_config as jget_config
from repro.configs.base import smoke_of as jsmoke_of
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro_torch.configs import base as tconfigs
from repro_torch.convert import model_params_from_reference
from repro_torch.models import attention as tattn
from repro_torch.models import build
from repro_torch.models.transformer import layer_slice

torch.set_num_threads(2)

TOL = 1e-4
# the archs whose decoder layers hold "attn" (not rwkv, not whisper's
# enc_layers/dec_layers)
ATTN_ARCHS = [a for a in ARCHS
              if tconfigs.smoke_of(a).kind in ("dense", "moe", "hymba")]


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.n_img_tokens:
        batch["images"] = rng.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.kind == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch



def _close(got, want, tol=TOL):
    want = to_np(want)
    err = float(np.max(np.abs(to_np(got) - want)))
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for mine, theirs in ((tconfigs.get_config(arch), jget_config(arch)),
                         (tconfigs.smoke_of(arch), jsmoke_of(arch))):
        a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
        assert a == b
        assert mine.padded_vocab == theirs.padded_vocab
        assert mine.head_dim == theirs.head_dim
        assert mine.param_dtype == getattr(torch, theirs.dtype)
        assert mine.total_params() == theirs.total_params()
    assert tconfigs.get_config("granite-3-2b").padded_vocab == 49408


def test_list_configs_is_the_ten():
    from repro.configs.base import list_configs as jlist_configs
    assert tconfigs.list_configs() == sorted(ARCHS) == jlist_configs()


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_the_reference_rules(arch):
    """Same paths and shapes as the reference's tree; constants equal; each
    drawn tensor's spread that of the reference's rule (std 0.02 for the
    embedding, scale / sqrt(shape[0]) otherwise, so 1/sqrt(L) for stacked
    layer weights), to 15 % on tensors of at least 2,000 entries."""
    jm = jbuild(jsmoke_of(arch))
    ref = flat_params(jm.init(jax.random.PRNGKey(0)))
    tm = build(tconfigs.smoke_of(arch), device="cpu")
    tm.init_params(torch.Generator().manual_seed(0))
    mine = tm.state_dict()
    assert sorted(mine) == sorted(ref)
    for path, want in ref.items():
        got = mine[path].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, path
        if np.all(want == want.flat[0]):
            np.testing.assert_array_equal(got, want, err_msg=path)
        elif want.size >= 2000:
            assert abs(got.std() / want.std() - 1) < 0.15, path


def test_init_tree_draws_as_init_params():
    """``init_tree`` and ``Model.init_params`` draw the same values from
    the same generator state: both walk the specs in sorted-path order."""
    from repro_torch.models.modules import init_tree
    tm = build(tconfigs.smoke_of("codeqwen1.5-7b"), device="cpu")
    tm.init_params(torch.Generator().manual_seed(4))
    tree = init_tree(tm.param_specs(), torch.Generator().manual_seed(4),
                     "cpu")
    flat = flat_params(tree)
    mine = tm.state_dict()
    assert sorted(flat) == sorted(mine)
    for path, want in flat.items():
        np.testing.assert_array_equal(mine[path].numpy(), want, err_msg=path)


# ---------------------------------------------------------------------------
# the full-sequence path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch):
    jm, params, tm = models(arch)
    batch = _batch(tm.cfg, 2, 11, 5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jaux = jm.forward(params, jbatch)
    got, aux = tm.forward(batch)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(want.shape) == (2, 11,
                                                     tm.cfg.padded_vocab)
    _close(got, want)
    assert sorted(aux) == sorted(jaux)
    for key in aux:                   # zero but for the MoE configs
        _close(aux[key], jaux[key])
        assert (float(jaux[key]) != 0.0) == (tm.cfg.kind == "moe")
    _close(tm.prefill(batch), jm.prefill(params, jbatch))


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attention_matches_reference(arch):
    """One layer's full-sequence attention at an offset position: RoPE,
    the GQA repeat order (n_kv < n_heads in most) and the output
    projection."""
    _, params, tm = models(arch)
    cfg = tm.cfg
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    p_ref = jax.tree_util.tree_map(lambda a: a[1], params["layers"]["attn"])
    want = jattn.attention(jnp.asarray(x), p_ref, jsmoke_of(arch), pos0=3)
    got = tattn.attention(torch.from_numpy(x),
                          layer_slice(tm.params["layers"], 1)["attn"], cfg,
                          pos0=3)
    _close(got, want)


# ---------------------------------------------------------------------------
# the decode path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step_matches_reference(arch, per_slot):
    """Eight decode steps from empty caches, scalar positions 0..7 or
    per-slot positions (t, max(t - 3, 0)) (a slot that restarts writes its
    row 0 again); logits every step and every cache entry after the last
    (KV rows, recurrent states).  Whisper's decode starts from the
    reference's cross KV, copied in: the two encoders agree to ~1e-5 of
    scale, but the reference's init makes each cross-attention softmax
    nearly one-hot, which amplifies that to the tolerance; the port's own
    ``fill_cross_cache`` is held to the reference's in
    ``test_torch_lm_families.py``."""
    jm, params, tm = models(arch)
    b, s_max, steps = 2, 12, 8
    toks = np.random.default_rng(7).integers(0, tm.cfg.vocab, (b, steps))
    jstep = jax.jit(jm.decode_step)
    jc = jm.init_caches(b, s_max)
    tc = tm.init_caches(b, s_max)
    if tm.cfg.kind == "encdec":
        from repro.models.encdec import fill_cross_cache
        frames = _batch(tm.cfg, b, 1, 8)["frames"]
        jc = fill_cross_cache(params, jm.cfg, jnp.asarray(frames), jc)
        for key in ("k", "v"):
            tc["xkv"][key].copy_(torch.from_numpy(np.array(jc["xkv"][key])))
    for t in range(steps):
        pos = np.array([t, max(t - 3, 0)]) if per_slot else t
        tok = toks[:, t:t + 1]
        want, jc = jstep(params, jnp.asarray(tok, jnp.int32), jc,
                         jnp.asarray(pos, jnp.int32))
        got, tc = tm.decode_step(torch.from_numpy(tok),
                                 tc, torch.as_tensor(pos))
        _close(got, want)
    want_c, got_c = flat_params(jc), flat_params(tc)
    assert sorted(got_c) == sorted(want_c)
    for path, leaf in got_c.items():
        assert leaf.dtype == want_c[path].dtype, path
        _close(leaf, want_c[path])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """The port's decode against its own prefill (the reference's
    ``test_decode_matches_prefill``, 2e-3).  MoE prefill drops tokens past
    an expert's capacity and decode never does, so the MoE configs run
    s = 4, where the capacity is s."""
    _, _, tm = models(arch)
    b, s = 2, 4 if tm.cfg.kind == "moe" else 8
    batch = _batch(tm.cfg, b, s, 1)
    batch.pop("images", None)                 # decode has no image prefix
    toks = batch["tokens"]
    full = tm.prefill(batch)
    caches = tm.init_caches(b, s)
    if tm.cfg.kind == "encdec":
        tm.fill_cross_cache(batch["frames"], caches)
    for t in range(s):
        logits, caches = tm.decode_step(toks[:, t:t + 1], caches, t)
        err = float((logits[:, 0] - full[:, t]).abs().max())
        assert err < 2e-3, (arch, t, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_paths_and_dtypes_are_the_reference_tree(arch):
    """Every ``state_dict()`` path, shape and dtype is the reference's
    flattened tree's, at the smoke dtype and after ``to_dtype(bfloat16)``
    (the fp32 leaves stay fp32, as the reference's specs make them)."""
    import dataclasses as dc

    from repro.models.modules import shape_tree
    jspecs = jbuild(jsmoke_of(arch)).param_specs()
    tm = build(tconfigs.smoke_of(arch), device="cpu")
    want = flat_params(shape_tree(jspecs))
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == {
        k: tuple(v) for k, v in want.items()}
    jb = flat_params(jax.tree_util.tree_map(
        lambda sp: np.zeros((), sp.dtype),
        jbuild(dc.replace(jsmoke_of(arch), dtype="bfloat16")).param_specs(),
        is_leaf=lambda x: hasattr(x, "logical")))
    tm.to_dtype(torch.bfloat16)
    assert tm.cfg.dtype == "bfloat16"
    for path, p in tm.state_dict().items():
        assert str(p.dtype) == f"torch.{jb[path].dtype}", path


def test_model_state_dict_keys_are_reference_paths():
    tm = build(tconfigs.smoke_of("phi3-medium-14b"), device="cpu")
    cfg = tm.cfg
    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert shapes["layers.attn.wq"] == (cfg.n_layers, cfg.d_model,
                                        cfg.n_heads * cfg.head_dim)
    assert shapes["embed"] == (cfg.padded_vocab, cfg.d_model)
    assert shapes["layers.mlp.wi"] == (cfg.n_layers, cfg.d_model,
                                       2 * cfg.d_ff)
    with pytest.raises(ValueError, match="missing"):
        model_params_from_reference({"embed": np.zeros((1, 1))}, cfg,
                                    device="cpu")
