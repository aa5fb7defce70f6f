"""Training on the port against the reference's, on the CPU.

``lm_loss``, the loss and every parameter's gradient of ``Model.loss_fn``
for the smoke configs of all ten architectures (one parameter set, the
reference's, carried across), AdamW, one Trainer step with the spectral
clip, gradient accumulation, the data pipeline, checkpoints (the port's own
and the reference's), the restart drill, the straggler monitor, the spectral
monitor and the launcher.  Tolerances, each at fp32 (the two frameworks sum
in different orders):

* losses within 1e-5 of max(1, |want|);
* gradients: each leaf within 3e-3 of its largest |want| entry (the
  largest reading is whisper's cross-attention keys, 1.5e-3, summed over
  its encoder frames; the others read 5e-6 to 2.5e-4, and the port's own
  fp32 gradients of granite-3-2b read up to 3.5e-4 from its fp64 ones);
* the optimizer's parameters, m and v, from the same gradients, within
  1e-5 of max(1, max|want|); lr and grad_norm within 1e-5 relative (a
  Trainer step's grad_norm at accum 2: 1e-4, the gradients' rounding);
* after Trainer steps, which carry the gradients' rounding: m and v within
  3e-3 of each leaf's largest |want| entry, as the gradients; the
  parameters within 2e-2 of the peak lr where the gradient is well above
  its rounding (``STEP_TOL``, ``_params_close``);
* batches, checkpoints and the restart drill bit for bit.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import LM_ARCHS, flat_params, lm_models

from repro.configs.base import smoke_of as jsmoke_of
from repro.models import build as jbuild
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import spectral as jspec
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import smoke_of
from repro_torch.convert import (model_params_from_reference,
                                 train_state_from_reference)
from repro_torch.launch import train as launch_train
from repro_torch.models import build
from repro_torch.models import transformer as ttf
from repro_torch.parallel.compression import CompressionConfig
from repro_torch.train import (AdamWConfig, DataConfig, FailureInjector,
                               Prefetcher, StragglerMonitor, Trainer,
                               batch_at, checkpoint, run_with_restarts)
from repro_torch.train import optimizer as topt
from repro_torch.train import spectral as tspec
from repro_torch.train.data import host_slice
from repro_torch.train.tree import items

torch.set_num_threads(2)

LOSS_TOL, GRAD_TOL, STATE_TOL = 1e-5, 3e-3, 1e-5
# The Trainer's parameters after AdamW steps, in units of the peak lr.  An
# entry moves by lr * m_hat / (sqrt(v_hat) + eps) a step, about lr * sign(g)
# at the first: where |g| is near the gradients' rounding (GRAD_TOL of the
# leaf's largest entry) the two packages may move it opposite ways.  So
# entries whose m is at least 1e-2 of the leaf's largest |m| are held to
# STEP_TOL * lr, and every entry to 2 * lr a step, the most two steps can
# differ.
STEP_TOL = 2e-2


def _params_close(got_tree, want_p, want_m, lr, steps):
    for path, leaf in items(got_tree):
        name = ".".join(path)
        err = np.abs(_np(leaf) - _np(want_p[name]))
        m = np.abs(_np(want_m[name]))
        held = m >= 1e-2 * m.max()
        assert err[held].max(initial=0.0) <= STEP_TOL * lr, (name, err.max())
        assert err.max() <= 2 * lr * steps, (name, err.max())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def _close(got, want, tol):
    want = _np(want)
    err = float(np.max(np.abs(_np(got) - want))) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max(initial=0.0))), err


def _tree_close(got_tree, want_flat, tol, leaf_scale=False):
    """Every leaf of the port's tree against the reference's flattened
    {"a.b": array}: within tol of max(1, max|want|), or with
    ``leaf_scale`` of the leaf's own max|want| (m and v, which carry the
    gradients' rounding)."""
    for path, leaf in items(got_tree):
        want = _np(want_flat[".".join(path)])
        if leaf_scale:
            err = float(np.abs(_np(leaf) - want).max())
            assert err <= tol * float(np.abs(want).max()), (path, err)
        else:
            _close(leaf, want, tol)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "mask": (rng.random((b, s)) < 0.8).astype(np.float32)}
    if cfg.n_img_tokens:
        out["images"] = rng.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.kind == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads(model, batch, **kw):
    loss, metrics = model.loss_fn(batch, **kw)
    leaves = [leaf for _, leaf in items(model.params)]
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True,
                                allow_unused=True)
    return loss, metrics, {".".join(p): g for (p, _), g in
                           zip(items(model.params), grads)}


def _ref_state(arch, seed=0):
    """The reference's Trainer state of a smoke config, flattened as its
    checkpoints flatten it ({"params|...": array})."""
    jm = jbuild(jsmoke_of(arch))
    state = JTrainer(jm, jopt.AdamWConfig()).init_state(
        jax.random.PRNGKey(seed))
    return jm, state, jckpt._flatten(state)


# ---------------------------------------------------------------------------
# the loss and the gradients
# ---------------------------------------------------------------------------

def test_lm_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32)
    aux = {"aux_loss": np.float32(0.25), "router_zloss": np.float32(0.125)}
    for m, a in ((None, None), (mask, aux), (np.zeros_like(mask), aux)):
        want, wmet = jtf.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                                 None if m is None else jnp.asarray(m),
                                 None if a is None else {
                                     k: jnp.asarray(v) for k, v in a.items()})
        got, met = ttf.lm_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if m is None else torch.from_numpy(m),
                               None if a is None else {
                                   k: torch.tensor(v) for k, v in a.items()})
        _close(got, want, LOSS_TOL)
        assert sorted(met) == sorted(wmet)
        for k in met:
            _close(met[k], wmet[k], LOSS_TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """``Model.loss_fn`` and the gradient of every parameter (tied
    embeddings, MoE routers and experts, mamba, RWKV, whisper's encoder)
    against ``jax.value_and_grad`` of the reference's ``loss_fn`` from the
    same parameters; the masked batch keeps aux terms in the loss."""
    jm, params, _ = lm_models(arch)
    cfg = smoke_of(arch)
    tm = model_params_from_reference(flat_params(params), cfg, device="cpu")
    tm.requires_grad_(True)
    batch = _batch(cfg, 2, 24, 3)
    (want, wmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(params, _jbatch(batch))
    loss, metrics, grads = _grads(tm, batch)
    _close(loss, want, LOSS_TOL)
    for k in wmet:
        _close(metrics[k], wmet[k], LOSS_TOL)
    want_g = flat_params(jgrads)
    assert sorted(grads) == sorted(want_g)
    for name, g in grads.items():
        w = _np(want_g[name])
        err = float(np.abs(_np(g) - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()), (name, err)


def test_pixtral_head_width_160_loss_and_grads_match_reference():
    """pixtral-12b's smoke config narrowed to its published head width,
    160 (d_model 320, 2 heads, 1 KV head, 2 layers, with its image
    tokens): the loss and every gradient against ``jax.value_and_grad`` of
    the reference's ``loss_fn``, through the plain flash backward at D =
    160 on the CPU, at the file's tolerances."""
    from torch_port_common import _perturbed
    narrow = dict(d_model=320, n_heads=2, n_kv=1, n_layers=2)
    jcfg = dataclasses.replace(jsmoke_of("pixtral-12b"), **narrow)
    cfg = dataclasses.replace(smoke_of("pixtral-12b"), **narrow)
    assert jcfg.head_dim == cfg.head_dim == 160
    jm = jbuild(jcfg)
    params = _perturbed(jm.init(jax.random.PRNGKey(1)),
                        np.random.default_rng(2))
    tm = model_params_from_reference(flat_params(params), cfg, device="cpu")
    tm.requires_grad_(True)
    batch = _batch(cfg, 2, 20, 6)
    (want, wmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(params, _jbatch(batch))
    loss, metrics, grads = _grads(tm, batch)
    _close(loss, want, LOSS_TOL)
    for k in wmet:
        _close(metrics[k], wmet[k], LOSS_TOL)
    want_g = flat_params(jgrads)
    assert sorted(grads) == sorted(want_g)
    for name, g in grads.items():
        w = _np(want_g[name])
        err = float(np.abs(_np(g) - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()), (name, err)


def test_remat_gives_the_same_gradients():
    """``remat="full"`` (one checkpoint a layer) against no remat, through
    the decoder and whisper's encoder and decoder: bit for bit."""
    for arch in ("granite-3-2b", "whisper-medium"):
        _, params, _ = lm_models(arch)
        base = smoke_of(arch)
        batch = _batch(base, 2, 16, 4)
        out = []
        for remat in ("none", "full"):
            cfg = dataclasses.replace(base, remat=remat)
            tm = model_params_from_reference(flat_params(params), cfg,
                                             device="cpu")
            tm.requires_grad_(True)
            out.append(_grads(tm, batch))
        assert torch.equal(out[0][0], out[1][0])
        for name in out[0][2]:
            assert torch.equal(out[0][2][name], out[1][2][name]), name


# ---------------------------------------------------------------------------
# the optimizer and the Trainer
# ---------------------------------------------------------------------------

def test_cosine_schedule_matches_reference():
    cfg = AdamWConfig(peak_lr=1.0, min_lr=0.1, warmup_steps=10,
                      total_steps=100)
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        got = topt.cosine_lr(cfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got, jopt.cosine_lr(jcfg, jnp.asarray(s, jnp.int32)), 1e-7)


def test_adamw_update_matches_reference():
    """One update from a state part-way through training, on a tree with a
    stacked leaf (per-layer sigma), a matrix, a vector (no decay, no
    spectral clip) and a leaf whose sigma is None; the spectral clip at 0.5
    and the global clip both acting."""
    rng = np.random.default_rng(0)
    shapes = {"layers": {"w": (3, 6, 5), "g": (3, 5)}, "head": (5, 7),
              "bias": (7,)}

    def tree(f):
        return {k: tree_of(v, f) for k, v in shapes.items()}

    def tree_of(v, f):
        return {k: f(s) for k, s in v.items()} if isinstance(v, dict) \
            else f(v)
    params = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = tree(lambda s: 3 * rng.standard_normal(s).astype(np.float32))
    m = tree(lambda s: 0.1 * rng.standard_normal(s).astype(np.float32))
    v = tree(lambda s: rng.random(s).astype(np.float32) * 0.01)
    sigma = {"layers": {"w": np.array([1.5, 2.0, 0.5], np.float32),
                        "g": None},
             "head": np.float32(3.0), "bias": None}
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=3, total_steps=50,
                      spectral_clip=0.5, clip_norm=1.0)
    jstate = {"step": jnp.asarray(4, jnp.int32),
              "m": jax.tree_util.tree_map(jnp.asarray, m),
              "v": jax.tree_util.tree_map(jnp.asarray, v)}
    jp, js, jmet = jopt.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, grads), jstate,
        jopt.AdamWConfig(**dataclasses.asdict(cfg)),
        jax.tree_util.tree_map(lambda x: None if x is None else
                               jnp.asarray(x), sigma,
                               is_leaf=lambda x: x is None))

    def t(tree):
        return {k: t(v) if isinstance(v, dict) else
                (None if v is None else torch.from_numpy(np.array(v)))
                for k, v in tree.items()}
    tp = t(params)
    state = {"step": torch.tensor(4, dtype=torch.int32), "m": t(m),
             "v": t(v)}
    out_p, out_s, met = topt.adamw_update(tp, t(grads), state, cfg, t(sigma))
    assert out_p is tp and out_s is state and int(state["step"]) == 5
    _tree_close(out_p, flat_params(jp), STATE_TOL)
    _tree_close(out_s["m"], flat_params(js["m"]), STATE_TOL)
    _tree_close(out_s["v"], flat_params(js["v"]), STATE_TOL)
    for k in ("lr", "grad_norm"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5)


def _one_step_both(arch, accum=1, spectral=True):
    """One step of the reference's Trainer and of the port's, from one
    state, on the same batch, with the spectral monitor's sigma where
    ``spectral``.  Returns the reference's (state, metrics), the port's and
    the monitors."""
    jm, jstate, flat = _ref_state(arch)
    cfg = smoke_of(arch)
    opt = AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10,
                      spectral_clip=0.5 if spectral else 0.0)
    jopt_cfg = jopt.AdamWConfig(**dataclasses.asdict(opt))
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=5)
    np_batch = batch_at(dc, 3)
    mon_cfg = dict(every=1, size=16, bw=4)
    jmon = jspec.SpectralMonitor(jspec.SpectralMonitorConfig(
        backend="ref", **mon_cfg))
    tmon = tspec.SpectralMonitor(tspec.SpectralMonitorConfig(**mon_cfg))
    jsig = tsig = None
    if spectral:
        jmon.maybe_refresh(0, jstate["params"])
        jsig = jmon.sigma_max_tree()
    jtr = JTrainer(jm, jopt_cfg, accum=accum)
    jnew, jmet = jax.jit(jtr.make_train_step())(jstate, _jbatch(np_batch),
                                                jsig)
    model, state = train_state_from_reference(flat, cfg, device="cpu")
    if spectral:
        tmon.maybe_refresh(0, state["params"])
        tsig = tmon.sigma_max_tree()
    tr = Trainer(model, opt, accum=accum)
    new, met = tr.make_train_step()(state, np_batch, tsig)
    return (jnew, jmet), (new, met), (jmon, tmon)


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-moe-3b-a800m"])
def test_trainer_step_matches_reference(arch):
    """A Trainer step (loss, grad_norm, lr, and the parameters, m and v
    after it) from the reference's initial state, the spectral clip fed by
    each package's monitor, whose spectra agree too."""
    (jnew, jmet), (new, met), (jmon, tmon) = _one_step_both(arch)
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5), k
    _params_close(new["params"], flat_params(jnew["params"]),
                  flat_params(jnew["opt"]["m"]), 1e-2, 1)
    _tree_close(new["opt"]["m"], flat_params(jnew["opt"]["m"]), GRAD_TOL,
                leaf_scale=True)
    _tree_close(new["opt"]["v"], flat_params(jnew["opt"]["v"]), GRAD_TOL,
                leaf_scale=True)
    assert int(new["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    want = flat_params(jax.tree_util.tree_map(
        lambda s: np.zeros(0) if s is None else np.asarray(s),
        jmon.sigma_tree, is_leaf=lambda x: x is None))
    for path, sig in items(tmon.sigma_tree):
        w = want[".".join(path)]
        if sig is None:
            assert w.size == 0
        else:
            _close(sig, w, 1e-5)
    got_m, want_m = tmon.metrics(), jmon.metrics()
    assert sorted(got_m) == sorted(want_m)
    for k in got_m:
        assert got_m[k] == pytest.approx(want_m[k], rel=1e-4, abs=1e-6), k


def test_grad_accumulation_matches_full_batch():
    """accum=2 (two microbatches, fp32 sums / 2) against accum=1, as the
    reference's test of the same name; and the step against the
    reference's at accum=2."""
    cfg = smoke_of("granite-3-2b")
    model = build(cfg, device="cpu")
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10,
                      clip_norm=0)
    params = Trainer(model, opt).init_state(
        torch.Generator().manual_seed(0))["params"]
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=5)
    batch = {k: torch.from_numpy(v) for k, v in batch_at(dc, 0).items()}
    out = [Trainer(model, opt, accum=a)._grads(params, batch) for a in (1, 2)]
    assert float(out[1][0]) == pytest.approx(float(out[0][0]), rel=1e-6)
    scale = max(float(topt.global_norm(out[0][2])), 1.0)
    for (_, x), (_, y) in zip(items(out[0][2]), items(out[1][2])):
        assert y.dtype == torch.float32
        np.testing.assert_allclose(_np(x), _np(y), atol=1e-5 * scale)
    (jnew, jmet), (new, met), _ = _one_step_both("granite-3-2b", accum=2,
                                                 spectral=False)
    for k in ("loss", "grad_norm"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-4), k
    _params_close(new["params"], flat_params(jnew["params"]),
                  flat_params(jnew["opt"]["m"]), 1e-2, 1)


def test_trainer_refuses_what_parallel_would_give():
    """What ``parallel/`` does not give: a "model" axis larger than 1 and
    an MoE config under a mesh (ROADMAP item 12.5), and compression
    without a mesh, from the Trainer and from the launcher."""
    class Mesh:
        shape = {"data": 2, "model": 2}
    model = build(smoke_of("granite-3-2b"), device="cpu")
    with pytest.raises(NotImplementedError, match="12.5"):
        Trainer(model, AdamWConfig(), mesh=Mesh())
    Mesh.shape = {"data": 2}
    moe = build(smoke_of("granite-moe-3b-a800m"), device="cpu")
    with pytest.raises(NotImplementedError, match="12.5"):
        Trainer(moe, AdamWConfig(), mesh=Mesh())
    with pytest.raises(ValueError, match="mesh="):
        Trainer(model, AdamWConfig(), compression=CompressionConfig())
    with pytest.raises(ValueError, match="mesh="):
        launch_train.main(["--arch", "granite-3-2b", "--smoke", "--device",
                           "cpu", "--compress-rank", "2"])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,s,b,seed", [(199, 16, 4, 5), (49155, 64, 8, 17),
                                            (1000, 33, 3, 0)])
def test_batch_at_is_the_references_bit_for_bit(vocab, s, b, seed):
    cfg = DataConfig(vocab=vocab, seq_len=s, global_batch=b, seed=seed)
    jcfg = jdata.DataConfig(vocab=vocab, seq_len=s, global_batch=b, seed=seed)
    for step in (0, 1, 42):
        got, want = batch_at(cfg, step), jdata.batch_at(jcfg, step)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        for h in range(2):
            sl, wsl = host_slice(got, h, 2), jdata.host_slice(want, h, 2)
            for k in sl:
                np.testing.assert_array_equal(sl[k], wsl[k])


def test_prefetcher_orders_steps_on_its_device():
    dc = DataConfig(vocab=50, seq_len=4, global_batch=2, seed=1)
    pf = Prefetcher(dc, start_step=5, device="cpu")
    try:
        s0, b0 = pf.next()
        s1, _ = pf.next()
        assert (s0, s1) == (5, 6)
        assert isinstance(b0["tokens"], torch.Tensor)
        np.testing.assert_array_equal(b0["tokens"].numpy(),
                                      batch_at(dc, 5)["tokens"])
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# checkpoints, restarts, stragglers
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_keep(tmp_path):
    """fp32, bf16 (stored as its bits) and int leaves back bit for bit,
    into the template's own tensors; keep-N prunes."""
    rng = np.random.default_rng(0)
    state = {"a": torch.from_numpy(rng.standard_normal((2, 3))).float(),
             "b": {"c": torch.tensor(7, dtype=torch.int32),
                   "w": torch.from_numpy(rng.standard_normal((5, 4)))
                   .bfloat16()}}
    for s in (1, 2, 3, 4):
        checkpoint.save(str(tmp_path), s, state, keep=2)
    assert checkpoint.latest_step(str(tmp_path)) == 4
    assert sorted(checkpoint._complete_steps(str(tmp_path))) == [3, 4]
    with np.load(tmp_path / "step_00000004" / "state.npz") as z:
        assert sorted(z.files) == ["__bfloat16__", "a", "b|c", "b|w"]
    template = {"a": torch.zeros(2, 3), "b": {
        "c": torch.tensor(0, dtype=torch.int32),
        "w": torch.zeros(5, 4, dtype=torch.bfloat16)}}
    w = template["b"]["w"]
    out = checkpoint.restore(str(tmp_path), 4, template)
    assert out is template and out["b"]["w"] is w
    for path, leaf in items(state):
        got = out[path[0]] if len(path) == 1 else out[path[0]][path[1]]
        assert got.dtype == leaf.dtype and torch.equal(got, leaf)


def test_incomplete_checkpoint_ignored(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"x": torch.ones(3)})
    os.makedirs(tmp_path / "step_00000002")         # a torn write: no DONE
    np.savez(tmp_path / "step_00000002" / "state.npz", x=np.ones(3))
    os.makedirs(tmp_path / "step_00000003.tmp")
    assert checkpoint.latest_step(str(tmp_path)) == 1


def test_async_checkpointer(tmp_path):
    ac = checkpoint.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in range(4):
        ac.submit(s, {"w": torch.full((4,), float(s))})
    ac.close()
    last = checkpoint.latest_step(str(tmp_path))
    assert last is not None
    out = checkpoint.restore(str(tmp_path), last, {"w": torch.zeros(4)})
    np.testing.assert_array_equal(out["w"].numpy(), np.full(4, float(last)))


def test_reference_checkpoint_restores_and_continues(tmp_path):
    """The reference trains two steps and checkpoints (fp32); the port
    restores that checkpoint into a fresh state of its own and both
    continue two steps on the same batches: the same parameters and
    optimizer state, within STEP_TOL and GRAD_TOL."""
    arch = "granite-3-2b"
    cfg = smoke_of(arch)
    opt = AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10)
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=9)
    jm, jstate, _ = _ref_state(arch, seed=3)
    jstep = jax.jit(JTrainer(jm, jopt.AdamWConfig(
        **dataclasses.asdict(opt))).make_train_step())
    for step in range(4):
        if step == 2:
            jckpt.save(str(tmp_path), 2, jstate)
        jstate, _ = jstep(jstate, _jbatch(batch_at(dc, step)), None)
    model = build(cfg, device="cpu")
    tr = Trainer(model, opt)
    state = tr.init_state(torch.Generator().manual_seed(0))
    state = checkpoint.restore(str(tmp_path),
                               checkpoint.latest_step(str(tmp_path)), state)
    assert int(state["opt"]["step"]) == 2
    for step in (2, 3):
        state, _ = tr.step(state, batch_at(dc, step))
    _params_close(state["params"], flat_params(jstate["params"]),
                  flat_params(jstate["opt"]["m"]), 1e-2, 2)
    _tree_close(state["opt"]["m"], flat_params(jstate["opt"]["m"]), GRAD_TOL,
                leaf_scale=True)
    _tree_close(state["opt"]["v"], flat_params(jstate["opt"]["v"]), GRAD_TOL,
                leaf_scale=True)


def test_train_state_from_reference_checks_keys():
    _, _, flat = _ref_state("granite-3-2b")
    model, state = train_state_from_reference(flat, smoke_of("granite-3-2b"),
                                              device="cpu")
    assert state["params"]["embed"] is model.params["embed"]
    assert model.params["embed"].requires_grad
    np.testing.assert_array_equal(state["opt"]["m"]["embed"].numpy(),
                                  flat["opt|m|embed"])
    del flat["opt|v|embed"]
    with pytest.raises(ValueError, match="opt"):
        train_state_from_reference(flat, smoke_of("granite-3-2b"),
                                   device="cpu")


def test_restart_bit_exact(tmp_path):
    """Crash at step 7 -> restore -> final state identical to a clean run,
    bit for bit (the reference's test of the same name)."""
    cfg = smoke_of("granite-3-2b")
    model = build(cfg, device="cpu")
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=9)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=20)

    def driver(ckpt_dir, injector):
        tr = Trainer(model, opt)
        return run_with_restarts(
            total_steps=12, ckpt_dir=ckpt_dir,
            make_state=lambda: tr.init_state(torch.Generator().manual_seed(0)),
            restore_state=lambda step, t: checkpoint.restore(ckpt_dir, step,
                                                             t),
            step_fn=lambda step, state: tr.step(state, batch_at(dc, step)),
            save_every=5, injector=injector)

    clean, _, r0 = driver(str(tmp_path / "clean"), FailureInjector())
    clean = {".".join(p): x.detach().clone() for p, x in items(clean)}
    crash, _, r1 = driver(str(tmp_path / "crash"),
                          FailureInjector(fail_at=(7,)))
    assert r0 == 0 and r1 == 1
    for path, x in items(crash):
        assert torch.equal(x, clean[".".join(path)]), path


def test_straggler_monitor_flags():
    mon = StragglerMonitor(threshold=2.0)
    for s in range(10):
        mon.record(s, 1.0)
    assert mon.record(10, 5.0) is True
    assert mon.flagged == [10]
    assert mon.record(11, 1.1) is False


# ---------------------------------------------------------------------------
# the spectral monitor
# ---------------------------------------------------------------------------

def test_spectral_metrics_and_monitor_match_reference():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((48, 48))
    stacked = rng.standard_normal((3, 20, 30))
    params = {"layer": {"w": w, "s": stacked}, "bias": np.zeros(8)}
    cfg = dict(every=5, size=48, bw=8)
    mon = tspec.SpectralMonitor(tspec.SpectralMonitorConfig(**cfg))
    jmon = jspec.SpectralMonitor(jspec.SpectralMonitorConfig(backend="ref",
                                                             **cfg))
    tparams = {"layer": {k: torch.from_numpy(v) for k, v in
                         params["layer"].items()},
               "bias": torch.from_numpy(params["bias"])}
    assert mon.maybe_refresh(0, tparams)
    assert not mon.maybe_refresh(3, tparams)
    assert mon.maybe_refresh(5, tparams)
    jmon.maybe_refresh(0, jax.tree_util.tree_map(jnp.asarray, params))
    s_ref = np.linalg.svd(w, compute_uv=False)
    _close(mon.sigma_tree["layer"]["w"], s_ref, 1e-10)
    _close(mon.sigma_tree["layer"]["s"], jmon.sigma_tree["layer"]["s"], 1e-10)
    assert mon.sigma_tree["layer"]["s"].shape == (3, 48)
    sm = mon.sigma_max_tree()
    assert float(sm["layer"]["w"]) == pytest.approx(s_ref[0], rel=1e-9)
    assert sm["bias"] is None and sm["layer"]["s"].shape == (3,)
    got, want = mon.metrics(), jmon.metrics()
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k
    m = tspec.spectral_metrics(torch.from_numpy(s_ref))
    jm = jspec.spectral_metrics(jnp.asarray(s_ref))
    for k in m:
        _close(m[k], jm[k], 1e-6)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_train_smoke_loss_falls(tmp_path, capsys):
    out = launch_train.main(["--arch", "granite-3-2b", "--smoke", "--steps",
                             "20", "--device", "cpu", "--log-every", "5",
                             "--accum", "2", "--spectral-every", "10",
                             "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out.splitlines()
    lines = [json.loads(t) for t in text if t.startswith("{")]
    assert [ln["step"] for ln in lines] == [0, 5, 10, 15, 19]
    assert all(sorted(ln) == ["grad_norm", "loss", "lr", "sigma0", "step"]
               for ln in lines)
    assert lines[-1]["loss"] < lines[0]["loss"]
    assert text[-1].startswith("done: 20 steps in ")
    assert out["lines"] == lines and len(out["step_s"]) == 20
    assert checkpoint.latest_step(str(tmp_path)) == 20
    # a second run resumes from the checkpoint and does nothing more
    launch_train.main(["--arch", "granite-3-2b", "--smoke", "--steps", "20",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert "resumed from step 20" in capsys.readouterr().out
