"""``parallel/`` on torch.distributed against the reference's, on the CPU.

* Specs: ``AxisRules.spec`` of every parameter and batch input of the ten
  configs (smoke and full shapes), under ``_SINGLE`` and ``_MULTI``, on
  meshes (data), (data, model) and (pod, data, model): the port's entries
  equal the reference's.  ``zero1_shardings`` at dp in {2, 4, 8} against
  the reference's on 8 host devices (a subprocess).  ``Model.param_logical``
  and ``param_shapes`` against the reference's.
* One process group of four CPU ranks on gloo
  (``tests/torch_parallel_worker.py``, each rank one thread) runs, in turn:
  ``compress_and_sync`` over two warm-started rounds, against the
  reference's under ``jax.vmap`` over a named axis (G_hat and err within
  1e-5 of their largest entry at fp32, Q' up to its columns' signs, the
  compression ratio exactly); the ZeRO-1 step of llama3-8b's smoke config
  on a data mesh (accum 1 with a random mask, accum 2 with and without
  one, a sigma tree) and on a (pod 2, data 2) mesh under
  ``MULTIPOD_RULES``, two steps each, each against the reference's
  Trainer step (GSPMD with ZeRO-1 on as many host devices, in a process
  beside the group) and the port's one-process Trainer step on the global
  batch from the same state; the compressed step (the reference's
  ``test_compressed_train_step_8dev`` at data = 4) against the reference's
  own, each step from the reference's state before it, carried across by
  ``convert``; the elastic restore both ways, against the reference's
  restore and step; and the refusals that need a process group.  The
  group has ``GROUP_TIMEOUT_S``, its process group
  ``launch.mesh.DIST_TIMEOUT_S``.

Steps are held as ``tests/test_torch_train.py`` holds Trainer steps: loss
and grad_norm within ``LOSS_TOL``, m and v within ``GRAD_TOL`` of each
leaf's largest entry, the parameters by ``_params_close`` (a data-parallel
mean sums in another order than one process, and AdamW's first step moves
an entry by about lr * sign(g), so a gradient at its rounding may move the
two ways).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch_parallel_worker as W
from test_torch_train import (GRAD_TOL, LOSS_TOL, _close, _params_close,
                              _tree_close)

from repro.configs.base import get_config as jget_config
from repro.configs.base import list_configs
from repro.configs.base import smoke_of as jsmoke_of
from repro.configs.shapes import SUITES as JSUITES
from repro.models import batch_logical as jbatch_logical
from repro.models import build as jbuild
from repro.parallel import compression as jcomp
from repro.parallel import sharding as jshard
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.configs import SUITES, get_config, smoke_of
from repro_torch.models import batch_logical, build
from repro_torch.parallel import sharding as tshard
from repro_torch.parallel.compression import CompressionConfig
from repro_torch.train import AdamWConfig, Trainer, batch_at, checkpoint
from repro_torch.train.tree import items

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
WORLD = 4
GROUP_TIMEOUT_S = 300
ARCHS = list_configs()
MESHES = [{"data": 4}, {"data": 4, "model": 2},
          {"pod": 2, "data": 4, "model": 2}]
# grad_norm of a step from a state past the init, the port's against the
# reference's: held as m and v are (see test_sharded_step_matches_reference)
_GRAD_NORM_TOL_PAST_INIT = GRAD_TOL


class FakeMesh:
    """A mesh's shape, all that ``AxisRules.spec`` reads, for both
    packages."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _entries(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict whose leaves are tuples."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------------------------------------------------------------------------
# the rules and the specs
# ---------------------------------------------------------------------------

def test_rules_spec_resolution():
    """The reference's asserts of the same name, on the port's rules."""
    P = tshard.P
    r = tshard.AxisRules(tshard._SINGLE)
    assert r.spec(("batch", None, None)) == P(("data",), None, None)
    assert r.spec((None, "model_out")) == P(None, "model")
    # duplicate physical axis is dropped on second use
    assert r.spec(("heads", "kv_heads")) == P("model", None)
    # unknown logical name -> replicated
    assert r.spec(("nope",)) == P(None)
    assert tshard._SINGLE == jshard._SINGLE
    assert tshard._MULTI == jshard._MULTI


def test_multipod_rules_batch_axes():
    r = tshard.AxisRules(tshard._MULTI)
    assert r.spec(("batch",)) == tshard.P(("pod", "data"))
    assert tuple(r.spec(("batch",))) == tuple(jshard.AxisRules(
        jshard._MULTI).spec(("batch",)))


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    """Every parameter's and batch input's spec, the port's against the
    reference's, entry for entry."""
    for variant in (jsmoke_of, jget_config):
        jcfg = variant(arch)
        cfg = (smoke_of if variant is jsmoke_of else get_config)(arch)
        jlog = _leaves(jbuild(jcfg).param_logical())
        tlog = _leaves(build(cfg, device="meta").param_logical())
        assert sorted(jlog) == sorted(tlog)
        for suite in SUITES:
            jlog.update({f"batch.{suite}.{k}": v for k, v in
                         jbatch_logical(jcfg, JSUITES[suite]).items()})
            tlog.update({f"batch.{suite}.{k}": v for k, v in
                         batch_logical(cfg, SUITES[suite]).items()})
        for shape in MESHES:
            for jtab, ttab in ((jshard._SINGLE, tshard._SINGLE),
                               (jshard._MULTI, tshard._MULTI)):
                jr = jshard.AxisRules(jtab, mesh=FakeMesh(shape))
                tr = tshard.AxisRules(ttab, mesh=FakeMesh(shape))
                for name, logical in jlog.items():
                    assert tuple(tr.spec(tlog[name])) == tuple(
                        jr.spec(logical)), (arch, shape, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_logical_and_shapes_match_reference(arch):
    """``Model.param_logical()`` and ``param_shapes()`` against the
    reference's, at the smoke config (a model on the CPU) and the full one
    (on the meta device: shapes only)."""
    for jcfg, model in ((jsmoke_of(arch), build(smoke_of(arch),
                                                device="cpu")),
                        (jget_config(arch), build(get_config(arch),
                                                  device="meta"))):
        jm = jbuild(jcfg)
        assert _leaves(model.param_logical()) == _leaves(jm.param_logical())
        assert _leaves(model.param_shapes()) == _leaves(jm.param_shapes())
        for name, p in model.state_dict().items():
            assert tuple(p.shape) == _leaves(model.param_shapes())[name]


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if smoke_of(a).kind != "moe"])
def test_trainer_shardings_match_reference_specs(arch):
    """``Trainer.state_shardings``' parameter specs and
    ``batch_shardings``' specs under a (pod, data) mesh against the
    reference's rules; m and v are ZeRO-1's (held above)."""
    class Mesh(FakeMesh):
        coords = {"pod": 0, "data": 1}
    mesh = Mesh({"pod": 2, "data": 2})
    tr = Trainer(build(smoke_of(arch), device="meta"), AdamWConfig(),
                 mesh=mesh)
    jr = jshard.AxisRules(jshard._MULTI, mesh=mesh)
    jm = jbuild(jsmoke_of(arch))
    got = _leaves(tr.state_shardings()["params"])
    for name, logical in _leaves(jm.param_logical()).items():
        assert tuple(got[name].spec) == tuple(jr.spec(logical)), name
    for suite in SUITES:
        got = tr.batch_shardings(SUITES[suite])
        want = jbatch_logical(jm.cfg, JSUITES[suite])
        assert sorted(got) == sorted(want)
        for k, logical in want.items():
            assert tuple(got[k].spec) == tuple(jr.spec(logical)), (suite, k)
            assert got[k].mesh is mesh


ZERO1_CODE = """
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs.base import get_config, list_configs, smoke_of
from repro.models import build
from repro.parallel.sharding import AxisRules, _SINGLE, _MULTI, zero1_shardings
out = {}
for arch in list_configs():
    for variant, make in (("smoke", smoke_of), ("full", get_config)):
        m = build(make(arch))
        logical, shapes = m.param_logical(), m.param_shapes()
        for dp in (2, 4, 8):
            cases = [((dp,), ("data",), _SINGLE, ("data",)),
                     ((dp, 8 // dp), ("data", "model"), _SINGLE, ("data",))]
            if 2 * dp <= 8:
                cases.append(((2, dp), ("pod", "data"), _MULTI,
                              ("pod", "data")))
            for shape, axes, table, dp_axes in cases:
                devs = np.array(jax.devices()[:int(np.prod(shape))])
                mesh = Mesh(devs.reshape(shape), axes)
                sh = zero1_shardings(logical, shapes,
                                     AxisRules(table, mesh=mesh), dp_axes)
                flat = jax.tree_util.tree_flatten_with_path(sh)[0]
                out[f"{arch}|{variant}|{dp}|{','.join(axes)}"] = {
                    ".".join(str(p.key) for p in path):
                        [list(e) if isinstance(e, tuple) else e
                         for e in s.spec] for path, s in flat}
json.dump(out, open(sys.argv[1], "w"))
"""


def _subprocess_env(devices: int) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC), str(TESTS), env.get("PYTHONPATH", "")])
    return env


@pytest.fixture(scope="module")
def ref_zero1(tmp_path_factory):
    path = tmp_path_factory.mktemp("zero1") / "specs.json"
    r = subprocess.run([sys.executable, "-c", ZERO1_CODE, str(path)],
                       capture_output=True, text=True, timeout=300,
                       env=_subprocess_env(8))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.mark.distributed
@pytest.mark.parametrize("dp", [2, 4, 8])
def test_zero1_specs_match_reference(ref_zero1, dp):
    """ZeRO-1's spec of every parameter of the ten configs (smoke and
    full), against the reference's on a real mesh of host devices: on
    (data), (data, model) and, where it fits in 8, (pod, data) with both
    as dp axes."""
    n = 0
    for key, want in ref_zero1.items():
        arch, variant, d, axes = key.split("|")
        if int(d) != dp:
            continue
        axes = tuple(axes.split(","))
        sizes = {"data": (dp,), "data,model": (dp, 8 // dp),
                 "pod,data": (2, dp)}[",".join(axes)]
        mesh = FakeMesh(zip(axes, sizes))
        table = tshard._MULTI if "pod" in axes else tshard._SINGLE
        dp_axes = ("pod", "data") if "pod" in axes else ("data",)
        cfg = (smoke_of if variant == "smoke" else get_config)(arch)
        model = build(cfg, device="meta")
        got = _leaves(tshard.zero1_shardings(
            model.param_logical(), model.param_shapes(),
            tshard.AxisRules(table, mesh=mesh), dp_axes))
        got = {k: v.spec for k, v in got.items()}
        assert sorted(got) == sorted(want), key
        for name, spec in want.items():
            assert _entries(got[name]) == spec, (key, name)
        n += 1
    assert n == 2 * len(ARCHS) * (3 if 2 * dp <= 8 else 2)


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

REF_CODE = """
import json, os, sys, time
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import smoke_of
from repro.configs.shapes import SUITES
from repro.launch.mesh import rules_for
from repro.models import build
from repro.parallel.compression import CompressionConfig
from repro.train import AdamWConfig, Trainer, checkpoint
from repro.train.data import DataConfig, batch_at
import torch_parallel_worker as W
from repro_torch.configs import smoke_of as tsmoke_of
from repro_torch.models import build as tbuild
work, world = sys.argv[1], int(sys.argv[2])
AUTO = jax.sharding.AxisType.Auto
meshes = {"data": jax.make_mesh((world,), ("data",), axis_types=(AUTO,)),
          "pod_data": jax.make_mesh((2, world // 2), ("pod", "data"),
                                    axis_types=(AUTO,) * 2)}
cfg = smoke_of(W.ARCH)


def put(name, state, metrics):
    # the metrics first; the state renamed into place says both are whole
    json.dump(metrics, open(f"{work}/{name}.json", "w"))
    np.savez(f"{work}/{name}.tmp.npz", **checkpoint._flatten(state))
    os.replace(f"{work}/{name}.tmp.npz", f"{work}/{name}.npz")


def ready(ckpt, step):
    # a checkpoint the ranks write (its DONE marker comes last)
    deadline = time.monotonic() + 240
    while not os.path.exists(f"{ckpt}/step_{step:08d}/DONE"):
        assert time.monotonic() < deadline, (ckpt, step)
        time.sleep(0.1)
    return ckpt


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def floats(m):
    return {k: float(v) for k, v in m.items()}


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return None if tree is None else jnp.asarray(tree.numpy())


# the compressed steps, from the reference's own init and its first step
mesh = meshes["data"]
tr = Trainer(build(cfg), AdamWConfig(**W.REF_OPT), mesh=mesh,
             rules=rules_for(mesh), compression=CompressionConfig(**W.REF_COMP))
dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=1)
with mesh:
    template = tr.init_state(jax.random.PRNGKey(0))
    state = checkpoint.restore(work + "/ref_init", 0, template)
    step = jax.jit(tr.make_train_step())
    for t in range(2):
        state, m = step(state, jbatch(batch_at(dc, t)))
        put(f"ref_compressed{t + 1}", state, floats(m))

# the ZeRO-1 steps (GSPMD, m and v in zero1_shardings), each from the
# ranks' state before it
steps = {}
for tag, (axes, accum, batches, spectral) in W.SHARDED_CASES.items():
    mesh = meshes[axes]
    tr = Trainer(build(cfg), AdamWConfig(
        **W.OPT, spectral_clip=0.5 if spectral else 0.0), mesh=mesh,
        rules=rules_for(mesh), accum=accum)
    extra = ((to_jax(W.sigma_tree(tbuild(tsmoke_of(W.ARCH),
                                         device="meta"))),)
             if spectral else ())
    with mesh:
        template = tr.init_state(jax.random.PRNGKey(0))
        sh = tr.state_shardings(template)
        step = tr.jit_train_step(SUITES["train_4k"], template,
                                 with_sigma=spectral)
        for t, b in enumerate(batches):
            state = checkpoint.restore(ready(f"{work}/pre_{tag}", t), t,
                                       template, sh)
            state, m = step(state, jbatch(b), *extra)
            put(f"ref_{tag}{t + 1}", state, floats(m))
    steps[tag] = (mesh, template, sh, step)

# elastic: the one-process checkpoint onto the data mesh (the accum-1
# case's step), and the ranks' checkpoint onto one device
mesh, template, sh, step = steps["data4_accum1"]
with mesh:
    state = checkpoint.restore(work + "/ckpt_one", 1, template, sh)
    state, m = step(state, jbatch(W.batch_at(W.DATA, 1)))
    put("ref_elastic_in", state, floats(m))
tr = Trainer(build(cfg), AdamWConfig(**W.OPT))
template = tr.init_state(jax.random.PRNGKey(0))
state = checkpoint.restore(ready(work + "/ckpt_mesh", 1), 1, template)
state, m = jax.jit(tr.make_train_step())(state,
                                         jbatch(W.batch_at(W.DATA, 1)))
put("ref_elastic_out", state, floats(m))
"""


def _one_process(batches, restore_from=None):
    """The port's one-process Trainer of W.ARCH from seed W.SEED (or a
    checkpoint's step 1): (metrics of each step, {"params"|"m"|"v":
    {path: array}}, the state)."""
    model = build(smoke_of(W.ARCH), device="cpu")
    tr = Trainer(model, AdamWConfig(**W.OPT))
    state = tr.init_state(torch.Generator().manual_seed(
        W.SEED if restore_from is None else W.SEED + 1))
    if restore_from is not None:
        state = checkpoint.restore(restore_from, 1, state)
    metrics = []
    for b in batches:
        state, m = tr.step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _flat_state(state), state


def _flat_state(state) -> dict:
    def flat(tree):
        return {".".join(path): leaf.detach().numpy().copy()
                for path, leaf in items(tree)}
    return {"params": flat(state["params"]), "m": flat(state["opt"]["m"]),
            "v": flat(state["opt"]["v"])}


def _wait(procs, deadline):
    """Wait for every process until ``deadline``; kill all on a timeout
    or on the first failure.  Returns their (rc, stderr)."""
    out = [None] * len(procs)
    try:
        while any(o is None for o in out):
            for i, p in enumerate(procs):
                if out[i] is None and p.poll() is not None:
                    out[i] = (p.returncode, p.stderr.read())
                    if p.returncode != 0:
                        raise RuntimeError(f"process {i} failed:\n"
                                           f"{out[i][1][-4000:]}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"the process group took more than "
                                   f"{GROUP_TIMEOUT_S} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            p.stderr.close()
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Run the four ranks and the reference's steps (beside each other:
    the reference's compressed steps from its own state, its ZeRO-1 steps
    and restores from the ranks' checkpoints), and the one-process
    baselines meanwhile; returns every reading."""
    work = tmp_path_factory.mktemp("group")
    np.savez(work / "compress_inputs.npz", **W.compress_inputs(WORLD))
    # the reference's compressed Trainer state on a data mesh of WORLD,
    # made as its init_state makes it
    jm = jbuild(jsmoke_of(W.ARCH))
    params = jm.init(jax.random.PRNGKey(0))
    jckpt.save(str(work / "ref_init"), 0, {
        "params": params, "opt": jopt.adamw_init(params),
        "comp": jcomp.compression_init(jcomp.CompressionConfig(**W.REF_COMP),
                                       params, n_workers=WORLD)})
    # the one-process checkpoint that the ranks restore
    _, _, state = _one_process([batch_at(W.DATA, 0)])
    checkpoint.save(str(work / "ckpt_one"), 1, state)

    deadline = time.monotonic() + GROUP_TIMEOUT_S
    env = _subprocess_env(WORLD)
    procs = [subprocess.Popen(
        [sys.executable, "-c", REF_CODE, str(work), str(WORLD)], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)]
    env = dict(env, OMP_NUM_THREADS="1")
    procs += [subprocess.Popen(
        [sys.executable, str(TESTS / "torch_parallel_worker.py"), str(r),
         str(WORLD), str(work / "pg_init"), str(work)], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    try:
        base = {"elastic_in": _one_process([batch_at(W.DATA, 1)],
                                           str(work / "ckpt_one"))[:2]}
    finally:
        _wait(procs, deadline)
    base["elastic_out"] = _one_process([batch_at(W.DATA, 1)],
                                       str(work / "ckpt_mesh"))[:2]
    ranks = [(dict(np.load(work / f"rank{r}.npz")),
              json.loads((work / f"rank{r}.json").read_text()))
             for r in range(WORLD)]
    names = ([f"compressed{t}" for t in (1, 2)]
             + [f"{tag}{t}" for tag in W.SHARDED_CASES for t in (1, 2)]
             + ["elastic_in", "elastic_out"])
    ref = {n: (dict(np.load(work / f"ref_{n}.npz")),
               json.loads((work / f"ref_{n}.json").read_text()))
           for n in names}
    return {"base": base, "ranks": ranks, "work": work, "ref": ref}


def _by_prefix(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _ref_part(ref: dict, key: str) -> dict:
    return {k[len(key) + 1:].replace("|", "."): v for k, v in ref.items()
            if k.startswith(f"{key}|")}


def _hold(got_metrics, got, want_metrics, want, lr, steps,
          grad_norm_tol=LOSS_TOL):
    """Metrics (each the step's against the step ``want_metrics`` holds
    from the same state: the loss within LOSS_TOL, grad_norm within
    ``grad_norm_tol``) and the state after the last step, ``steps`` steps
    of drift allowed; ``got`` and ``want`` {"params"|"m"|"v": {path:
    array}}."""
    assert len(got_metrics) == len(want_metrics)
    for g, e in zip(got_metrics, want_metrics):
        _close(g["loss"], e["loss"], LOSS_TOL)
        _close(g["grad_norm"], e["grad_norm"], grad_norm_tol)
    _params_close(got["params"], want["params"], want["m"], lr, steps)
    _tree_close(got["m"], want["m"], GRAD_TOL, leaf_scale=True)
    _tree_close(got["v"], want["v"], GRAD_TOL, leaf_scale=True)


def _rank_state(arrays, tag) -> dict:
    return {part: _by_prefix(arrays, f"{tag}|{part}|")
            for part in ("params", "m", "v")}


def _flat_parts(flat: dict) -> dict:
    """{"params"|"m"|"v": {path: array}} of a flattened checkpoint."""
    return {"params": _ref_part(flat, "params"), "m": _ref_part(flat, "opt|m"),
            "v": _ref_part(flat, "opt|v")}


def _hold_step(arrays, info, tag, want_metrics, want, lr, steps,
               grad_norm_tol=LOSS_TOL):
    """A run's metrics and rank 0's state after its last step against
    ``want_metrics`` and ``want``."""
    _hold(info[tag]["metrics"], _rank_state(arrays, tag), want_metrics, want,
          lr, steps, grad_norm_tol)


def _replicas_equal(group, tag):
    """Every rank holds the same parameters, bit for bit."""
    a0 = _by_prefix(group["ranks"][0][0], f"{tag}|params|")
    for arrays, _ in group["ranks"][1:]:
        for k, v in _by_prefix(arrays, f"{tag}|params|").items():
            np.testing.assert_array_equal(v, a0[k])


def _ref_round(q, errs, grads):
    """The reference's compress_and_sync on WORLD workers: ``jax.vmap``
    over a named axis, whose pmean is the mean over the workers."""
    cfg = jcomp.CompressionConfig(**W.COMP_CFG)

    def one(g, e):
        st = {n: None if q[n] is None else {"q": q[n], "err": e[n]}
              for n in g}
        return jcomp.compress_and_sync(g, st, cfg, ("w",))
    return jax.vmap(one, axis_name="w")(grads, errs)


@pytest.mark.distributed
def test_compress_and_sync_matches_reference(group):
    src = dict(np.load(group["work"] / "compress_inputs.npz"))
    names = list(W.COMP_LEAVES)
    q = {n: src.get(f"q|{n}") for n in names}
    errs = {n: None if q[n] is None else src[f"err|{n}"][:, None]
            for n in names}
    for r in (1, 2):
        grads = {n: src[f"g{r}|{n}"] for n in names}
        g_ref, s_ref, stats = _ref_round(q, errs, grads)
        for rank, (arrays, info) in enumerate(group["ranks"]):
            assert info[f"compress_round{r}"]["compression_ratio"] == float(
                stats["compression_ratio"][rank])
            for n in names:
                want = np.asarray(g_ref[n][rank], np.float64)
                got = arrays[f"compress{r}|ghat|{n}"]
                scale = np.abs(want).max()
                assert np.abs(got - want).max() <= 1e-5 * scale, (r, n)
                np.testing.assert_array_equal(
                    got, group["ranks"][0][0][f"compress{r}|ghat|{n}"])
                if q[n] is None:
                    continue
                werr = np.asarray(s_ref[n]["err"][rank, 0], np.float64)
                gerr = arrays[f"compress{r}|err|{n}"]
                assert np.abs(gerr - werr).max() <= 1e-5 * np.abs(
                    werr).max(), (r, n)
                wq = np.asarray(s_ref[n]["q"][rank], np.float64)
                gq = arrays[f"compress{r}|q|{n}"]
                sign = np.sign(np.sum(gq * wq, axis=-2, keepdims=True))
                assert np.abs(gq * sign - wq).max() <= 1e-5 * np.abs(
                    wq).max(), (r, n)
        q = {n: None if s_ref[n] is None else s_ref[n]["q"][0]
             for n in names}
        errs = {n: None if s_ref[n] is None else s_ref[n]["err"]
                for n in names}
    ratio = group["ranks"][0][1]["compress_round1"]["compression_ratio"]
    assert ratio > 1


@pytest.mark.distributed
@pytest.mark.parametrize("tag", list(W.SHARDED_CASES))
def test_sharded_step_matches_one_process(group, tag):
    """Two ZeRO-1 steps on the mesh, each against the port's one-process
    Trainer step on the same global batch from the same state (the mesh's,
    gathered): loss and grad_norm, and after the last, the parameters, m
    and v; every rank's parameters bit for bit.  ``data4_sigma``: the
    spectral clip with a sigma tree finite on rank 0 and NaN elsewhere,
    against one process with rank 0's (the step broadcasts rank 0's)."""
    arrays, info = group["ranks"][0]
    want = {part: _by_prefix(arrays, f"{tag}|one|{part}|")
            for part in ("params", "m", "v")}
    same = info[tag]["one_process_same_state"]
    _hold_step(arrays, info, tag, same, want, W.OPT["peak_lr"], 1)
    _replicas_equal(group, tag)


@pytest.mark.distributed
@pytest.mark.parametrize("tag", list(W.SHARDED_CASES))
def test_sharded_step_matches_reference(group, tag):
    """Each of the two ZeRO-1 steps on the mesh against the reference's
    Trainer step (GSPMD on a mesh of four host devices of the same shape,
    the same rules, accum and batch, m and v in its zero1_shardings, a
    sigma tree where the case has one) from the same state, the ranks'
    checkpoint before it: loss and grad_norm, and the parameters, m and v
    after it (the ranks' checkpoint after it).

    The second step starts where a step of lr 1e-2 has moved every entry
    by about lr: there the two packages' fp32 gradient norms part by about
    1e-5 of it, each as far from the port's fp64 gradient at that state,
    so a step from a state past the init holds grad_norm as m and v are
    held, within GRAD_TOL (``_GRAD_NORM_TOL_PAST_INIT``); the first step,
    from the init, holds it within LOSS_TOL."""
    pre = group["work"] / f"pre_{tag}"
    for t in (1, 2):
        got = dict(np.load(pre / f"step_{t:08d}" / "state.npz"))
        want, want_metrics = group["ref"][f"{tag}{t}"]
        _hold([group["ranks"][0][1][tag]["metrics"][t - 1]], _flat_parts(got),
              [want_metrics], _flat_parts(want), W.OPT["peak_lr"], 1,
              LOSS_TOL if t == 1 else _GRAD_NORM_TOL_PAST_INIT)


@pytest.mark.distributed
@pytest.mark.parametrize("tag", list(W.SHARDED_CASES))
def test_each_rank_holds_its_zero1_block(group, tag):
    """Each rank's m (and v) is its block of the reference's ZeRO-1 spec
    at its mesh coordinates, of that block's shape."""
    pod = W.SHARDED_CASES[tag][0] != "data"
    model = build(smoke_of(W.ARCH), device="meta")
    shapes = _leaves(model.param_shapes())
    for rank, (arrays, info) in enumerate(group["ranks"]):
        mesh = FakeMesh(info["mesh"]["shape"] if pod else {"data": WORLD})
        mesh.coords = info["mesh"]["coords"] if pod else {"data": rank}
        specs = _leaves(tshard.zero1_shardings(
            model.param_logical(), model.param_shapes(),
            tshard.AxisRules(tshard._MULTI if pod else tshard._SINGLE,
                             mesh=mesh)))
        for name, block in info[tag]["blocks"].items():
            want = specs[name].local_slices(shapes[name])
            assert block["slices"] == [None if s.start is None else
                                       [s.start, s.stop] for s in want]
            assert block["shape"] == list(specs[name].local_shape(
                shapes[name]))
            assert block["shape"] != list(shapes[name]), name
            assert arrays[f"{tag}|m|{name}"].shape == shapes[name]


@pytest.mark.distributed
@pytest.mark.parametrize("t", [1, 2])
def test_compressed_step_matches_reference(group, t):
    """The compressed step (rank 4, min_dim 32) on a data mesh of four
    against the reference's on four host devices, each of its two steps
    from the reference's state before it (carried across by
    ``convert.train_state_from_reference(..., shardings=)``; the second from
    the warm-started Q): loss, grad_norm, m, v, the parameters, each
    rank's error feedback and Q' (up to its columns' signs), and the
    compression ratio, above 3 and equal to the reference's."""
    tag = f"compressed{t}"
    ref, exp = group["ref"][tag]
    arrays, info = group["ranks"][0]
    got = info[tag]["metrics"][0]
    _hold_step(arrays, info, tag, [exp], _flat_parts(ref),
               AdamWConfig(**W.REF_OPT).peak_lr, 1)
    assert np.float32(got["compression_ratio"]) == np.float32(
        exp["compression_ratio"])
    assert got["compression_ratio"] > 3
    _replicas_equal(group, tag)
    for rank, (arrays, _) in enumerate(group["ranks"]):
        errs = _by_prefix(arrays, f"{tag}|err|")
        assert sorted(errs) == sorted(
            k[:-len(".err")] for k in _ref_part(ref, "comp")
            if k.endswith(".err"))
        for name, err in errs.items():
            w = ref[f"comp|{name.replace('.', '|')}|err"][rank]
            assert np.abs(err - w).max() <= GRAD_TOL * np.abs(w).max(), name
            wq = ref[f"comp|{name.replace('.', '|')}|q"]
            gq = arrays[f"{tag}|q|{name}"]
            sign = np.sign(np.sum(gq * wq, axis=-2, keepdims=True))
            assert np.abs(gq * sign - wq).max() <= GRAD_TOL * np.abs(
                wq).max(), name


@pytest.mark.distributed
def test_compressed_step_moves_no_eligible_leaf_at_full_size(group):
    """The collectives' byte count of each compressed step: the plain
    means carry exactly the leaves under min_dim, PowerSGD's sites exactly
    P and Q' of the others (the port's counterpart of the reference's
    check that no full-gradient all-reduce is in its HLO)."""
    cfg = CompressionConfig(**W.REF_COMP)
    small = p_q = 0
    for shape in _leaves(build(smoke_of(W.ARCH),
                               device="meta").param_shapes()).values():
        if len(shape) >= 2 and min(shape[-2:]) >= cfg.min_dim:
            p_q += (int(np.prod(shape[:-2])) * cfg.rank
                    * (shape[-2] + shape[-1]) * 4)
        else:
            small += int(np.prod(shape)) * 4
    for rank in range(WORLD):
        for t in (1, 2):
            traffic = group["ranks"][rank][1][f"compressed{t}"]["traffic"]
            assert traffic["grad_mean"]["bytes"] == small
            assert (traffic["powersgd_p"]["bytes"]
                    + traffic["powersgd_q"]["bytes"]) == p_q
            assert set(traffic) == {"grad_mean", "powersgd_p",
                                    "powersgd_q", "metrics"}


@pytest.mark.distributed
@pytest.mark.parametrize("tag", ["elastic_in", "elastic_out"])
def test_elastic_restore(group, tag):
    """elastic_in: a one-process checkpoint restored onto four ranks with
    ``state_shardings`` goes on a step as the one process does.
    elastic_out: a checkpoint the four ranks wrote (m and v gathered, rank
    0 writing) restored into one process goes on a step as the ranks do."""
    arrays, info = group["ranks"][0]
    metrics, want = group["base"][tag]
    _hold_step(arrays, info, tag, metrics, want, W.OPT["peak_lr"], 1)
    _replicas_equal(group, tag)


@pytest.mark.distributed
@pytest.mark.parametrize("tag", ["elastic_in", "elastic_out"])
def test_elastic_restore_matches_reference(group, tag):
    """The same restores and steps in the reference: elastic_in the
    one-process checkpoint onto a data mesh of four host devices with its
    ``state_shardings``, elastic_out the ranks' checkpoint onto one
    device.  The ranks' step and, for elastic_out, the port's one-process
    step from that checkpoint against the reference's; both checkpoints
    hold the state after a first step, so grad_norm is held within
    ``_GRAD_NORM_TOL_PAST_INIT``."""
    arrays, info = group["ranks"][0]
    want, want_metrics = group["ref"][tag]
    want = _flat_parts(want)
    lr, tol = W.OPT["peak_lr"], _GRAD_NORM_TOL_PAST_INIT
    _hold_step(arrays, info, tag, [want_metrics], want, lr, 1, tol)
    if tag == "elastic_out":
        metrics, one = group["base"][tag]
        _hold(metrics, one, [want_metrics], want, lr, 1, tol)


@pytest.mark.distributed
def test_mesh_refusals(group):
    """``make_production_mesh`` on four ranks, and a "model" axis of 2."""
    out = group["ranks"][0][1]["refusals"]
    assert "256" in out["production_mesh"] and "4" in out["production_mesh"]
    assert "12.5" in out["model_axis"]


@pytest.mark.distributed
def test_process_mesh_lays_ranks_out_row_major(group):
    """Rank r of a (pod 2, data 2) mesh sits at (r // 2, r % 2)."""
    for rank, (_, info) in enumerate(group["ranks"]):
        assert info["mesh"]["coords"] == {"pod": rank // 2,
                                          "data": rank % 2}
