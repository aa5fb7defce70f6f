"""One rank of ``tests/test_torch_parallel.py``'s process group (CPU, gloo).

    python tests/torch_parallel_worker.py RANK WORLD INIT_FILE WORKDIR

Runs every multi-process case of that file in turn on the ranks of one
group, from the inputs the test wrote to WORKDIR, and writes this rank's
readings to WORKDIR/rank<RANK>.npz (arrays) and .json (the rest); the
ZeRO-1 cases also write the state before each step and after the last as
checkpoints (WORKDIR/pre_<case>), from which the reference, in a process
beside the group, takes the same steps.  Imports no JAX: the test compares
the readings with the reference and with the port's one-process Trainer.
"""

import dataclasses
import datetime
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import smoke_of
from repro_torch.convert import train_state_from_reference
from repro_torch.launch.mesh import (DIST_TIMEOUT_S, make_mesh,
                                     make_production_mesh)
from repro_torch.models import build
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import compression as comp
from repro_torch.train import AdamWConfig, DataConfig, Trainer, batch_at
from repro_torch.train import checkpoint
from repro_torch.train.tree import get_path, items

ARCH = "llama3-8b"
SEED = 7
# the sharded and elastic cases: lr well above the gradients' rounding
OPT = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
DATA = DataConfig(vocab=smoke_of(ARCH).vocab, seq_len=16, global_batch=8,
                  seed=3)
# the reference's test_compressed_train_step_8dev, at data = 4
REF_OPT = dict(warmup_steps=2, total_steps=20)
REF_COMP = dict(rank=4, min_dim=32)
REF_DATA = DataConfig(vocab=smoke_of(ARCH).vocab, seq_len=16, global_batch=8,
                      seed=1)
# compress_and_sync's own case: a stacked leaf, a matrix, a vector, and a
# matrix under min_dim
COMP_LEAVES = {"a": (2, 48, 40), "b": (64, 80), "c": (33,), "d": (8, 70)}
COMP_CFG = dict(rank=4, min_dim=32)


def masked_batch(step: int) -> dict:
    """``batch_at``'s batch with a random mask of ~70 %, so the ranks'
    shares of the loss differ."""
    b = batch_at(DATA, step)
    rng = np.random.default_rng(100 + step)
    b["mask"] = (rng.random(b["mask"].shape) < 0.7).astype(np.float32)
    return b


# name -> (mesh axes, accum, batches, spectral clip with a sigma tree)
SHARDED_CASES = {
    "data4_accum1": ("data", 1, [masked_batch(0), masked_batch(1)], False),
    "data4_accum2": ("data", 2, [batch_at(DATA, 0), batch_at(DATA, 1)],
                     False),
    "data4_accum2_masked": ("data", 2, [masked_batch(0), masked_batch(1)],
                            False),
    "pod2_data2_accum1": ("pod_data", 1, [masked_batch(0), masked_batch(1)],
                          False),
    "data4_sigma": ("data", 1, [batch_at(DATA, 0), batch_at(DATA, 1)], True),
}


def sigma_tree(model, scale: float = 1.0) -> dict:
    """A sigma_max a leaf of >= 2 dims (per layer for stacked leaves),
    from a seed, times ``scale``; None elsewhere.  (The reference's clip
    factor is min(1, spectral_clip) for any finite sigma; a NaN one gives
    NaN.)"""
    rng = np.random.default_rng(5)
    out = {}
    for path, p in items(model.params):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if p.dim() < 2:
            node[path[-1]] = None
            continue
        lead = p.shape[:1] if path[0] == "layers" else ()
        node[path[-1]] = scale * torch.from_numpy(
            rng.uniform(0.5, 2.0, lead).astype(np.float32))
    return out


def compress_inputs(world: int) -> dict:
    """Per-worker gradients of two rounds, the first Q and the first
    error-feedback rows, from a seed."""
    rng = np.random.default_rng(11)
    out = {}
    for name, shape in COMP_LEAVES.items():
        out[f"g1|{name}"] = rng.standard_normal((world,) + shape)
        out[f"g2|{name}"] = rng.standard_normal((world,) + shape)
        if len(shape) >= 2 and min(shape[-2:]) >= COMP_CFG["min_dim"]:
            out[f"q|{name}"] = rng.standard_normal(
                shape[:-2] + (shape[-1], COMP_CFG["rank"]))
            out[f"err|{name}"] = 0.1 * rng.standard_normal((world,) + shape)
    return {k: v.astype(np.float32) for k, v in out.items()}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy().copy()


def _gathered(tree, shardings, prefix: str, arrays: dict) -> None:
    for path, leaf in items(tree):
        sh = get_path(shardings, path)
        arrays[f"{prefix}|{'.'.join(path)}"] = _np(
            coll.gather_sharded(leaf.detach(), sh, "test"))


def _record(tag, tr, state, arrays, info, metrics) -> None:
    """The whole parameters, m and v gathered, each rank's blocks."""
    sh = tr.state_shardings(state)
    for path, p in items(state["params"]):
        arrays[f"{tag}|params|{'.'.join(path)}"] = _np(p)
    _gathered(state["opt"]["m"], sh["opt"]["m"], f"{tag}|m", arrays)
    _gathered(state["opt"]["v"], sh["opt"]["v"], f"{tag}|v", arrays)
    blocks = {}
    for path, p in items(state["params"]):
        sl = get_path(sh["opt"]["m"], path).local_slices(p.shape)
        blocks[".".join(path)] = {
            "slices": [None if s.start is None else [s.start, s.stop]
                       for s in sl],
            "shape": list(get_path(state["opt"]["m"], path).shape)}
    info[tag] = {"metrics": metrics, "blocks": blocks}


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def compress_rounds(mesh, workdir, arrays, info) -> None:
    rank = mesh.coords["data"]
    src = dict(np.load(workdir / "compress_inputs.npz"))
    cfg = comp.CompressionConfig(**COMP_CFG)
    state = {n: None if f"q|{n}" not in src else {
        "q": torch.from_numpy(src[f"q|{n}"]),
        "err": torch.from_numpy(src[f"err|{n}"][rank][None])}
        for n in COMP_LEAVES}
    for r in (1, 2):
        grads = {n: torch.from_numpy(src[f"g{r}|{n}"][rank])
                 for n in COMP_LEAVES}
        ghat, state, stats = comp.compress_and_sync(grads, state, cfg, mesh,
                                                    ("data",))
        info[f"compress_round{r}"] = stats
        for n in COMP_LEAVES:
            arrays[f"compress{r}|ghat|{n}"] = _np(ghat[n])
            if state[n] is not None:
                arrays[f"compress{r}|q|{n}"] = _np(state[n]["q"])
                arrays[f"compress{r}|err|{n}"] = _np(state[n]["err"][0])


def _one_process_step(state, sh, opt, accum, batch, sigma):
    """On rank 0 (the others only gather): the port's one-process Trainer
    step from this mesh state, gathered; (its metrics, its state after)."""
    full = {"params": {".".join(p): x.detach().clone()
                       for p, x in items(state["params"])}}
    for mv in ("m", "v"):
        full[mv] = {".".join(p): coll.gather_sharded(x, get_path(
            sh["opt"][mv], p), "test") for p, x in items(state["opt"][mv])}
    if dist.get_rank() != 0:
        return None, None
    tr = Trainer(build(smoke_of(ARCH), device="cpu"), opt, accum=accum)
    one = tr.init_state(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        for name, x in tr.model.state_dict(keep_vars=True).items():
            x.copy_(full["params"][name])
        for mv in ("m", "v"):
            for p, x in items(one["opt"][mv]):
                x.copy_(full[mv][".".join(p)])
        one["opt"]["step"].copy_(state["opt"]["step"])
    one, m = tr.step(one, batch, sigma)
    return _metrics(m), one


def sharded_runs(meshes, workdir, arrays, info) -> None:
    """Each case's steps; before each, the state as a checkpoint (the
    reference's input) and the one-process step from the same state.
    With a sigma tree, rank 0 passes finite values and the other ranks
    NaN, and the one-process step rank 0's: the step clips by rank 0's on
    every rank, or the others' blocks would be NaN."""
    for tag, (axes, accum, batches, spectral) in SHARDED_CASES.items():
        model = build(smoke_of(ARCH), device="cpu")
        opt = AdamWConfig(**OPT, spectral_clip=0.5 if spectral else 0.0)
        tr = Trainer(model, opt, mesh=meshes[axes], accum=accum)
        state = tr.init_state(torch.Generator().manual_seed(SEED))
        mine = (sigma_tree(model, 1.0 if dist.get_rank() == 0
                           else float("nan")) if spectral else None)
        metrics, same = [], []
        for t, b in enumerate(batches):
            checkpoint.save(str(workdir / f"pre_{tag}"), t, state,
                            shardings=tr.state_shardings(state))
            m_one, one = _one_process_step(
                state, tr.state_shardings(state), opt, accum, b,
                sigma_tree(model) if spectral else None)
            same.append(m_one)
            state, m = tr.step(state, b, mine)
            metrics.append(_metrics(m))
        checkpoint.save(str(workdir / f"pre_{tag}"), len(batches), state,
                        shardings=tr.state_shardings(state))
        _record(tag, tr, state, arrays, info, metrics)
        info[tag]["one_process_same_state"] = same
        if one is not None:
            for part, tree in (("params", one["params"]),
                               ("m", one["opt"]["m"]),
                               ("v", one["opt"]["v"])):
                for path, x in items(tree):
                    arrays[f"{tag}|one|{part}|{'.'.join(path)}"] = _np(x)


def _wait_for(path: Path, timeout_s: float = 240.0) -> Path:
    """The reference's output file, which a process beside this group
    writes (atomically: it renames a finished file into place)."""
    deadline = time.monotonic() + timeout_s
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.1)
    return path


def compressed_run(mesh, workdir, arrays, info) -> None:
    """The compressed step from the reference's state before each of its
    two steps (carried across by ``convert``, each rank its blocks by the
    Trainer's ``state_shardings``)."""
    ccfg = comp.CompressionConfig(**REF_COMP)
    layout = Trainer(build(smoke_of(ARCH), device="meta"),
                     AdamWConfig(**REF_OPT), mesh=mesh, compression=ccfg)
    for step, src in ((0, workdir / "ref_init" / "step_00000000" /
                       "state.npz"), (1, workdir / "ref_compressed1.npz")):
        flat = dict(np.load(_wait_for(src)))
        model, state = train_state_from_reference(
            flat, smoke_of(ARCH), device="cpu",
            shardings=layout.state_shardings())
        tr = dataclasses.replace(layout, model=model)
        mesh.traffic.clear()
        state, m = tr.step(state, batch_at(REF_DATA, step))
        tag = f"compressed{step + 1}"
        _record(tag, tr, state, arrays, info, [_metrics(m)])
        info[tag]["traffic"] = {k: dict(v) for k, v in mesh.traffic.items()}
        for path, _ in items(state["params"]):
            st = get_path(state["comp"], path)
            if st is not None:
                name = ".".join(path)
                arrays[f"{tag}|err|{name}"] = _np(st["err"][0])
                arrays[f"{tag}|q|{name}"] = _np(st["q"])


def elastic_runs(mesh, workdir, arrays, info) -> None:
    """1 -> 4: restore the one-process checkpoint onto the mesh and go on a
    step.  4 -> 1: a step on the mesh, a checkpoint, a step more."""
    model = build(smoke_of(ARCH), device="cpu")
    tr = Trainer(model, AdamWConfig(**OPT), mesh=mesh)
    template = tr.init_state(torch.Generator().manual_seed(SEED + 1))
    state = checkpoint.restore(str(workdir / "ckpt_one"), 1, template,
                               tr.state_shardings(template))
    state, m = tr.step(state, batch_at(DATA, 1))
    _record("elastic_in", tr, state, arrays, info, [_metrics(m)])

    model = build(smoke_of(ARCH), device="cpu")
    tr = Trainer(model, AdamWConfig(**OPT), mesh=mesh)
    state = tr.init_state(torch.Generator().manual_seed(SEED))
    state, _ = tr.step(state, batch_at(DATA, 0))
    checkpoint.save(str(workdir / "ckpt_mesh"), 1, state,
                    shardings=tr.state_shardings(state))
    state, m = tr.step(state, batch_at(DATA, 1))
    _record("elastic_out", tr, state, arrays, info, [_metrics(m)])


def refusals(world, info) -> None:
    out = {}
    try:
        make_production_mesh()
    except ValueError as exc:
        out["production_mesh"] = str(exc)
    model = build(smoke_of(ARCH), device="cpu")
    try:
        Trainer(model, AdamWConfig(),
                mesh=make_mesh((world // 2, 2), ("data", "model"),
                               device="cpu"))
    except NotImplementedError as exc:
        out["model_axis"] = str(exc)
    info["refusals"] = out


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init, workdir = sys.argv[3], Path(sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    arrays, info = {}, {}
    try:
        meshes = {"data": make_mesh((world,), ("data",), device="cpu"),
                  "pod_data": make_mesh((2, world // 2), ("pod", "data"),
                                        device="cpu")}
        info["mesh"] = {"coords": meshes["pod_data"].coords,
                        "shape": meshes["pod_data"].shape}
        compress_rounds(meshes["data"], workdir, arrays, info)
        sharded_runs(meshes, workdir, arrays, info)
        elastic_runs(meshes["data"], workdir, arrays, info)
        refusals(world, info)
        compressed_run(meshes["data"], workdir, arrays, info)
    except Exception:
        traceback.print_exc()
        return 1
    np.savez(workdir / f"rank{rank}.npz", **arrays)
    (workdir / f"rank{rank}.json").write_text(json.dumps(info))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
