"""End-to-end training driver, after the reference's ``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --smoke --steps 20 --device cpu

Wires together: config -> model (on ``--device``, the card unless the
caller asks for the CPU) -> Trainer -> the deterministic data pipeline ->
the spectral monitor (the paper's SVD pipeline on the card's kernels) ->
checkpoints.  ``--smoke`` takes the reduced config; otherwise the full
published one.  Prints one JSON line per logged step ({"step", "loss",
"grad_norm", "lr"[, "sigma0"]}), then ``done: N steps in T s (R it/s)``.
``--compress-rank N`` hands ``CompressionConfig(rank=N)`` to the Trainer,
as the reference's launcher does; like the reference's, this launcher
builds no mesh, so the Trainer refuses it (``ValueError``: PowerSGD needs
``mesh=``).  Data-parallel runs build a ``launch.mesh.ProcessMesh`` and
a ``Trainer(mesh=...)`` themselves (``chip_smoke.py --train-parallel``).

The final checkpoint is written once: where the loop's last step saved it
(``--save-every`` dividing ``--steps``), the reference writes the same
state a second time and this launcher does not.  ``main`` also returns a
summary: the logged lines, the seconds of the run, of each step, of the
monitor (the device synchronized around each refresh) and of the
checkpoints.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.base import get_config, smoke_of
from repro_torch.models import build
from repro_torch.parallel.compression import CompressionConfig
from repro_torch.train import (AdamWConfig, DataConfig, StragglerMonitor,
                               Trainer, batch_at, checkpoint)
from repro_torch.train.spectral import SpectralMonitor, SpectralMonitorConfig


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--spectral-every", type=int, default=0,
                    help="refresh spectral monitor every N steps (0=off)")
    ap.add_argument("--compress-rank", type=int, default=0,
                    help="PowerSGD gradient compression rank (0=off)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default the card)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the parameters' init generator")
    args = ap.parse_args(argv)

    cfg = smoke_of(args.arch) if args.smoke else get_config(args.arch)
    model = build(cfg, device=args.device)
    dev = model.device
    opt = AdamWConfig(peak_lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
                      total_steps=args.steps,
                      spectral_clip=2.0 if args.spectral_every else 0.0)
    compression = (CompressionConfig(rank=args.compress_rank)
                   if args.compress_rank else None)
    trainer = Trainer(model, opt, accum=args.accum, compression=compression)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch, seed=17)
    monitor = (SpectralMonitor(SpectralMonitorConfig(every=args.spectral_every,
                                                     size=64, bw=16))
               if args.spectral_every else None)
    straggler = StragglerMonitor(
        on_straggler=lambda s, t, m: print(
            f"[straggler] step {s}: {t:.2f}s vs median {m:.2f}s", flush=True))
    step_fn = trainer.make_train_step()

    # ---- resume or init ----------------------------------------------------
    start = 0
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = trainer.init_state(gen)
    if args.ckpt_dir:
        last = checkpoint.latest_step(args.ckpt_dir)
        if last is not None:
            state = checkpoint.restore(args.ckpt_dir, last, state)
            start = last
            print(f"resumed from step {start}", flush=True)

    lines, step_s, monitor_s, ckpt_s = [], [], 0.0, 0.0
    t_start = time.time()
    for step in range(start, args.steps):
        t0 = time.monotonic()
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batch_at(dc, step).items()}
        if monitor is not None:
            _sync(dev)
            tm = time.monotonic()
            monitor.maybe_refresh(step, state["params"])
            _sync(dev)
            monitor_s += time.monotonic() - tm
            state, metrics = step_fn(state, batch, monitor.sigma_max_tree())
        else:
            state, metrics = step_fn(state, batch)
        straggler.record(step, time.monotonic() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            line = {"step": step,
                    "loss": round(float(metrics["loss"]), 4),
                    "grad_norm": round(float(metrics["grad_norm"]), 3),
                    "lr": float(metrics["lr"])}
            if monitor is not None:
                sm = monitor.metrics()
                if sm:
                    k = sorted(sm)[0]
                    line["sigma0"] = round(sm[k], 3)
            print(json.dumps(line), flush=True)
            lines.append(line)
        _sync(dev)
        step_s.append(time.monotonic() - t0)
        if args.ckpt_dir and (step + 1) % args.save_every == 0:
            tc = time.monotonic()
            checkpoint.save(args.ckpt_dir, step + 1, state)
            ckpt_s += time.monotonic() - tc
    if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) != args.steps:
        tc = time.monotonic()
        checkpoint.save(args.ckpt_dir, args.steps, state)
        ckpt_s += time.monotonic() - tc
    dt = time.time() - t_start
    print(f"done: {args.steps - start} steps in {dt:.1f}s "
          f"({(args.steps - start) / max(dt, 1e-9):.2f} it/s)", flush=True)
    return {"lines": lines, "seconds": dt, "step_s": step_s,
            "monitor_s": monitor_s, "checkpoint_s": ckpt_s,
            "steps": args.steps - start}


if __name__ == "__main__":
    main()
