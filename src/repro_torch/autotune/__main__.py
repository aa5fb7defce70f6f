"""Autotuner CLI: tune a shape list, print the model-validation table,
persist the winners to the tuned-config cache.

  python -m repro_torch.autotune --shapes n=4096:bw=64 --dtype float64
  python -m repro_torch.autotune --shapes n=16384:bw=64 --stage3-crossover \\
      --dtype float64
  python -m repro_torch.autotune --shapes n=96:bw=8 --backend ref \\
      --device cpu

Each ``--shapes`` item is ``n=<int>:bw=<int>``.  The winning ``(tw,
fuse)`` per shape is merged into the cache at ``--cache`` /
``$REPRO_TORCH_AUTOTUNE_CACHE`` / the default, keyed by ``(device_kind,
n, bw, dtype, compute_uv, backend)`` — the key
``PipelineConfig.resolve(autotune=True)`` looks up.  ``--stage3-crossover``
times stage 3 on what stage 2 makes of banded inputs of the largest
shape's bw (the reference times i.i.d. normal bidiagonals, which deflate
far more).  ``--no-store`` prints
the table without touching the cache.  It runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.autotune import cache as cache_mod
from repro_torch.autotune import model as model_mod
from repro_torch.autotune import search as search_mod
from repro_torch.core import tuning
from repro_torch.kernels import ops

STAGE3_NS = (256, 512, 1024, 2048, 4096, 8192, 16384)
FUSED_NS = (16, 32, 64, 128, 256, 384, 512)


def parse_shapes(spec: str) -> list[tuple[int, int]]:
    """"n=512:bw=32,n=256:bw=16" -> [(512, 32), (256, 16)]."""
    shapes = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        try:
            fields = dict(kv.split("=", 1) for kv in item.split(":"))
            shapes.append((int(fields["n"]), int(fields["bw"])))
        except (KeyError, ValueError) as e:
            raise SystemExit(f"bad --shapes item {item!r} "
                             f"(want n=<int>:bw=<int>): {e}")
    if not shapes:
        raise SystemExit("--shapes parsed to nothing")
    return shapes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.autotune",
        description="Tune (tw, fuse) per shape; persist the winners.")
    ap.add_argument("--shapes", required=True,
                    help="comma list of n=<int>:bw=<int> items")
    ap.add_argument("--device", default="cuda",
                    help="where to measure: cuda (default) or cpu")
    ap.add_argument("--backend", default="auto",
                    help="kernel registry key (auto/cuda/ref)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--compute-uv", action="store_true",
                    help="tune the tape-mode (full SVD) pipeline")
    ap.add_argument("--top-k", type=int, default=3,
                    help="measured candidates per shape (model-ranked)")
    ap.add_argument("--batches", default="1",
                    help="comma list of batch sizes to include in the grid")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--iters", type=int, default=1,
                    help="timed repetitions per candidate (median)")
    ap.add_argument("--cache", default="",
                    help=f"cache path (default: ${cache_mod.ENV_VAR} or "
                         f"{cache_mod.cache_path()})")
    ap.add_argument("--no-store", action="store_true",
                    help="print the table only; do not write the cache")
    ap.add_argument("--fused-crossover", action="store_true",
                    help="instead of the (tw, fuse, batch) grid, measure the "
                         "fused-vs-staged crossover per --shapes bw and "
                         "persist fused_n_max")
    ap.add_argument("--stage3-crossover", action="store_true",
                    help="instead of the (tw, fuse, batch) grid, measure the "
                         "stage-3 bisect-vs-dc crossover up to the largest "
                         "--shapes n and persist dc_n_min")
    args = ap.parse_args(argv)

    try:
        dtype = tuning.dtype_of(args.dtype)
        batches = tuple(sorted({int(b) for b in args.batches.split(",")
                                if b.strip()}))
    except ValueError as e:
        raise SystemExit(f"bad --dtype {args.dtype!r} or --batches "
                         f"{args.batches!r}: {e}")
    if not batches or min(batches) < 1:
        raise SystemExit(f"bad --batches {args.batches!r}: need at least "
                         f"one batch size >= 1")
    device = str(ops.check_device(args.device))
    backend = ops.resolve_backend(args.backend, device)
    dname = tuning.dtype_name(dtype)
    path = args.cache or None
    kind = model_mod.device_kind(device)
    prof = model_mod.profile_for(kind)
    common = dict(dtype=dtype, compute_uv=args.compute_uv, profile=prof,
                  warmup=args.warmup, iters=args.iters, device=device)
    print(f"# autotune device={kind} profile={prof.device_kind} "
          f"backend={backend} dtype={dname}", flush=True)

    if args.fused_crossover:
        # one sweep per distinct bw, capped by the shape's n; stored under
        # both the bw-specific and the device-wide crossover key
        caps: dict[int, int] = {}
        for n, bw in parse_shapes(args.shapes):
            caps[bw] = max(caps.get(bw, 0), n)
        for bw, n_cap in sorted(caps.items()):
            ns = tuple(x for x in FUSED_NS if x <= n_cap) or (n_cap,)
            res = search_mod.search_fused_crossover(
                bw, ns=ns, batch=max(batches), **common)
            print(res.table(), flush=True)
            if args.no_store:
                continue
            for key_bw in (bw, None):
                dest = cache_mod.store_crossover(
                    res.to_entry(), device_kind=kind, dtype=dname,
                    compute_uv=args.compute_uv, bw=key_bw, path=path)
            print(f"# cached fused_n_max={res.fused_n_max} -> {dest}",
                  flush=True)
        return 0

    if args.stage3_crossover:
        # one sweep up to the largest --shapes n, on the bidiagonals stage 2
        # makes of banded inputs of that shape's bw; the key is (device,
        # dtype, uv)
        n_cap, bw_cap = max(parse_shapes(args.shapes))
        ns = tuple(x for x in STAGE3_NS if x <= n_cap) or (n_cap,)
        res = search_mod.search_stage3_crossover(
            ns=ns, batch=max(batches), backend=backend, bw=bw_cap,
            **common)
        print(res.table(), flush=True)
        if not args.no_store:
            dest = cache_mod.store_stage3(
                res.to_entry(), device_kind=kind, dtype=dname,
                compute_uv=args.compute_uv, path=path)
            print(f"# cached dc_n_min={res.dc_n_min} -> {dest}", flush=True)
        return 0

    for n, bw in parse_shapes(args.shapes):
        res = search_mod.search(n, bw, backend=backend, top_k=args.top_k,
                                batches=batches, **common)
        print(res.table(), flush=True)
        if args.no_store:
            continue
        dest = cache_mod.store(res.to_entry(), device_kind=kind, n=n, bw=bw,
                               dtype=dname, compute_uv=args.compute_uv,
                               backend=backend, path=path)
        print(f"# cached {res.best.label()} -> {dest}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
