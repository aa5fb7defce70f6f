"""Token serving launcher, after the reference's ``launch/serve.py`` (its
token mode): random weights from a seed, a few requests with random prompts
of 2 to 8 tokens, answered by the batched token ``Engine``.

  python -m repro_torch.launch.serve --arch phi3-medium-14b --device cpu
  python -m repro_torch.launch.serve --arch phi3-medium-14b --full

Without ``--full`` the model is the architecture's smoke variant (tiny
widths).  ``--device`` defaults to the card; without one the run raises,
naming ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, smoke_of
from repro_torch.models import build
from repro_torch.serve import Engine, Request, ServeConfig

__all__ = ["main", "make_requests", "serve"]

SVD_LATER = "--svd: the SVD serve tier comes in a later slice of the port"


def make_requests(cfg, n: int, new_tokens: int, seed: int = 0
                  ) -> list[Request]:
    """``n`` requests with prompts of 2 to 8 random tokens in [1, vocab)."""
    rng = np.random.default_rng(seed)
    return [Request(uid=uid,
                    prompt=list(map(int, rng.integers(
                        1, cfg.vocab, int(rng.integers(2, 9))))),
                    max_new_tokens=new_tokens)
            for uid in range(n)]


def serve(model, requests: list[Request], cfg: ServeConfig) -> dict:
    """Answer ``requests`` with one ``Engine``; the clock covers the run and
    ends after the device is done."""
    eng = Engine(model, cfg)
    for req in requests:
        eng.submit(req)
    sync = (torch.cuda.synchronize if model.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    done = eng.run()
    sync()
    dt = time.perf_counter() - t0
    ntok = sum(len(r.output) for r in done)
    return {"done": done, "requests": len(done), "tokens": ntok,
            "rounds": eng.rounds, "seconds": dt,
            "tokens_per_s": ntok / max(dt, 1e-9)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: smoke, CPU-runnable)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--svd", action="store_true",
                    help="the async SVD serve tier (a later slice)")
    args = ap.parse_args(argv)
    if args.svd:
        ap.error(SVD_LATER)

    cfg = get_config(args.arch) if args.full else smoke_of(args.arch)
    model = build(cfg, device=args.device)
    model.init_params(torch.Generator(device=model.device).manual_seed(
        args.seed))
    stats = serve(model, make_requests(cfg, args.requests, args.new_tokens,
                                       args.seed),
                  ServeConfig(max_batch=args.max_batch, max_seq=args.max_seq))
    for r in stats["done"][:4]:
        print(f"req {r.uid}: {r.output}")
    print(f"served {stats['requests']} requests / {stats['tokens']} tokens in "
          f"{stats['seconds']:.1f}s ({stats['tokens_per_s']:.1f} tok/s) on "
          f"{model.device}")
    return stats


if __name__ == "__main__":
    main()
