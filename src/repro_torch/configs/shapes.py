"""Assigned input-shape suites (one set shared by all 10 LM archs), copied
from the reference's ``configs/shapes.py``.

  train_4k     seq 4096   gb 256   -> train_step
  prefill_32k  seq 32768  gb 32    -> prefill_step
  decode_32k   seq 32768  gb 128   -> serve_step (1 new token, seq-len cache)
  long_500k    seq 524288 gb 1     -> serve_step; sub-quadratic archs only

``cells(arch)`` enumerates the applicable (arch x shape) cells —
full-attention archs skip long_500k (quadratic; DESIGN.md §7); whisper's
decoder is its sequence axis (enc frames fixed at cfg.enc_seq).
"""

from __future__ import annotations

import dataclasses

__all__ = ["ShapeSuite", "SUITES", "cells", "applicable"]


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    name: str
    seq_len: int
    global_batch: int
    mode: str                  # "train" | "prefill" | "decode"


SUITES: dict[str, ShapeSuite] = {
    "train_4k": ShapeSuite("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSuite("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSuite("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSuite("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg, suite: ShapeSuite) -> bool:
    if suite.name == "long_500k":
        return cfg.subquadratic
    return True


def cells(cfg) -> list[ShapeSuite]:
    return [s for s in SUITES.values() if applicable(cfg, s)]
