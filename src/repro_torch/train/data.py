"""Deterministic synthetic LM data, copied from the reference's
``train/data.py``: the same numpy, so every batch is bit for bit the
reference's.

* **Pure function of (seed, step)**: ``batch_at`` is stateless, so a
  restart or a skip ahead is "evaluate at step k"; no loader state to
  checkpoint beyond the step counter.
* **Host sharding**: each host makes only its slice of the global batch
  (``host_slice``).
* **Prefetch**: a background thread keeps ``depth`` batches ready;
  ``to_device`` puts each on the trainer's device.

Tokens emulate packed documents: per-sequence document lengths drawn from
the seeded generator, EOS-delimited, labels = the next token, the mask all
ones.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

__all__ = ["DataConfig", "batch_at", "host_slice", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 512


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, 0xB1D1A6]))


def batch_at(cfg: DataConfig, step: int) -> dict:
    """Global batch for ``step`` (numpy; pure function of (cfg, step))."""
    rng = _rng_for(cfg, step)
    b, s = cfg.global_batch, cfg.seq_len
    toks = rng.integers(1, cfg.vocab, size=(b, s + 1), dtype=np.int32)
    # EOS-delimit pseudo documents (geometric lengths)
    doc_end = rng.random((b, s + 1)) < (1.0 / max(cfg.mean_doc_len, 2))
    toks = np.where(doc_end, cfg.eos_id, toks)
    tokens = toks[:, :-1]
    labels = toks[:, 1:].astype(np.int32)
    mask = np.ones((b, s), np.float32)
    return {"tokens": tokens, "labels": labels, "mask": mask}


def host_slice(batch: dict, host_id: int, n_hosts: int) -> dict:
    """Each host materializes only its contiguous slice of the global batch."""
    def sl(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per : (host_id + 1) * per]
    return {k: sl(v) for k, v in batch.items()}


class Prefetcher:
    """Background-thread batch prefetch (double buffering).  ``to_device``
    (default: each array as a tensor on ``device``, the card unless the
    caller asks for the CPU) runs in the caller's thread, at ``next``."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2,
                 to_device=None, device="cuda"):
        self.cfg = cfg
        self.to_device = to_device or (lambda b: {
            k: torch.as_tensor(v, device=device) for k, v in b.items()})
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = batch_at(self.cfg, step)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self) -> tuple[int, dict]:
        step, batch = self._q.get()
        return step, self.to_device(batch)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
