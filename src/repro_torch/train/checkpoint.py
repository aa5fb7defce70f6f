"""Fault-tolerant checkpointing: atomic, keep-N, async, after the
reference's ``train/checkpoint.py``, in its layout.

``<dir>/step_<k>/state.npz`` holds every leaf of the state tree under its
key path joined by "|" (``params|layers|attn|wq``, ``opt|m|...``,
``opt|step``), and a ``DONE`` marker is written *after* a successful
fsync: a partly written checkpoint is never restored.  An fp32 checkpoint
that the reference wrote therefore restores here.

bf16 leaves, which numpy cannot hold, are stored as their bits: an int16
array under the leaf's own key, with the keys so stored listed in the
member ``__bfloat16__``; ``restore`` reads them back bit for bit.  Every
other leaf is stored in its own dtype.

``restore`` loads into the template's tensors in place (a model's
parameters stay the tensors the model holds) and casts each stored array
to the template leaf's dtype, as the reference's ``astype`` does.  None
leaves (PowerSGD's state of an uncompressed leaf) are not stored, as the
reference's pytree flattening drops them.

Under a process mesh (``shardings=``, ``Trainer.state_shardings``) ``save``
gathers each sharded leaf (ZeRO-1's m and v, PowerSGD's error-feedback
rows) to its global array and rank 0 writes the reference's layout;
``restore`` copies each rank's block of the global arrays into the
template: the elastic re-shard of the reference's ``restore``, so a
checkpoint written on one process resumes on a mesh and the other way
round.
"""

from __future__ import annotations

import os
import queue
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel import collectives as coll
from repro_torch.train.tree import get_path, items

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]

_SEP = "|"
_BF16 = "__bfloat16__"


def _flatten(tree, shardings=None) -> dict:
    """{key path joined by "|": numpy array} on the host; bf16 leaves as
    their int16 bits, listed under ``__bfloat16__``; with ``shardings``,
    each sharded leaf gathered to its global array first."""
    out, bf16 = {}, []
    for path, leaf in items(tree):
        if leaf is None:
            continue
        key = _SEP.join(str(p) for p in path)
        sh = get_path(shardings, path) if shardings is not None else None
        if sh is not None and sh.dims():
            leaf = coll.gather_sharded(leaf.detach(), sh, "checkpoint")
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            bf16.append(key)
            leaf = leaf.view(torch.int16)
        out[key] = leaf.numpy().copy()
    if bf16:
        out[_BF16] = np.array(bf16)
    return out


def _save_flat(ckpt_dir: str, step: int, flat: dict, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    path = os.path.join(tmp, "state.npz")
    with open(path, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "DONE"), "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _prune(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, state: dict, *, keep: int = 3,
         shardings=None) -> str:
    """Atomically persist ``state`` (nested dicts of tensors) for ``step``;
    prune all but the newest ``keep``.  With ``shardings`` every rank of
    the mesh calls it: the sharded leaves are gathered, rank 0 writes, and
    every rank returns once the checkpoint is complete."""
    flat = _flatten(state, shardings)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if shardings is None or dist.get_rank() == 0:
        final = _save_flat(ckpt_dir, step, flat, keep)
    if shardings is not None:
        dist.barrier()
    return final


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(_complete_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _complete_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "DONE")):
                out.append(int(name.split("_")[1]))
    return out


def latest_step(ckpt_dir: str) -> int | None:
    steps = _complete_steps(ckpt_dir)
    return max(steps) if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, step: int, template: dict,
            shardings=None) -> dict:
    """Load ``step`` into the tensors of ``template`` in place, each cast
    to its template leaf's dtype; returns ``template``.  With
    ``shardings`` (keyed as ``template``) a leaf takes this rank's block of
    the stored array."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "state.npz")
    with np.load(path) as z:
        loaded = {k: z[k] for k in z.files}
    bf16 = set(loaded.pop(_BF16, np.array([], dtype=str)).tolist())
    for pathk, leaf in items(template):
        if leaf is None:
            continue
        key = _SEP.join(str(p) for p in pathk)
        src = torch.from_numpy(loaded[key])
        if key in bf16:
            src = src.view(torch.bfloat16)
        sh = get_path(shardings, pathk) if shardings is not None else None
        if sh is not None:
            src = sh.take(src)
        leaf.copy_(src.to(leaf.dtype))
    return template


class AsyncCheckpointer:
    """Latest-wins background writer: the train loop never blocks on I/O.
    ``submit`` copies the state to the host at once; the write runs in a
    thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Exception | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, step: int, state: dict):
        flat = _flatten(state)                  # gather now
        try:
            self._q.put_nowait((step, flat))
        except queue.Full:                      # drop the stale pending write
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._q.put_nowait((step, flat))

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, flat = item
            try:
                _save_flat(self.ckpt_dir, step, flat, self.keep)
            except Exception as e:              # surfaced on close()
                self._err = e

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise self._err
