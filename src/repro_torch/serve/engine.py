"""Token serving with continuous batching and static shapes, after the
reference's ``serve/engine.py`` (``Engine``).

Requests queue up; up to ``max_batch`` live in fixed KV-cache slots with
*per-slot positions* (``decode_step`` takes a (b,) position vector).  Every
round issues ONE batched decode step: prefilling slots feed their next
prompt token, generating slots feed their last sampled token, finished
slots are refilled from the queue.  Greedy sampling; the padded-vocab tail
is masked at sample time.  Idle slots sit at position 0 and write their row
0 every round, as in the reference.

The model carries its weights and its device (``models.zoo.Model``); the
caches live on the same device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Request", "ServeConfig", "Engine"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 4
    max_seq: int = 128
    eos_id: int = -1                          # -1: never stop early


class _Slot:
    __slots__ = ("req", "pos", "k", "next_tok")

    def __init__(self, req):
        self.req = req
        self.pos = 0                          # next cache position to write
        self.k = 0                            # prompt cursor
        self.next_tok = req.prompt[0]


class Engine:
    def __init__(self, model, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.slots: list[_Slot | None] = [None] * cfg.max_batch
        self.rounds = 0                       # decode steps issued
        self.caches = model.init_caches(cfg.max_batch, cfg.max_seq)

    def submit(self, req: Request):
        assert len(req.prompt) >= 1
        self.queue.append(req)

    def _admit(self):
        for i in range(self.cfg.max_batch):
            if self.slots[i] is None and self.queue:
                self.slots[i] = _Slot(self.queue.pop(0))

    def step(self) -> int:
        """One batched decode round.  Returns number of active slots."""
        self._admit()
        act = [i for i, s in enumerate(self.slots) if s is not None]
        if not act:
            return 0
        b = self.cfg.max_batch
        toks = np.zeros((b, 1), np.int64)
        pos = np.zeros((b,), np.int64)
        for i in act:
            s = self.slots[i]
            toks[i, 0] = s.next_tok
            pos[i] = s.pos
        dev = self.model.device
        self.rounds += 1
        logits, self.caches = self.model.decode_step(
            torch.from_numpy(toks).to(dev), self.caches,
            torch.from_numpy(pos).to(dev))
        v = self.model.cfg.vocab
        nxt = torch.argmax(logits[:, 0, :v], dim=-1).cpu().numpy()
        for i in act:
            s = self.slots[i]
            s.pos += 1
            s.k += 1
            if s.k < len(s.req.prompt):           # still prefilling
                s.next_tok = int(s.req.prompt[s.k])
                continue
            tok = int(nxt[i])
            s.req.output.append(tok)
            s.next_tok = tok
            if (tok == self.cfg.eos_id
                    or len(s.req.output) >= s.req.max_new_tokens
                    or s.pos >= self.cfg.max_seq - 1):
                s.req.done = True
                self.finished.append(s.req)
                self.slots[i] = None
        return len(act)

    def run(self, max_rounds: int = 10_000) -> list[Request]:
        end = self.rounds + max_rounds
        while (self.queue or any(self.slots)) and self.rounds < end:
            self.step()
        return self.finished
