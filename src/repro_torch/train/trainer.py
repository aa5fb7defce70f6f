"""Trainer, after the reference's ``train/trainer.py``: one AdamW step of
any zoo model on one device.

* microbatch gradient accumulation: each microbatch's gradients summed into
  fp32 buffers and divided by ``accum``, as the reference's ``lax.scan``
  (not summed by autograd into the parameters' dtype);
* optional spectral gradient clipping fed by the ``SpectralMonitor`` (the
  paper's SVD pipeline);
* the state updated in place: the parameters are the model's own, m and v
  are reused (the reference donates its state buffers to the step).

Sharding (``mesh=``, ``rules=``), ZeRO-1 and PowerSGD compression
(``compression=``) belong to ``parallel/``, ROADMAP Queue 1 item 12.3, and
are not ported: giving any of them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.train import optimizer as optim
from repro_torch.train.tree import items

__all__ = ["Trainer"]


def _unflatten(paths, leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


@dataclasses.dataclass
class Trainer:
    model: Any
    opt_cfg: optim.AdamWConfig
    mesh: Any = None
    rules: Any = None
    accum: int = 1
    compression: Any = None

    def __post_init__(self):
        for name in ("mesh", "rules", "compression"):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"Trainer({name}=...): sharding, ZeRO-1 and gradient "
                    f"compression are ROADMAP Queue 1 item 12.3 "
                    f"(parallel/), not ported yet")

    # ---------------- state -----------------------------------------------
    def init_state(self, generator: torch.Generator) -> dict:
        """The model's parameters drawn from ``generator`` and made
        trainable, and a fresh AdamW state: {"params", "opt"}."""
        self.model.init_params(generator)
        self.model.requires_grad_(True)
        params = self.model.params
        return {"params": params, "opt": optim.adamw_init(params)}

    # ---------------- step ------------------------------------------------
    def _grads(self, params, batch):
        """(loss, metrics, grads) of ``batch`` with respect to ``params``
        (the model's parameters); with accum > 1 the loss is the mean of
        the microbatches' losses, the gradients their fp32 mean and the
        metrics the last microbatch's."""
        paths = [path for path, _ in items(params)]
        leaves = [leaf for _, leaf in items(params)]

        def one(mb):
            loss, metrics = self.model.loss_fn(mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            return (loss.detach(), {k: v.detach() for k, v in
                                    metrics.items()}, grads)

        if self.accum <= 1:
            loss, metrics, grads = one(batch)
            return loss, metrics, _unflatten(paths, grads)
        b = len(batch["tokens"])
        if b % self.accum:
            raise ValueError(f"batch {b} does not split into {self.accum} "
                             f"microbatches")
        per = b // self.accum
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        loss_sum = 0.0
        for i in range(self.accum):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, metrics, grads = one(mb)
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
            loss_sum = loss_sum + loss
        for a in acc:
            a.div_(self.accum)
        return loss_sum / self.accum, metrics, _unflatten(paths, acc)

    def step(self, state: dict, batch: dict, sigma_tree=None):
        """One train step: (state updated in place, metrics)."""
        loss, metrics, grads = self._grads(state["params"], batch)
        params, opt, opt_metrics = optim.adamw_update(
            state["params"], grads, state["opt"], self.opt_cfg, sigma_tree)
        del grads
        return {"params": params, "opt": opt}, dict(metrics, **opt_metrics)

    def make_train_step(self):
        """``step(state, batch, sigma_tree=None) -> (state, metrics)``."""
        return self.step
