"""Trainer, after the reference's ``train/trainer.py``: one AdamW step of
any zoo model, on one device or data-parallel over a process mesh.

* microbatch gradient accumulation: each microbatch's gradients summed into
  fp32 buffers and divided by ``accum``, as the reference's ``lax.scan``
  (not summed by autograd into the parameters' dtype);
* optional spectral gradient clipping fed by the ``SpectralMonitor`` (the
  paper's SVD pipeline);
* the state updated in place: the parameters are the model's own, m and v
  are reused (the reference donates its state buffers to the step);
* over a ``launch.mesh.ProcessMesh`` (``mesh=``, ``rules=``, by default
  ``launch.mesh.rules_for(mesh)``): each rank takes its rows of the global
  batch, by its coordinates on the axes the "batch" rule splits (its rows
  of each microbatch), weights each microbatch's gradients by its share
  of that microbatch's mask, and the gradients' mean runs over those
  axes.  m and v live only as each rank's ZeRO-1 block
  (``parallel.sharding.zero1_shardings`` over ``dp_axes``): a rank
  updates its block of each parameter and the blocks are gathered,
  so every rank holds the whole parameters, and the step is the one-device
  step on the global batch, as the reference's GSPMD step is;
* optional PowerSGD compression over the DP axes (``compression=``, which
  needs a mesh): each rank's gradients of its rows go through
  ``parallel.compression.compress_and_sync``, then every rank runs the full
  AdamW (m and v whole), as the reference's ``shard_map`` step does.

A mesh whose "model" axis is larger than 1 (tensor and expert parallelism)
and an MoE config under a mesh (its Switch aux loss needs the expert loads
of the whole batch) raise ``NotImplementedError``: ROADMAP Queue 1 item
12.5.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.zoo import batch_logical
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import compression as comp
from repro_torch.parallel.sharding import (AxisRules, P, Sharding,
                                           map_logical, param_shardings,
                                           zero1_shardings)
from repro_torch.train import optimizer as optim
from repro_torch.train.data import host_slice
from repro_torch.train.tree import get_path, items, map_tree, unflatten

__all__ = ["Trainer"]


@dataclasses.dataclass
class Trainer:
    model: Any
    opt_cfg: optim.AdamWConfig
    mesh: Any = None
    rules: AxisRules | None = None
    accum: int = 1
    compression: comp.CompressionConfig | None = None
    dp_axes: tuple[str, ...] = ("data",)

    def __post_init__(self):
        if self.compression is not None and self.mesh is None:
            raise ValueError(
                "Trainer(compression=...) needs mesh=: PowerSGD averages "
                "its factors across the data-parallel ranks of a process "
                "mesh")
        if self.mesh is None:
            return
        if self.mesh.shape.get("model", 1) > 1:
            raise NotImplementedError(
                f"a mesh with a 'model' axis of {self.mesh.shape['model']}: "
                f"tensor and expert parallelism over 'model' are ROADMAP "
                f"Queue 1 item 12.5, not ported")
        if self.model.cfg.kind == "moe":
            raise NotImplementedError(
                "an MoE config under a mesh: its Switch aux loss needs the "
                "expert loads of the whole batch (ROADMAP Queue 1 item "
                "12.5, with expert parallelism)")
        if self.rules is None:
            from repro_torch.launch.mesh import rules_for
            self.rules = rules_for(self.mesh)
        elif self.rules.mesh is None:
            self.rules = dataclasses.replace(self.rules, mesh=self.mesh)
        self._dp = tuple(a for a in self.dp_axes if a in self.mesh.shape)
        batch = self.rules.spec(("batch",))[0]
        self._batch_axes = (() if batch is None else batch
                            if isinstance(batch, tuple) else (batch,))
        # where m and v live: each rank's ZeRO-1 block, or (compressed) the
        # whole leaf
        logical = self.model.param_logical()
        self._m_sh = (param_shardings(logical, self.rules)
                      if self.compression is not None else
                      zero1_shardings(logical, self.model.param_shapes(),
                                      self.rules, self.dp_axes))

    # ---------------- state -----------------------------------------------
    def init_state(self, generator: torch.Generator) -> dict:
        """The model's parameters drawn from ``generator`` and made
        trainable, and a fresh AdamW state: {"params", "opt"}.  Under a
        mesh every rank holds rank 0's parameters, m and v zeros of this
        rank's block, and, compressed, {"comp"}
        (``compression.compression_init``)."""
        self.model.init_params(generator)
        self.model.requires_grad_(True)
        params = self.model.params
        if self.mesh is None:
            return {"params": params, "opt": optim.adamw_init(params)}
        for _, p in items(params):
            coll.broadcast(p.detach(), self.mesh, "init_params")

        def zeros(p, sh):
            return torch.zeros(sh.local_shape(p.shape), dtype=torch.float32,
                               device=p.device)
        state = {"params": params, "opt": {
            "step": torch.zeros((), dtype=torch.int32,
                                device=self.model.device),
            "m": map_tree(zeros, params, self._m_sh),
            "v": map_tree(zeros, params, self._m_sh)}}
        if self.compression is not None:
            state["comp"] = comp.compression_init(self.compression, params)
        return state

    def state_shardings(self, state=None):
        """The Shardings of the state under the mesh (None without one):
        what ``checkpoint.save`` gathers, and what ``checkpoint.restore``
        and ``convert.train_state_from_reference`` take of each leaf.
        PowerSGD's part follows from the parameters' shapes (``state``,
        which the reference's signature takes, is not needed)."""
        if self.mesh is None:
            return None
        rep = Sharding(self.mesh, P())
        out = {"params": param_shardings(self.model.param_logical(),
                                         self.rules),
               "opt": {"step": rep, "m": self._m_sh, "v": self._m_sh}}
        if self.compression is not None:
            err = Sharding(self.mesh, P(self._dp))
            min_dim = self.compression.min_dim
            out["comp"] = map_logical(
                lambda _, shape: {"q": rep, "err": err}
                if comp._eligible(shape, min_dim) else None,
                self.model.param_logical(), self.model.param_shapes())
        return out

    def batch_shardings(self, suite):
        if self.mesh is None:
            return None
        return map_logical(lambda lg: Sharding(self.mesh,
                                               self.rules.spec(lg)),
                           batch_logical(self.model.cfg, suite))

    # ---------------- step ------------------------------------------------
    def _grads(self, params, batch, weights=None):
        """(loss, metrics, grads) of ``batch`` with respect to ``params``
        (the model's parameters); with accum > 1 the loss is the mean of
        the microbatches' losses, the gradients their fp32 mean and the
        metrics the last microbatch's.  ``weights`` (one a microbatch)
        scale each microbatch's gradients, in fp32; loss and metrics stay
        unscaled."""
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
            if weights is not None and weights[0] != 1.0:
                grads = [g.float().mul_(weights[0]) for g in grads]
            return loss, metrics, unflatten(paths, grads)
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
            w = 1.0 if weights is None else weights[i]
            for a, g in zip(acc, grads):
                a.add_(g, alpha=w)
            del grads
            loss_sum = loss_sum + loss
        for a in acc:
            a.div_(self.accum)
        return loss_sum / self.accum, metrics, unflatten(paths, acc)

    def _rows(self, batch: dict, axes, per_microbatch: bool) -> dict:
        """This rank's rows of the global ``batch``, by its coordinates on
        ``axes`` (the first major): its contiguous block, or with
        ``per_microbatch`` and accum > 1 its block of each microbatch of
        the global batch (microbatch i its rows i * b / accum on), which
        the reference's GSPMD step splits the global batch into."""
        n, idx = 1, 0
        for a in axes:
            n *= self.mesh.shape[a]
            idx = idx * self.mesh.shape[a] + self.mesh.coords[a]
        b = len(batch["tokens"])
        split = self.accum if per_microbatch else 1
        if b % (n * split):
            raise ValueError(f"global batch {b} does not split over {axes} "
                             f"({n} ranks) and {split} microbatches")
        if n == 1:
            return batch
        if split == 1:
            return host_slice(batch, idx, n)
        per = b // (n * split)

        def take(x):
            rest = tuple(x.shape[1:])
            x = x.reshape((split, b // split) + rest)
            return x[:, idx * per:(idx + 1) * per].reshape((-1,) + rest)
        return {k: take(v) for k, v in batch.items()}

    def _mean_metrics(self, metrics: dict, axes, scale: float = 1.0) -> dict:
        """Each metric (times ``scale``) averaged over ``axes``, in one
        collective."""
        names = sorted(metrics)
        vec = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                           device=self.model.device) * scale
                           for k in names])
        coll.mean(vec, self.mesh, axes, "metrics")
        return dict(zip(names, vec.unbind()))

    def step(self, state: dict, batch: dict, sigma_tree=None):
        """One train step on the global ``batch``: (state updated in
        place, metrics).  The compressed step takes no ``sigma_tree``, as
        the reference's does not."""
        if self.mesh is not None:
            if self.compression is not None:
                return self._compressed_step(state, batch)
            return self._sharded_step(state, batch, sigma_tree)
        loss, metrics, grads = self._grads(state["params"], batch)
        params, opt, opt_metrics = optim.adamw_update(
            state["params"], grads, state["opt"], self.opt_cfg, sigma_tree)
        del grads
        return {"params": params, "opt": opt}, dict(metrics, **opt_metrics)

    def _loss_weights(self, local: dict) -> list[float]:
        """Each microbatch's weight on this rank: its share of that global
        microbatch's loss denominator (the mask's sum over the batch axes)
        times the ranks, so that the mean over the batch axes of each
        rank's weighted microbatch mean is the global microbatch's mean, as
        the reference's step takes it.  1 where the shares are equal."""
        split = max(self.accum, 1)
        mask = local.get("mask")
        if mask is None:
            return [1.0] * split
        mask = torch.as_tensor(mask, device=self.model.device)
        counts = mask.reshape(split, -1).sum(1, dtype=torch.float64)
        total = coll.psum(counts.clone(), self.mesh, self._batch_axes,
                          "loss_weight")
        n_ranks = math.prod(self.mesh.shape[a] for a in self._batch_axes)
        return [max(c, 1.0) * n_ranks / max(t, 1.0)
                for c, t in zip(counts.tolist(), total.tolist())]

    def _sharded_step(self, state, batch, sigma_tree=None):
        """Data parallel with ZeRO-1: each rank's rows (of each global
        microbatch), each microbatch's gradients weighted by
        ``_loss_weights``, the mean over the batch axes and ZeRO-1's
        reduce-scatter over ``dp_axes``, AdamW on the blocks, the blocks
        gathered."""
        mesh, baxes = self.mesh, self._batch_axes
        local = self._rows(batch, baxes, per_microbatch=True)
        weights = self._loss_weights(local)
        loss, metrics, grads = self._grads(state["params"], local, weights)
        m_sh = self._m_sh
        paths, synced, slices = [], [], []
        for path, p in items(state["params"]):
            g = get_path(grads, path).float().contiguous()
            sh = get_path(m_sh, path)
            dims = sh.dims()
            if dims:
                dim, axes = dims[0]
                coll.mean(g, mesh, [a for a in baxes if a not in axes],
                          "grad_mean")
                g = coll.reduce_scatter(g, mesh, axes, dim,
                                        "zero1_reduce_scatter")
                slices.append(sh.local_slices(p.shape))
            else:
                coll.mean(g, mesh, baxes, "grad_mean")
                slices.append(None)
            paths.append(path)
            synced.append(g)
        del grads
        if sigma_tree is not None:
            sigma_tree = map_tree(lambda s: None if s is None else
                                  coll.broadcast(torch.as_tensor(
                                      s, device=self.model.device).clone(),
                                      mesh, "sigma"), sigma_tree)
        params, opt, opt_metrics = optim.adamw_update(
            state["params"], unflatten(paths, synced), state["opt"],
            self.opt_cfg, sigma_tree, slices=unflatten(paths, slices),
            reduce_sq=lambda x: coll.psum(x.reshape(1), mesh, self._dp,
                                          "grad_norm")[0])
        del synced
        for (path, p), sl in zip(items(params), slices):
            if sl is not None:
                dim, axes = get_path(m_sh, path).dims()[0]
                full = p.detach()
                coll.all_gather(full[sl], mesh, axes, dim, "param_all_gather",
                                out=full)
        metrics = self._mean_metrics(metrics, baxes, weights[-1])
        return {"params": params, "opt": opt}, dict(metrics, **opt_metrics)

    def _compressed_step(self, state, batch):
        """The reference's manual-over-DP step: gradients of each rank's
        rows (never synced at full size), PowerSGD's factors the only
        cross-rank traffic of the eligible leaves, error feedback kept on
        each rank, then the full AdamW on every rank; metrics averaged."""
        dp = self._dp
        loss, metrics, grads = self._grads(
            state["params"], self._rows(batch, dp, per_microbatch=False))
        grads, new_comp, stats = comp.compress_and_sync(
            grads, state["comp"], self.compression, self.mesh, dp)
        params, opt, opt_metrics = optim.adamw_update(
            state["params"], grads, state["opt"], self.opt_cfg, None)
        del grads
        metrics = self._mean_metrics(dict(metrics, **opt_metrics), dp)
        metrics["compression_ratio"] = stats["compression_ratio"]
        return {"params": params, "opt": opt, "comp": new_comp}, metrics

    def make_train_step(self):
        """``step(state, batch, sigma_tree=None) -> (state, metrics)``."""
        return self.step
