"""Low-rank gradient compression with error feedback (PowerSGD-style), after
the reference's ``parallel/compression.py``.

Cuts data-parallel mean bytes for matrix-shaped gradients from ``m*n``
to ``r*(m+n)`` per matrix: one subspace-iteration round

    P = G Q ; P <- mean_dp(P) ; P <- orth(P) ; Q' = G^T P ; Q' <- mean_dp(Q')
    G_hat = P Q'^T ;  e <- G - G_hat   (error feedback, carried per worker)

Each rank runs it on its own gradients, so the two small factor means
replace the full-gradient one.  Leaves with >= 2 dims are compressed *per
trailing matrix* (stacked layer weights (L, m, n) are L independent
matrices, batched through the same products); everything else falls back
to a plain mean.  The projection basis Q warm-starts from the previous
step's factors, as PowerSGD prescribes.  The products and the QR are
``torch.matmul`` and ``torch.linalg.qr`` in fp32, as the reference's are
``jnp.einsum`` and ``jnp.linalg.qr``: no kernel of this package's own.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.parallel import collectives as coll
from repro_torch.train.tree import items, map_tree, unflatten

__all__ = ["CompressionConfig", "compression_init", "compress_and_sync"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    rank: int = 8
    min_dim: int = 64           # compress only if both trailing dims >= this
    seed: int = 0


def _eligible(shape, min_dim: int) -> bool:
    """Whether a leaf of ``shape`` is compressed: >= 2 dims, both trailing
    ones at least ``min_dim``."""
    return len(shape) >= 2 and min(shape[-2:]) >= min_dim


def compression_init(cfg: CompressionConfig, grads_template) -> dict:
    """Per-leaf state, keyed as ``grads_template`` (the parameters): None
    for a leaf left uncompressed, else {"q": (..., n, r) fp32, "err": (1,
    ...) fp32 zeros}.  Q is the same on every rank: drawn on the CPU from
    a generator seeded by ``cfg.seed`` and the leaf's index in sorted-path
    order, then moved to the leaf's device (a CUDA generator gives another
    stream).  "err" is this rank's row of the reference's (n_workers, ...)
    error-feedback buffer."""
    paths, leaves = [], []
    for i, (path, g) in enumerate(items(grads_template)):
        paths.append(path)
        if not _eligible(g.shape, cfg.min_dim):
            leaves.append(None)
            continue
        gen = torch.Generator().manual_seed(cfg.seed * 1_000_003 + i)
        q = torch.randn(tuple(g.shape[:-2]) + (g.shape[-1], cfg.rank),
                        generator=gen, dtype=torch.float32)
        leaves.append({"q": q.to(g.device),
                       "err": torch.zeros((1,) + tuple(g.shape),
                                          dtype=torch.float32,
                                          device=g.device)})
    return unflatten(paths, leaves)


def _orth(p: torch.Tensor) -> torch.Tensor:
    """Batched Gram-Schmidt via QR (r is tiny)."""
    q, _ = torch.linalg.qr(p.float())
    return q


def compress_and_sync(grads, comp_state, cfg: CompressionConfig, mesh,
                      axis_names: tuple[str, ...]):
    """Sync this rank's ``grads`` across the ranks of ``mesh`` that differ
    on ``axis_names`` (the DP axes).  Returns (synced grads, new
    comp_state, stats {"compression_ratio"}): each compressed leaf's G_hat
    in the gradient's dtype, every other leaf's mean, and the ratio of the
    full gradients' fp32 bytes to those that crossed, the reference's own
    count."""
    bytes_full = 0
    bytes_sent = 0

    def one(g, st):
        nonlocal bytes_full, bytes_sent
        gb = g.numel() * 4
        bytes_full += gb
        if st is None:
            bytes_sent += gb
            return coll.mean(g.clone(memory_format=torch.contiguous_format),
                             mesh, axis_names, "grad_mean"), None
        gf = g.float() + st["err"][0]             # local error feedback
        p = torch.matmul(gf, st["q"])
        p = _orth(coll.mean(p, mesh, axis_names, "powersgd_p"))
        qn = coll.mean(torch.matmul(gf.mT, p), mesh, axis_names,
                       "powersgd_q")
        ghat = torch.matmul(p, qn.mT)
        err = gf - ghat
        bytes_sent += (p.numel() + qn.numel()) * 4
        return ghat.to(g.dtype), {"q": qn, "err": err[None]}

    out = map_tree(one, grads, comp_state)
    new_g = map_tree(lambda o: o[0], out)
    new_s = map_tree(lambda o: o[1], out)
    stats = {"compression_ratio": bytes_full / max(bytes_sent, 1)}
    return new_g, new_s, stats
