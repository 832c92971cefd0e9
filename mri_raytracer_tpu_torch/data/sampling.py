"""On-device voxel batch samplers (port of ``data/sampling.py``, reference
D11-D13).

Every sampler draws from the ``torch.Generator`` it is given, on the pool's
device, with static shapes and no host round trip. Biased sampling is
*candidate oversampling + top-k selection* (``torch.topk``), as in the JAX
package:

  * uniform        — reference ``sample_batch`` (inr/inr/dataloader.py:133-155)
  * tumor-biased   — draw C >= tb candidates, score = 2 * is_tumor + U(0,1),
                     take the top tb; the remainder uniform
  * class-balanced — per-class minimum quotas for classes 1..3
  * hybrid         — 50/30/20 uncertainty/balanced/uniform mix (improved.ipynb
                     §9); the MC-dropout entropy of the current model scores
                     the uncertainty candidates, under ``torch.no_grad()``
                     (the JAX step never differentiates through its sampler
                     either)

All samplers return ``SampleBatch(coords (B,3), intensities (B,M),
labels (B,), weights (B,))`` with coords normalized to [-1, 1] per axis
(reference convention ``coords/(dims-1)*2-1``). JAX's key streams cannot be
reproduced in torch: the tests hold the deterministic parts exactly
(indices in, batch out) and the draws by their statistics.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mri_raytracer_tpu_torch.env import device_floats


class SampleBatch(NamedTuple):
    coords: torch.Tensor  # (B, 3) normalized [-1, 1]
    intensities: torch.Tensor  # (B, M)
    labels: torch.Tensor  # (B,) int32
    weights: torch.Tensor  # (B,) per-sample loss weights (1.0 default)


def _normalize(ix, iy, iz, shape) -> torch.Tensor:
    H, W, D = shape
    c = torch.stack([ix, iy, iz], dim=-1).to(torch.float32)
    return (c / device_floats((H - 1, W - 1, D - 1), c.device)) * 2.0 - 1.0


def gather_pool(mods_pool, segs_pool, ci, ix, iy, iz):
    """Vectorized gather of (B,M) intensities + (B,) labels from a stacked
    pool (the advanced indices around the slice put B first, as in numpy)."""
    intens = mods_pool[ci, :, ix, iy, iz]
    labels = segs_pool[ci, ix, iy, iz]
    return intens, labels.to(torch.int32)


def _randint(generator, high: int, n: int, device) -> torch.Tensor:
    return torch.randint(0, high, (n,), generator=generator, device=device)


def _random_idx(generator, batch: int, pool_shape, device):
    P, _, H, W, D = pool_shape
    return tuple(_randint(generator, n, batch, device) for n in (P, H, W, D))


def _boundary_weights(boundary_pool, ci, ix, iy, iz) -> torch.Tensor:
    """Per-sample loss weights: boundary-map gather when available, else 1."""
    if boundary_pool is None:
        return torch.ones(ci.shape, dtype=torch.float32, device=ci.device)
    return boundary_pool[ci, ix, iy, iz]


def _batch(mods_pool, segs_pool, idx, boundary_pool) -> SampleBatch:
    ci, ix, iy, iz = idx
    intens, labels = gather_pool(mods_pool, segs_pool, ci, ix, iy, iz)
    return SampleBatch(_normalize(ix, iy, iz, tuple(mods_pool.shape[2:])),
                       intens, labels,
                       _boundary_weights(boundary_pool, ci, ix, iy, iz))


def _cat(parts):
    return tuple(torch.cat([p[i] for p in parts]) for i in range(4))


def _topk_idx(idx, score, k: int):
    sel = torch.topk(score, k).indices
    return tuple(t[sel] for t in idx)


def sample_uniform(generator, mods_pool, segs_pool, batch: int,
                   boundary_pool=None) -> SampleBatch:
    idx = _random_idx(generator, batch, mods_pool.shape, mods_pool.device)
    return _batch(mods_pool, segs_pool, idx, boundary_pool)


def _scored_candidates(generator, segs_pool, pool_shape, n: int,
                       oversample: int, hit: Callable):
    """Top ``n`` of ``max(n * oversample, n)`` random voxels by
    ``2 * hit(label) + U(0, 1)``."""
    C = max(n * oversample, n)
    dev = segs_pool.device
    idx = _random_idx(generator, C, pool_shape, dev)
    labels_c = segs_pool[idx]
    score = hit(labels_c).to(torch.float32) * 2.0 + torch.rand(
        (C,), generator=generator, device=dev)
    return _topk_idx(idx, score, n)


def sample_tumor_biased(generator, mods_pool, segs_pool, batch: int,
                        tumor_ratio: float, oversample: int = 4,
                        boundary_pool=None) -> SampleBatch:
    """`tb = batch*tumor_ratio` tumor-preferred samples + uniform remainder."""
    tb = int(round(batch * float(tumor_ratio)))
    rb = batch - tb
    parts = []
    if tb > 0:
        parts.append(_scored_candidates(generator, segs_pool,
                                        mods_pool.shape, tb, oversample,
                                        lambda lab: lab > 0))
    if rb > 0:
        parts.append(_random_idx(generator, rb, mods_pool.shape,
                                 mods_pool.device))
    return _batch(mods_pool, segs_pool, _cat(parts), boundary_pool)


def _class_balanced_idx(generator, segs_pool, pool_shape, batch: int,
                        min_counts: Tuple[int, int, int], oversample: int):
    """Index tuple (ci, ix, iy, iz) honoring per-class quotas for 1..3."""
    total_quota = int(sum(min_counts))
    if total_quota > batch:
        raise ValueError(f"sum(min_counts)={total_quota} > batch={batch}")
    parts = []
    for cls, need in enumerate(min_counts, start=1):
        if need <= 0:
            continue
        parts.append(_scored_candidates(generator, segs_pool, pool_shape,
                                        need, oversample,
                                        lambda lab, c=cls: lab == c))
    rb = batch - total_quota
    if rb > 0:
        parts.append(_random_idx(generator, rb, pool_shape,
                                 segs_pool.device))
    return _cat(parts)


def sample_class_balanced(generator, mods_pool, segs_pool, batch: int,
                          min_counts: Tuple[int, int, int],
                          oversample: int = 8,
                          boundary_pool=None) -> SampleBatch:
    """Per-class minimum quotas for classes 1..3, remainder uniform."""
    idx = _class_balanced_idx(generator, segs_pool, mods_pool.shape, batch,
                              min_counts, oversample)
    return _batch(mods_pool, segs_pool, idx, boundary_pool)


def sample_hybrid(generator, mods_pool, segs_pool, batch: int,
                  uncertainty_fn: Optional[Callable] = None,
                  boundary_pool: Optional[torch.Tensor] = None,
                  mix: Tuple[float, float, float] = (0.5, 0.3, 0.2),
                  balanced_counts: Tuple[int, int, int] = (0, 0, 0),
                  oversample: int = 4) -> SampleBatch:
    """Uncertainty-guided / class-balanced / uniform mix (reference D13).

    ``uncertainty_fn(coords, intensities) -> (C,) entropy`` scores candidate
    voxels (the engine passes an MC-dropout entropy closure over current
    params). Boundary weights are gathered from ``boundary_pool`` for EVERY
    sub-batch (uncertainty, balanced, and uniform alike).
    """
    n_unc = int(round(batch * mix[0]))
    n_bal = int(round(batch * mix[1]))
    n_uni = batch - n_unc - n_bal
    dev = mods_pool.device
    H, W, D = mods_pool.shape[2:]
    parts = []
    if n_unc > 0:
        C = max(n_unc * oversample, n_unc)
        idx = _random_idx(generator, C, mods_pool.shape, dev)
        if uncertainty_fn is not None:
            intens_c, _ = gather_pool(mods_pool, segs_pool, *idx)
            with torch.no_grad():
                score = uncertainty_fn(_normalize(*idx[1:], (H, W, D)),
                                       intens_c)
        else:
            score = torch.rand((C,), generator=generator, device=dev)
        parts.append(_topk_idx(idx, score, n_unc))
    if n_bal > 0:
        cnt = balanced_counts if sum(balanced_counts) > 0 else (
            n_bal // 3, n_bal // 3, n_bal - 2 * (n_bal // 3))
        parts.append(_class_balanced_idx(generator, segs_pool,
                                         mods_pool.shape, n_bal, cnt,
                                         oversample))
    if n_uni > 0:
        parts.append(_random_idx(generator, n_uni, mods_pool.shape, dev))
    return _batch(mods_pool, segs_pool, _cat(parts), boundary_pool)


def mc_dropout_entropy(model, params, coords, intensities, generator,
                       n_mc: int) -> torch.Tensor:
    """(N,) predictive entropy of the mean softmax over ``n_mc`` dropout
    draws of ``model`` (train mode), no gradient."""
    with torch.no_grad():
        probs = torch.stack([
            torch.softmax(model.apply(params, coords, intensities,
                                      rng=generator, train=True), dim=-1)
            for _ in range(n_mc)]).mean(dim=0)
        return -torch.sum(probs * torch.log(probs + 1e-8), dim=-1)


def make_sampler(kind: str, batch: int, tumor_ratio: float = 0.5,
                 min_counts: Optional[Tuple[int, int, int]] = None,
                 model=None, mc_dropout: int = 4):
    """Sampler factory keyed by DataConfig.sampler.

    All samplers share the protocol
    ``fn(generator, mods, segs, params=None, boundary=None)``; only
    'hybrid' uses ``params`` — it scores candidate voxels by MC-dropout
    predictive entropy of the CURRENT model. ``boundary`` is an optional
    ``(P, H, W, D)`` boundary-distance weight pool gathered into per-sample
    loss weights (reference L8 boundary-weighted loss).
    """
    if kind == "uniform":
        return lambda g, mods, segs, params=None, boundary=None: \
            sample_uniform(g, mods, segs, batch, boundary)
    if kind == "tumor":
        return lambda g, mods, segs, params=None, boundary=None: \
            sample_tumor_biased(g, mods, segs, batch, tumor_ratio,
                                boundary_pool=boundary)
    if kind == "balanced":
        mc = min_counts or (batch // 8, batch // 8, batch // 8)
        return lambda g, mods, segs, params=None, boundary=None: \
            sample_class_balanced(g, mods, segs, batch, mc,
                                  boundary_pool=boundary)
    if kind == "hybrid":
        def hybrid(g, mods, segs, params=None, boundary=None):
            ufn = None
            if params is not None and model is not None:
                def ufn(coords, intens):
                    return mc_dropout_entropy(model, params, coords, intens,
                                              g, mc_dropout)

            return sample_hybrid(g, mods, segs, batch, uncertainty_fn=ufn,
                                 boundary_pool=boundary)

        return hybrid
    raise ValueError(f"unknown sampler {kind!r}")


def sample_batch_host(generator, batch_size: int, cache, vol_shape
                      ) -> SampleBatch:
    """Host-cache path for API parity with reference ``sample_batch``: the
    indices are drawn on the generator's device, gathered from the host
    cache, and the batch returned on that device."""
    H, W, D = vol_shape
    dev = generator.device
    ci, xs, ys, zs = (_randint(generator, n, batch_size, dev)
                      for n in (cache.n_cases, H, W, D))
    intens, labels = cache.sample_voxels(*(np.asarray(t.cpu())
                                           for t in (ci, xs, ys, zs)))
    return SampleBatch(_normalize(xs, ys, zs, (H, W, D)),
                       torch.as_tensor(intens, device=dev),
                       torch.as_tensor(labels, dtype=torch.int32,
                                       device=dev),
                       torch.ones((batch_size,), dtype=torch.float32,
                                  device=dev))
