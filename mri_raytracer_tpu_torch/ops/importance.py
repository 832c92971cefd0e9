"""Differentiable inverse-CDF coarse-to-fine importance sampling (port of
``ops/importance.py``; reference ``docs/DifferentiableRendering.md §7``).

Coarse samples give importance weights w_k; a piecewise-linear CDF is
inverted at deterministic quantiles u_j. The inversion is written in closed
form (linear interpolation inside the selected bin), so reverse-mode
autograd yields exactly the doc's implicit-function gradient
``dt/dw = -(dF/dw)/(dF/dt)`` — sparse in the bracketing w_k.

Clips and maxima on the differentiated path are written as
``torch.minimum``/``torch.maximum`` with tensor bounds: at a tie they split
the gradient 0.5/0.5 as ``jnp.clip``/``jnp.maximum`` do, where
``torch.clamp`` would pass all of it.
"""

from __future__ import annotations

from typing import Callable

import torch

from mri_raytracer_tpu_torch.ops.diffrender import (alpha_from_sigma,
                                                    composite_fronttoback)


def _full(x: torch.Tensor, v: float) -> torch.Tensor:
    """A 0-d tensor ``v`` beside ``x``, made by a fill on its device (a
    ``new_tensor`` upload from host memory waits for the card's queue)."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with its gradient at ties."""
    return torch.minimum(torch.maximum(x, _full(x, lo)), _full(x, hi))


def _cdf_bin_index(t_bins: torch.Tensor, weights: torch.Tensor,
                   u: torch.Tensor, eps: float):
    """Shared CDF construction + per-quantile bin index (the
    non-differentiable 'locations' part). Returns (t_bins broadcast to
    weights' batch shape, cdf (..., K+1), idx (..., J) clipped to bins).
    The +eps keeps zero-mass bins from producing a degenerate CDF (see the
    in-bin fraction clip at the call sites)."""
    K = weights.shape[-1]
    t_bins = torch.broadcast_to(t_bins, weights.shape[:-1] + (K + 1,))
    W = torch.cumsum(weights + eps, dim=-1)
    total = W[..., -1:]
    cdf = torch.cat([torch.zeros_like(W[..., :1]), W], dim=-1) / total
    idx = torch.sum(cdf[..., None, :-1] <= u[..., :, None], dim=-1) - 1
    return t_bins, cdf, torch.clamp(idx, 0, K - 1)


def _in_bin(u, c0, c1, t0, t1, eps):
    """Linear interpolation inside the chosen bin. The in-bin fraction is
    clipped: bins with ~zero mass have c1 - c0 ~ 0 and an unclipped
    (u - c0) / eps shoots the sample far past the bin, breaking the
    monotonicity of t (negative dt downstream -> exploding alpha)."""
    frac = _clip((u - c0) / torch.maximum(c1 - c0, _full(c0, eps)),
                 0.0, 1.0)
    return t0 + frac * (t1 - t0)


def inverse_cdf_sample(t_bins: torch.Tensor, weights: torch.Tensor,
                       u: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """t_bins (..., K+1) bin edges, weights (..., K) >= 0, u (J,) in (0,1)
    -> (..., J) fine sample positions.

    The CDF is piecewise linear over bins; bin membership is found by a
    non-differentiable comparison count (locations), while the
    interpolation itself stays differentiable in t_bins and weights.
    """
    t_bins, cdf, idx = _cdf_bin_index(t_bins, weights, u, eps)
    c0 = torch.gather(cdf, -1, idx)
    c1 = torch.gather(cdf, -1, idx + 1)
    t0 = torch.gather(t_bins, -1, idx)
    t1 = torch.gather(t_bins, -1, idx + 1)
    return _in_bin(u, c0, c1, t0, t1, eps)


def inverse_cdf_sample_mm(t_bins: torch.Tensor, weights: torch.Tensor,
                          u: torch.Tensor, eps: float = 1e-6,
                          return_bin_dt: bool = False,
                          n_total: int = None):
    """``inverse_cdf_sample`` with the bin's four values (cdf and t at both
    edges) looked up together, and optionally the bin's expected step.

    The JAX package computes this lookup as a one-hot contraction, a TPU
    workaround (``take_along_axis`` on a minor axis is slow there); on the
    card a gather is cheap, so here it is one ``torch.gather`` of the
    stacked (..., K, 4) edge values. Values and gradients are the same: the
    discrete bin choice is non-differentiable in both, and the
    interpolation carries the gradients.

    ``return_bin_dt``: also return the importance-consistent per-sample step
    ``dt_j = min(len(bin_j) / (n_fine * mass(bin_j)), cap_j)`` with
    ``cap_j = 2 * max(len(bin_j), span / n_fine)`` — the EXPECTED local
    sample spacing. Using realized neighbor spacing instead bleeds the width
    of skipped gaps into the first/last sample of every content run
    (alpha = 1 - exp(-sigma dt) overweights run edges). The cap keeps
    rare samples in ~zero-mass bins from claiming unbounded optical depth;
    it scales with the uniform spacing span/n (a fixed k*len(bin) cap
    under-covers translucent full-span media whenever n < K/k).
    ``n_total``: the FULL fine-sample count when ``u`` is one block of a
    larger stratified train (blocked marches) — the per-sample dt is the
    expected spacing under the whole train, not the block.
    """
    t_bins, cdf, idx = _cdf_bin_index(t_bins, weights, u, eps)
    vals = torch.stack([cdf[..., :-1], cdf[..., 1:],
                        t_bins[..., :-1], t_bins[..., 1:]], dim=-1)  # (.,K,4)
    g = torch.gather(vals, -2, idx[..., None].expand(idx.shape + (4,)))
    c0, c1, t0, t1 = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
    t = _in_bin(u, c0, c1, t0, t1, eps)
    if not return_bin_dt:
        return t
    n_fine = n_total if n_total is not None else u.shape[-1]
    length = t1 - t0
    span = t_bins[..., -1:] - t_bins[..., :1]  # (..., 1) ray span
    cap = 2.0 * torch.maximum(length, span / n_fine)
    dt = torch.minimum(length / torch.maximum(n_fine * (c1 - c0),
                                              _full(c0, eps)), cap)
    return t, dt


def coarse_to_fine_render(field: Callable, importance_fn: Callable,
                          origins: torch.Tensor, dirs: torch.Tensor,
                          t0, t1, n_coarse: int = 32, n_fine: int = 64):
    """Two-stage differentiable render: coarse uniform probe of
    ``importance_fn`` -> inverse-CDF fine sample placement -> fine march of
    ``field`` with per-sample dt from the fine ts' neighbour spacing.
    Returns (C (..., 3), T (...), t_f (..., n_fine))."""
    dev = origins.device
    t0 = torch.as_tensor(t0, dtype=torch.float32, device=dev)
    t1 = torch.as_tensor(t1, dtype=torch.float32, device=dev)
    k = torch.arange(n_coarse + 1, dtype=torch.float32, device=dev) / n_coarse
    t_bins = t0[..., None] + k * (t1 - t0)[..., None]  # (..., K+1)
    t_mid = 0.5 * (t_bins[..., :-1] + t_bins[..., 1:])
    x_c = origins[..., None, :] + t_mid[..., None] * dirs[..., None, :]
    w = importance_fn(x_c)  # (..., K) >= 0

    u = (torch.arange(n_fine, dtype=torch.float32, device=dev) + 0.5) / n_fine
    t_f = inverse_cdf_sample(t_bins, w, u)  # (..., J)
    t_f = torch.sort(t_f, dim=-1).values
    x_f = origins[..., None, :] + t_f[..., None] * dirs[..., None, :]
    sigma, rgb = field(x_f)
    # Per-sample dt: symmetric neighbour spacing (trapezoid-ish weights).
    d = torch.diff(t_f, dim=-1)
    dt = torch.cat([d[..., :1], 0.5 * (d[..., :-1] + d[..., 1:]),
                    d[..., -1:]], dim=-1)
    alphas = alpha_from_sigma(sigma, dt)
    C, T = composite_fronttoback(rgb, alphas)
    return C, T, t_f
