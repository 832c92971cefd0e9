"""Differentiable isosurface intersection (port of ``ops/isosurface.py``;
reference ``docs/DifferentiableRendering.md §10``).

Root-find t* with s(x(t*); theta) = s0 by a bracketing march and bisection;
gradients come from the implicit function theorem in a
``torch.autograd.Function``:
    dt*/dtheta = - (ds/dtheta at x*) / (grad_x s . d)
    dt*/do     = - grad_x s / (grad_x s . d)
    dt*/dd     = - t* grad_x s / (grad_x s . d)
so the (non-differentiable) iteration count never enters the graph.

``field_s(params, x) -> s`` takes its parameters explicitly: a tensor or a
tuple of tensors, each of which receives a gradient.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import torch

Params = Union[torch.Tensor, Sequence[torch.Tensor]]


def _bisect_root(f, lo, hi, iters: int = 24):
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = f(mid) < 0.0
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _solve(field_s, s0, n_probe, params, origins, dirs, t_lo, t_hi):
    """First entering crossing of s = s0 per ray -> (t*, hit)."""
    i = torch.arange(n_probe, device=origins.device)
    ts = t_lo[..., None] + (i + 0.5) / n_probe * (t_hi - t_lo)[..., None]
    x = origins[..., None, :] + ts[..., None] * dirs[..., None, :]
    vals = field_s(params, x) - s0  # (..., P)
    enter = (vals[..., :-1] < 0.0) & (vals[..., 1:] >= 0.0)
    has = torch.any(enter, dim=-1)
    first = torch.argmax(enter.to(torch.uint8), dim=-1, keepdim=True)
    lo = torch.gather(ts, -1, first)[..., 0]
    hi = torch.gather(ts, -1, first + 1)[..., 0]

    def f(t):
        return field_s(params, origins + t[..., None] * dirs) - s0

    t_star = _bisect_root(f, lo, hi)
    return torch.where(has, t_star, t_hi), has


class _IsosurfaceIntersect(torch.autograd.Function):
    """apply(field_s, s0, n_probe, packed, origins, dirs, t_lo, t_hi,
    *param_tensors); ``packed`` says whether ``field_s`` takes one tensor
    or a tuple."""

    @staticmethod
    def forward(ctx, field_s, s0, n_probe, packed, origins, dirs, t_lo, t_hi,
                *ps):
        params = ps if packed else ps[0]
        t_star, has = _solve(field_s, s0, n_probe, params, origins, dirs,
                             t_lo, t_hi)
        ctx.field_s, ctx.packed = field_s, packed
        ctx.save_for_backward(origins, dirs, t_star, has, *ps)
        ctx.mark_non_differentiable(has)
        return t_star, has

    @staticmethod
    def backward(ctx, g_t, _g_has):
        origins, dirs, t_star, has, *ps = ctx.saved_tensors
        x_star = (origins + t_star[..., None] * dirs).detach()
        with torch.enable_grad():
            x = x_star.requires_grad_(True)
            pr = [p.detach().requires_grad_(p.is_floating_point())
                  for p in ps]
            s = ctx.field_s(tuple(pr) if ctx.packed else pr[0], x)
            (grad_x,) = torch.autograd.grad(s.sum(), x, retain_graph=True)
            denom = torch.sum(grad_x * dirs, dim=-1)
            denom = torch.where(torch.abs(denom) < 1e-8,
                                torch.full_like(denom, 1e-8), denom)
            scale = torch.where(has, g_t / denom, torch.zeros_like(denom))
            # Params gradient: VJP of s(params, x*) with cotangent -scale.
            diff = [p for p in pr if p.requires_grad]
            d_diff = iter(torch.autograd.grad(s, diff, -scale,
                                              allow_unused=True)
                          if diff else ())
        d_params = [next(d_diff) if p.requires_grad else None for p in pr]
        d_o = -scale[..., None] * grad_x
        d_d = d_o * t_star[..., None]
        return (None, None, None, None, d_o, d_d, torch.zeros_like(t_star),
                torch.zeros_like(t_star), *d_params)


def isosurface_intersect(field_s: Callable, s0: float, n_probe: int,
                         params: Params, origins: torch.Tensor,
                         dirs: torch.Tensor, t_lo: torch.Tensor,
                         t_hi: torch.Tensor):
    """First entering crossing of s(x) = s0 along each ray -> (t*, hit).
    Differentiable in ``params`` (a tensor or a tuple of tensors),
    ``origins`` and ``dirs``; ``field_s``, ``s0`` and ``n_probe`` are not
    differentiated. Rays without a crossing return t_hi and no gradient."""
    packed = not isinstance(params, torch.Tensor)
    ps = tuple(params) if packed else (params,)
    return _IsosurfaceIntersect.apply(field_s, float(s0), int(n_probe),
                                      packed, origins, dirs, t_lo, t_hi, *ps)


def intersect(field_s: Callable, params: Params, origins: torch.Tensor,
              dirs: torch.Tensor, s0: float = 0.0, t0=0.0, t1=4.0,
              n_probe: int = 64):
    """Convenience wrapper with scalar t bounds."""
    shape = origins.shape[:-1]
    t_lo = torch.full(shape, float(t0), dtype=origins.dtype,
                      device=origins.device)
    t_hi = torch.full(shape, float(t1), dtype=origins.dtype,
                      device=origins.device)
    return isosurface_intersect(field_s, s0, n_probe, params, origins, dirs,
                                t_lo, t_hi)
