"""Volume sampling: trilinear + nearest-neighbor gather.

Port of ``ops/trilinear.py:24-135``. Semantics match the reference
shader samplers (``inr/viewer/brats_rt.slang:60-83``):
  * trilinear: clamp point to [0, dims - 1.001], floor to the base corner,
    8-corner lerp (x fastest, then y, then z)
  * nearest: round(clamp(p, 0, dims - 1)) (round half to even, as jnp)

Volumes are indexed ``vol[x, y, z]``.

``trilinear_sample`` is a ``torch.autograd.Function`` with the JAX
package's custom VJP (``_tri_fwd``/``_tri_bwd``): the grid gradient is the
8 corner weights scattered back (``index_add_`` on the flat grid), the
position gradient the analytic one, zero for clamped points. Autograd
through ``trilinear_sample_base`` differentiates the same function with
the clamp's own gradient instead.
"""

from __future__ import annotations

import torch


def _dims(shape, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(list(shape), dtype=dtype, device=device)


def _gather(vol: torch.Tensor, ix, iy, iz) -> torch.Tensor:
    """Flat gather over the (X, Y, Z) volume."""
    X, Y, Z = vol.shape
    idx = (ix * Y + iy) * Z + iz
    return torch.take(vol, idx)


def _corner_setup(vol_shape, pts: torch.Tensor):
    """Base corner indices (..., 3) and in-cell fractions (..., 3)."""
    q = torch.minimum(torch.clamp(pts, min=0.0),
                      _dims(vol_shape, pts.device, pts.dtype) - 1.001)
    i0 = torch.floor(q).long()
    return i0, q - i0.to(q.dtype)


def trilinear_sample_base(vol: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """vol (X,Y,Z), pts (..., 3) in index space -> (...) samples."""
    i0, f = _corner_setup(vol.shape, pts)
    ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c000 = _gather(vol, ix, iy, iz)
    c100 = _gather(vol, ix + 1, iy, iz)
    c010 = _gather(vol, ix, iy + 1, iz)
    c110 = _gather(vol, ix + 1, iy + 1, iz)
    c001 = _gather(vol, ix, iy, iz + 1)
    c101 = _gather(vol, ix + 1, iy, iz + 1)
    c011 = _gather(vol, ix, iy + 1, iz + 1)
    c111 = _gather(vol, ix + 1, iy + 1, iz + 1)
    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz


def nearest_sample(vol: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor gather (labels); vol (X,Y,Z) any dtype."""
    q = torch.minimum(torch.clamp(pts, min=0.0),
                      _dims(vol.shape, vol.device) - 1.0)
    q = torch.round(q).long()
    return _gather(vol, q[..., 0], q[..., 1], q[..., 2])


class _TrilinearSample(torch.autograd.Function):
    """``trilinear_sample_base`` with the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, vol, pts):
        ctx.save_for_backward(vol, pts)
        return trilinear_sample_base(vol, pts)

    @staticmethod
    def backward(ctx, g):
        vol, pts = ctx.saved_tensors
        i0, f = _corner_setup(vol.shape, pts)
        ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]
        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
        X, Y, Z = vol.shape
        d_vol = d_pts = None
        if ctx.needs_input_grad[0]:
            # Scatter-add trilinear weights * g onto the flat grid.
            gg = g.reshape(-1).to(vol.dtype)
            ixf, iyf, izf = ix.reshape(-1), iy.reshape(-1), iz.reshape(-1)
            fxf, fyf, fzf = fx.reshape(-1), fy.reshape(-1), fz.reshape(-1)
            flat = torch.zeros(X * Y * Z, dtype=vol.dtype, device=vol.device)
            for dx in (0, 1):
                wx = fxf if dx else 1 - fxf
                for dy in (0, 1):
                    wy = fyf if dy else 1 - fyf
                    for dz in (0, 1):
                        wz = fzf if dz else 1 - fzf
                        idx = ((ixf + dx) * Y + (iyf + dy)) * Z + (izf + dz)
                        flat.index_add_(0, idx, (gg * (wx * wy * wz))
                                        .to(vol.dtype))
            d_vol = flat.reshape(X, Y, Z)
        if ctx.needs_input_grad[1]:
            def corner(dx, dy, dz):
                return _gather(vol, ix + dx, iy + dy, iz + dz)

            c000, c100 = corner(0, 0, 0), corner(1, 0, 0)
            c010, c110 = corner(0, 1, 0), corner(1, 1, 0)
            c001, c101 = corner(0, 0, 1), corner(1, 0, 1)
            c011, c111 = corner(0, 1, 1), corner(1, 1, 1)
            dx_ = ((c100 - c000) * (1 - fy) * (1 - fz)
                   + (c110 - c010) * fy * (1 - fz)
                   + (c101 - c001) * (1 - fy) * fz + (c111 - c011) * fy * fz)
            dy_ = ((c010 - c000) * (1 - fx) * (1 - fz)
                   + (c110 - c100) * fx * (1 - fz)
                   + (c011 - c001) * (1 - fx) * fz + (c111 - c101) * fx * fz)
            dz_ = ((c001 - c000) * (1 - fx) * (1 - fy)
                   + (c101 - c100) * fx * (1 - fy)
                   + (c011 - c010) * (1 - fx) * fy + (c111 - c110) * fx * fy)
            # Clamped points have zero positional gradient.
            dims = _dims(vol.shape, pts.device, pts.dtype)
            inside = ((pts > 0.0) & (pts < dims - 1.001)).to(g.dtype)
            d_pts = torch.stack([dx_, dy_, dz_], dim=-1) * g[..., None] \
                * inside
        return d_vol, d_pts


def trilinear_sample(vol: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Differentiable ``trilinear_sample_base``: vol (X,Y,Z), pts (..., 3)
    -> (...), with the grid and position gradients of the JAX package's
    custom VJP (``ops/trilinear.py:63-121``)."""
    return _TrilinearSample.apply(vol, pts)


def trilinear_sample_multi(vols: torch.Tensor, pts: torch.Tensor
                           ) -> torch.Tensor:
    """vols (C,X,Y,Z), pts (...,3) -> (..., C)."""
    return torch.stack([trilinear_sample_base(v, pts) for v in vols], dim=-1)
