"""Volume sampling: trilinear + nearest-neighbor gather.

Port of ``ops/trilinear.py``. Semantics match the reference
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
the clip's own gradient instead. That clip is ``jnp.clip``'s
``min(max(p, 0), dims - 1.001)``: at a tie (a point exactly on the lower
or upper bound) it passes half the position gradient, where
``torch.clamp`` would pass all of it.

The packed, row and mip helpers (``ops/trilinear.py:138-247``) serve the
ROI policy renderer: a corner-packed (X, Y, Z, 8) volume turns a trilinear
sample into one 8-wide row gather, and a multi-channel (X, Y, Z, C) volume
gives C features per row gather.
"""

from __future__ import annotations

import torch


def _dims(shape, device, dtype=torch.float32) -> torch.Tensor:
    """The shape as a tensor on ``device``, written there by fills: a
    ``torch.tensor`` upload from host memory waits for the card's queue,
    a host sync in every sampling call."""
    out = torch.empty(len(shape), dtype=dtype, device=device)
    for i, n in enumerate(shape):
        out[i].fill_(n)
    return out


def _gather(vol: torch.Tensor, ix, iy, iz) -> torch.Tensor:
    """Flat gather over the (X, Y, Z) volume."""
    X, Y, Z = vol.shape
    idx = (ix * Y + iy) * Z + iz
    return torch.take(vol, idx)


def _corner_setup(vol_shape, pts: torch.Tensor):
    """Base corner indices (..., 3) and in-cell fractions (..., 3)."""
    q = torch.minimum(torch.maximum(pts, pts.new_zeros(())),
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
    return _lerp8(c000, c100, c010, c110, c001, c101, c011, c111,
                  fx, fy, fz)


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


def _lerp8(c000, c100, c010, c110, c001, c101, c011, c111, fx, fy, fz):
    """The 8-corner lerp chain of ``trilinear_sample_base``."""
    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0 = c00 + (c10 - c00) * fy
    c1 = c01 + (c11 - c01) * fy
    return c0 + (c1 - c0) * fz


def _rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``flat[idx]``: (N, C), idx (...) -> (..., C). A float32 row of
    C = 4k channels is k complex128 elements, gathered by one element-wise
    ``take``: PyTorch's row gathers (``index_select``, ``gather``,
    advanced indexing) run 16x slower on the card for 32-byte rows
    (``tools/roi_ops_bench.py``: 40.3 against 2.5 ms for a 1080p block of
    66 M rows, NVIDIA H100 80GB HBM3 at 700 W). The bits are the same."""
    C = flat.shape[1]
    if flat.dtype != torch.float32 or C % 4:
        return flat.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (C,))
    k = C // 4
    e = idx.reshape(-1, 1) * k + torch.arange(k, device=idx.device)
    out = flat.contiguous().view(torch.complex128).reshape(-1).take(e)
    return torch.view_as_real(out).view(torch.float32).reshape(
        idx.shape + (C,))


def pack_trilinear_corners(vol: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z) -> (X, Y, Z, 8) corner-row volume for
    ``trilinear_sample_packed``: channel c = vol[x+dx, y+dy, z+dz] with
    edge-clamped padding, corner order (dx, dy, dz) =
    (0,0,0),(1,0,0),(0,1,0),(1,1,0),(0,0,1),(1,0,1),(0,1,1),(1,1,1).
    8x the memory buys one wide row gather per trilinear sample instead of
    8 scalar gathers."""
    X, Y, Z = vol.shape
    p = torch.cat([vol, vol[-1:]], 0)
    p = torch.cat([p, p[:, -1:]], 1)
    p = torch.cat([p, p[:, :, -1:]], 2)
    return torch.stack([p[dx:dx + X, dy:dy + Y, dz:dz + Z]
                        for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)],
                       dim=-1)


def trilinear_sample_packed(vol_rows8: torch.Tensor, pts: torch.Tensor
                            ) -> torch.Tensor:
    """Trilinear sampling from a ``pack_trilinear_corners`` volume: one
    8-channel row gather per sample, then the lerp chain of
    ``trilinear_sample_base`` (the same arithmetic, gather excepted).
    Differentiable in ``pts`` by autograd (through the fractions)."""
    X, Y, Z, _ = vol_rows8.shape
    i0, f = _corner_setup((X, Y, Z), pts)
    idx = (i0[..., 0] * Y + i0[..., 1]) * Z + i0[..., 2]
    c = _rows(vol_rows8.reshape(-1, 8), idx)
    return _lerp8(*c.unbind(-1), f[..., 0], f[..., 1], f[..., 2])


def trilinear_sample_rows(vol_rows: torch.Tensor, pts: torch.Tensor
                          ) -> torch.Tensor:
    """Multi-channel trilinear gather: vol_rows (X, Y, Z, C), pts (..., 3)
    -> (..., C), one row gather per corner."""
    X, Y, Z, C = vol_rows.shape
    i0, f = _corner_setup((X, Y, Z), pts)
    ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]
    flat = vol_rows.reshape(-1, C)

    def rows(ax, ay, az):
        return _rows(flat, (ax * Y + ay) * Z + az)

    return _lerp8(rows(ix, iy, iz), rows(ix + 1, iy, iz),
                  rows(ix, iy + 1, iz), rows(ix + 1, iy + 1, iz),
                  rows(ix, iy, iz + 1), rows(ix + 1, iy, iz + 1),
                  rows(ix, iy + 1, iz + 1), rows(ix + 1, iy + 1, iz + 1),
                  f[..., 0:1], f[..., 1:2], f[..., 2:3])


def nearest_sample_rows(vol_rows: torch.Tensor, pts: torch.Tensor
                        ) -> torch.Tensor:
    """Nearest-neighbor multi-channel gather: vol_rows (X, Y, Z, C),
    pts (..., 3) -> (..., C), one row gather per sample (round half to
    even, as jnp)."""
    X, Y, Z, C = vol_rows.shape
    q = torch.minimum(torch.clamp(pts, min=0.0),
                      _dims((X, Y, Z), pts.device, pts.dtype) - 1.0)
    q = torch.round(q).long()
    return _rows(vol_rows.reshape(-1, C),
                 (q[..., 0] * Y + q[..., 1]) * Z + q[..., 2])


def mip_downsample2(vol: torch.Tensor) -> torch.Tensor:
    """One mip level: 2x average pool with edge padding to even dims (the
    level-1 volume of the ROI policy's optional LOD output)."""
    X, Y, Z = vol.shape
    p = vol
    if X % 2:
        p = torch.cat([p, p[-1:]], 0)
    if Y % 2:
        p = torch.cat([p, p[:, -1:]], 1)
    if Z % 2:
        p = torch.cat([p, p[:, :, -1:]], 2)
    Xp, Yp, Zp = p.shape
    return p.reshape(Xp // 2, 2, Yp // 2, 2, Zp // 2, 2).mean((1, 3, 5))
