"""Sharded rendering over the ``space`` axis of a rank mesh (port of
``parallel/render.py``).

``build_sharded_renderer``: the sweep intermediate is split by columns.
Each rank composites its own stripe with the plain scan (per-ray work
never crosses ranks, so the T <= 0.01 exit stays exact), one
``all_gather`` over the axis assembles the intermediate, and every rank
warps it to the screen (``warp_to_screen``: kernel K2 on the card). The
volume is replicated.

``build_volume_sharded_renderer``: for volumes larger than one device,
each rank holds a slab of the pre-permuted volume along the sweep axis,
composites the planes of its slab ungated, and the slabs fold in sweep
order with the over operator ``(C, T) = (C_a + T_a C_b, T_a T_b)``.

Both render on ``device`` (``cuda`` unless given), one process a device.
"""

from __future__ import annotations

from typing import Optional

import torch

from mri_raytracer_tpu_torch.env import resolve_device
from mri_raytracer_tpu_torch.ops import shearwarp as sw
from mri_raytracer_tpu_torch.parallel.mesh import Mesh
from mri_raytracer_tpu_torch.render.camera import CameraBasis, unpack_basis

_F32 = torch.float32


def _basis(basis, dev) -> CameraBasis:
    """A ``CameraBasis`` on ``dev`` from a basis or its packed vector."""
    if not isinstance(basis, CameraBasis):
        basis = unpack_basis(torch.as_tensor(basis, dtype=_F32))
    return basis.to(dev)


def build_sharded_renderer(mesh: Mesh, vol_dims, width: int, height: int,
                           out_res: Optional[int] = None,
                           has_seg: bool = True, has_pred: bool = False,
                           device=None):
    """Returns ``render(mods, seg, pred, basis, p) -> (H, W, 3)`` with the
    composite split by columns over mesh axis 'space'; the sweep axis is
    chosen on the host per frame (``dominant_axis``). Every rank of the
    axis calls it and gets the whole image."""
    dev = resolve_device(device)
    out_res_ = out_res or max(width, height)
    space = mesh.axis("space")
    # Pad-and-crop for a non-divisible out_res: each rank composites
    # ceil(out_res / n) columns; the padded tail columns (edge-padded maps,
    # values never shown) are cropped after the all_gather, BEFORE the
    # warp. A divisible out_res has pad == 0.
    cols = -(-out_res_ // space.size)
    pad = cols * space.size - out_res_
    j0 = space.index * cols

    def stripe(m: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a per-pixel (O, O) map, edge-padded."""
        if pad:
            m = torch.cat([m, m[:, -1:].expand(-1, pad)], 1)
        return m[:, j0:j0 + cols]

    def render(mods, seg, pred, basis, p):
        basis = _basis(basis, dev)
        axis = sw.dominant_axis(basis)
        p = p.to(dev)
        use_gamma, use_clip = sw.static_flags(p)
        mods = torch.as_tensor(mods, dtype=_F32, device=dev)
        seg = torch.as_tensor(seg, device=dev) if has_seg else None
        pred = torch.as_tensor(pred, device=dev) if has_pred else None
        vols = sw.prepare_sweep_volumes(mods, seg, pred, p, axis)
        geom = sw.content_geometry(basis, p, tuple(vols[0].shape), axis,
                                   out_res_, width, height)
        geom_stripe = geom._replace(b0=geom.b0 + j0 * geom.db,
                                    vmag=stripe(geom.vmag),
                                    dt_map=stripe(geom.dt_map),
                                    t_entry=stripe(geom.t_entry))
        C, _ = sw.sweep_composite(*vols, geom_stripe, p, axis, out_res_, 1,
                                  use_gamma, use_clip, out_cols=cols)
        C_full = torch.cat(space.all_gather(C), 1)[:, :out_res_]
        return sw.warp_to_screen(C_full, geom, basis, axis, width, height,
                                 p.bg_color)

    return render


def build_volume_sharded_renderer(mesh: Mesh, vol_dims, width: int,
                                  height: int, axis: int,
                                  out_res: Optional[int] = None,
                                  has_seg: bool = False, device=None):
    """Renderer for a volume split along the sweep axis ``axis`` over mesh
    axis 'space'. ``vol_dims``: the volume's (X, Y, Z) dims (or its sweep
    depth), which ``axis``'s depth must split evenly over the axis.

    The T <= 0.01 exit needs the upstream transmittance, which another
    rank holds, so slabs composite ungated; the fold equals a one-rank
    ``term_gate=False`` composite to float tolerance (a slab samples its
    last plane at the shader's clamp, K_slab - 1.001, where one rank
    samples that slice exactly). ``axis`` is fixed per
    renderer: callers hold one renderer per sweep axis.

    Returns ``render(mixed_slab, seg_slab, basis, p) -> (H, W, 3)``, where
    ``mixed_slab`` / ``seg_slab`` are this rank's slab of the pre-permuted
    (K, A, B) blended volume and labels (``space_sharded(mesh).local`` of
    the whole ones); every rank of the axis gets the whole image."""
    dev = resolve_device(device)
    out_res_ = out_res or max(width, height)
    space = mesh.axis("space")
    nk = vol_dims[axis] if isinstance(vol_dims, (tuple, list)) else vol_dims
    if nk % space.size:
        raise ValueError(f"sweep depth {nk} does not split over "
                         f"{space.size} ranks of 'space'")
    slab_k = nk // space.size

    def render(mixed_slab, seg_slab, basis, p):
        basis = _basis(basis, dev)
        p = p.to(dev)
        use_gamma, use_clip = sw.static_flags(p)
        mixed_slab = torch.as_tensor(mixed_slab, dtype=_F32, device=dev)
        seg_slab = torch.as_tensor(seg_slab, device=dev) if has_seg \
            else None
        if mixed_slab.shape[0] != slab_k:
            raise ValueError(f"a slab holds {slab_k} slices, got "
                             f"{tuple(mixed_slab.shape)}")
        geom = sw.sweep_geometry(basis, p,
                                 (nk,) + tuple(mixed_slab.shape[1:]), axis,
                                 out_res_, frustum_wh=(width, height))
        C, T = sw.sweep_composite(mixed_slab, seg_slab, None, geom, p, axis,
                                  out_res_, 1, use_gamma, use_clip,
                                  z_offset=space.index * slab_k,
                                  nk_global=nk, term_gate=False)
        # Fold the slabs in sweep order (reversed for a back-to-front eye,
        # chosen on the device: no host sync).
        Cs = torch.stack(space.all_gather(C))
        Ts = torch.stack(space.all_gather(T))
        Cs = torch.where(geom.flip, Cs.flip(0), Cs)
        Ts = torch.where(geom.flip, Ts.flip(0), Ts)
        C_acc, T_acc = Cs[0], Ts[0]
        for i in range(1, space.size):
            C_acc = C_acc + T_acc[..., None] * Cs[i]
            T_acc = T_acc * Ts[i]
        return sw.warp_to_screen(C_acc, geom, basis, axis, width, height,
                                 p.bg_color)

    return render
