"""Stage 1 + kernel K1: fused front-to-back shear-warp compositing.

Port of ``ops/pallas_composite.py:362-589`` (``sweep_composite_pallas``).

Stage 1 (plain PyTorch, per frame): the per-plane geometry table in sweep
order, the b-axis half of the separable resample as one batched bf16
product ``t1b[m] = slice_m @ Wb_m^T`` (K, Na, O), and the seg / baked-pred
nearest rows as an index gather (K, Na, O) uint8 — exact for labels.

K1b, the mode-2 prediction field (``pallas_composite.py:72-89, 124-135,
317-322``): instead of baked-pred rows the pred overlay may come from a
``pred_field`` (ceil(K / Kf), O / S, O / S) uint8 of INR labels at stride
S (``ops/neural_march.predict_field``). Plane m reads field row m // Kf at
(i // S, j // S), at 1.5x opacity under ``show_pred``, gated by the
plane's activity only: the tap depends on the intermediate pixel, not on
the a-row. The Pallas kernel's 128-lane zero padding of the field has no
counterpart here.

K1c, the executed-plane counter (``echo='planes'``,
``pallas_composite.py:111, 328-336, 351-353``): with ``count_planes`` the
kernel also returns an (O, O) int32 map of the planes each pixel
composited (in the content box, owning the plane, past the clip or
``lam >= 0`` test and the pre-entry gate, before the T <= 0.01 exit), and
keeps T. That is the work these inputs need, whatever the compositor's
tiling; the Pallas kernel's per-tile count bounds it from above.
``utils.arith.frame_flops`` turns it into the frame's exact stage-2 FLOPs.

K1 (``csrc/composite.cu``; replaces ``pallas_composite.py::_make_kernel``,
launched at ``pallas_composite.py:575``): a block composites a 16 x 64
tile of the intermediate image over the planes that can touch it (the
Pallas kernel's per-tile culling, mirrored by ``tile_planes_plain``), with
the tile's a-rows of each plane staged in shared memory ahead of use, and
leaves once every ray of the tile has T <= 0.01. Per (pixel, plane) it
finishes the resample as a 2-tap lerp along a, then the transfer function,
masks, entry correction and label LUT overlays, with the running colour
and transmittance in registers. ``composite_planes`` launches it for CUDA
tensors; ``composite_planes_plain`` is the same arithmetic in PyTorch for
CPU tensors (and the reference ``chip_smoke.py`` holds the kernel against).

With supersample == 1 the planes sit at integer slice indices, so the
z-lerp is a no-op. The z = Nk edge plane reads slice Nk-1 exactly, as the
Pallas kernel does (the scan clamps at Nk-1.001 instead).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from mri_raytracer_tpu_torch.ops import kernels, shearwarp as sw
from mri_raytracer_tpu_torch.render.params import BratsRenderParams
from mri_raytracer_tpu_torch.utils import profiling

_F32 = torch.float32
# Columns of the (K, 7) plane table ``pp``: off_a, sc_a, off_b, sc_b, lam,
# own (slab plane ownership), q (plane position in dt units).
# Entries of the (16,) ``scalars``: ww, wl, gamma, intensity_alpha, near,
# far, show_seg, show_pred, mask_b_lo, mask_b_hi, a_clamp_lo, a_clamp_hi,
# a_clamp_hi_n, mask_a_lo, mask_a_hi, unused.

# csrc/composite.cu's tile (rows, columns) and the a-rows a stage of its
# shared-memory ring holds, mirrored for ``tile_planes_plain``; chip_smoke.py
# holds them against the kernel's own (``mrt_composite_info``).
TILE_I, TILE_J, WIN_ROWS = 16, 64, 18
# Its dynamic shared memory: the row ring and header, then per plane its
# table row, window and run-list slot; at most 227 KB a block on sm_90.
_SMEM_RING, _SMEM_PLANE, _SMEM_MAX = 22528 + 144, 44, 232448


class PlainK1(NamedTuple):
    """What the plain version of K1 returns."""

    C: torch.Tensor  # (O, O, 3)
    T: torch.Tensor  # (O, O)
    # (O, O) int32: each pixel's planes that composited, K1c's map.
    planes: torch.Tensor
    # (2,): overlay taps among them with a shown label in [1, 8), seg and
    # pred (rows or field); label 0 is transparent and needs no work.
    n_labeled: torch.Tensor

    @property
    def n_active(self) -> torch.Tensor:
        """The (pixel, plane) pairs that composited."""
        return self.planes.sum()


def composite_planes_plain(t1b, seg_rows, pred_rows, pp, scalars, lut, vmag,
                           dt_map, r_map, use_gamma: bool, use_clip: bool,
                           pred_field=None, field_stride: int = 1,
                           field_kstride: int = 1, on_plane=None) -> PlainK1:
    """Plain PyTorch version of K1 (K1b with ``pred_field``), with K1c's
    executed-plane map always on: it costs one add per plane here.
    ``on_plane(m, act)``, when given, sees each plane's (O, O) bool mask of
    the pixels that composite it (the tests of the tile culling)."""
    K, Na, O = t1b.shape
    dev = t1b.device
    (ww, wl, gamma, ia, near, far, show_seg, show_pred, bml, bmh, acl, ach,
     acn, aml, amh, _) = scalars.unbind()
    lo = wl - 0.5 * ww
    inv_ww = 1.0 / ww
    lab_lut = sw._label_table(lut).to(_F32)
    fi = torch.arange(O, dtype=_F32, device=dev)[:, None]  # rows i
    fj = torch.arange(O, dtype=_F32, device=dev)[None, :]  # columns j
    cg = torch.zeros((O, O), dtype=_F32, device=dev)
    lr, lg, lb = torch.zeros_like(cg), torch.zeros_like(cg), torch.zeros_like(cg)
    T = torch.ones_like(cg)
    started = torch.zeros_like(cg)
    planes = torch.zeros((O, O), dtype=torch.int32, device=dev)
    n_labeled = torch.zeros(2, dtype=torch.int64, device=dev)

    def rows(src, m, a):
        """src[m, a, j] for every (i, j), zero where row a is outside
        [0, Na) — an absent tap is never clamped back into range."""
        inb = (a >= 0) & (a < Na)
        picked = src[m].index_select(0, torch.clamp(a, 0, Na - 1).reshape(-1))
        return torch.where(inb, picked.to(_F32), 0.0)

    if pred_field is not None:
        # Field pixel of each intermediate pixel: (i // S, j // S).
        fsel = torch.arange(O, device=dev) // field_stride

    def overlay(lab, T, act, dt_e, rate, show):
        lab = lab.long()
        rgba = lab_lut[torch.where(lab < 8, lab, 0)]
        a_lab = rgba[..., 3]
        aS = (1.0 - torch.exp(-a_lab * dt_e * rate)) * act * show
        w = aS * T
        n = ((lab > 0) & (lab < 8) & (act > 0) & (show > 0)).sum()
        return (w * rgba[..., 0], w * rgba[..., 1], w * rgba[..., 2],
                T * (1.0 - aS), n)

    for m in range(K):
        off_a, sc_a, off_b, sc_b, lam, own, q_m = pp[m].unbind()
        pos_a = off_a + fi * sc_a  # (O, 1)
        pos_b = off_b + fj * sc_b  # (1, O)
        act = (pos_a >= aml) & (pos_a <= amh) & (pos_b >= bml) \
            & (pos_b <= bmh) & (own > 0.0) & (T > 0.01)
        if use_clip:
            t_k = lam * vmag
            act = act & (t_k >= near) & (t_k <= far)
        else:
            act = act & (lam >= 0.0)
        g = q_m - r_map
        act = act & sw.entry_active(g, r_map)
        if on_plane is not None:
            on_plane(m, act)
        planes += act
        actf = act.to(_F32)
        scale, started = sw.entry_correction(sw.entry_extension(g), actf,
                                              started)
        dt_e = dt_map * scale

        qa = torch.clamp(pos_a, acl, ach)
        a0 = torch.floor(qa)
        fa = qa - a0
        a0 = a0.long()
        v = (1.0 - fa) * rows(t1b, m, a0) + fa * rows(t1b, m, a0 + 1)
        val = torch.clamp((v - lo) * inv_ww, 0.0, 1.0)
        if use_gamma:
            val = torch.pow(val, gamma)
        aI = (1.0 - torch.exp(-val * ia * dt_e)) * actf
        cg = cg + aI * T * val
        T = T * (1.0 - aI)

        if seg_rows is not None or pred_rows is not None:
            an = torch.round(torch.clamp(pos_a, acl, acn)).long()
        labs = []  # (source: 0 seg, 1 pred; labels; opacity rate; show)
        if seg_rows is not None:
            labs.append((0, rows(seg_rows, m, an), 1.0, show_seg))
        if pred_rows is not None:
            labs.append((1, rows(pred_rows, m, an), 1.5, show_pred))
        if pred_field is not None:
            fm = pred_field[m // field_kstride]
            labs.append((1, fm.index_select(0, fsel).index_select(1, fsel),
                         1.5, show_pred))
        for src, lab, rate, show in labs:
            r, g_, b, T, n = overlay(lab, T, actf, dt_e, rate, show)
            lr, lg, lb = lr + r, lg + g_, lb + b
            n_labeled[src] += n
    C = torch.stack([cg + lr, cg + lg, cg + lb], dim=-1)
    return PlainK1(C, T, planes, n_labeled)


def composite_planes(t1b, seg_rows, pred_rows, pp, scalars, lut, vmag,
                     dt_map, r_map, use_gamma: bool, use_clip: bool,
                     pred_field=None, field_stride: int = 1,
                     field_kstride: int = 1, count_planes: bool = False
                     ) -> Tuple[torch.Tensor, ...]:
    """K1 over the stage-1 rows -> (C (O,O,3), T (O,O)), and with
    ``count_planes`` (K1c) -> (C, T, planes (O,O) int32), each pixel's
    count of planes that composited. C and T do not depend on it.

    t1b (K, Na, O) bf16; seg_rows / pred_rows (K, Na, O) uint8 labels in
    [0, 8) or None; pp (K, 7) and scalars (16,) float32 (layouts at the
    top of this module); lut (8, 4); vmag, dt_map, r_map (O, O) float32.
    K1b: ``pred_field`` (ceil(K / field_kstride), O / field_stride,
    O / field_stride) uint8 labels, in place of ``pred_rows``. Launches
    the kernel for CUDA tensors, runs the plain version for CPU tensors.
    K1 has no backward: on the card it refuses inputs that require grad
    while grad is enabled."""
    with profiling.span("k1"):
        if t1b.dim() != 3:
            raise ValueError(f"t1b must be (K, Na, O), got {tuple(t1b.shape)}")
        K, Na, O = t1b.shape
        dev = t1b.device
        checks = [("t1b", t1b, torch.bfloat16, (K, Na, O)),
                  ("pp", pp, _F32, (K, 7)), ("scalars", scalars, _F32, (16,)),
                  ("lut", lut, _F32, (8, 4)), ("vmag", vmag, _F32, (O, O)),
                  ("dt_map", dt_map, _F32, (O, O)),
                  ("r_map", r_map, _F32, (O, O))]
        for name, rows in (("seg_rows", seg_rows), ("pred_rows", pred_rows)):
            if rows is not None:
                checks.append((name, rows, torch.uint8, (K, Na, O)))
        S, Kf = int(field_stride), int(field_kstride)
        Op = 0
        if pred_field is not None:
            if pred_rows is not None:
                raise ValueError("pred_field and pred_rows are exclusive")
            if S < 1 or Kf < 1 or O % S:
                raise ValueError(f"field_stride {S} must divide O = {O} and "
                                 f"field_kstride {Kf} be >= 1")
            Op = O // S
            checks.append(("pred_field", pred_field, torch.uint8,
                           (-(-K // Kf), Op, Op)))
        for name, t, dtype, shape in checks:
            if t.device != dev:
                raise ValueError(f"{name} on {t.device}, t1b on {dev}")
            if t.dtype != dtype:
                raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {shape}, got "
                                 f"{tuple(t.shape)}")
        if dev.type == "cpu":
            out = composite_planes_plain(t1b, seg_rows, pred_rows, pp, scalars,
                                         lut, vmag, dt_map, r_map, use_gamma,
                                         use_clip, pred_field, S, Kf)
            return out[:3] if count_planes else out[:2]
        if dev.type != "cuda":
            raise RuntimeError(f"no compositor for device {dev}")
        kernels.refuse_grad("composite_planes (kernel K1)",
                            *(t for _, t, _, _ in checks))
        for name, t, _, _ in checks:
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if _SMEM_RING + K * _SMEM_PLANE > _SMEM_MAX:
            raise ValueError(f"{K} planes need {_SMEM_RING + K * _SMEM_PLANE} "
                             f"bytes of shared memory, over the {_SMEM_MAX} a "
                             "block may have")

        fn = kernels.function("composite", "mrt_composite", [
            ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lut8 = sw._label_table(lut).to(_F32).contiguous()
        C = torch.empty((O, O, 3), dtype=_F32, device=dev)
        T = torch.empty((O, O), dtype=_F32, device=dev)
        planes = torch.empty((O, O), dtype=torch.int32, device=dev) \
            if count_planes else None
        ptr = lambda t: None if t is None else t.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(t1b.data_ptr(), ptr(seg_rows), ptr(pred_rows),
                     ptr(pred_field), pp.data_ptr(), scalars.data_ptr(),
                     lut8.data_ptr(), vmag.data_ptr(), dt_map.data_ptr(),
                     r_map.data_ptr(), C.data_ptr(), T.data_ptr(), ptr(planes),
                     K, Na, O, S, Kf, Op, int(use_gamma), int(use_clip),
                     stream)
        if err != 0:
            raise RuntimeError("composite kernel launch failed: cudaError "
                               f"{err}")
        composite_planes.launches += 1
        if pred_field is not None:
            composite_planes.field_launches += 1
        if count_planes:
            composite_planes.count_launches += 1
            return C, T, planes
        return C, T


# Launches of the kernel, and of those the ones with a field (K1b) and the
# ones with the executed-plane counter (K1c).
composite_planes.launches = 0
composite_planes.field_launches = 0
composite_planes.count_launches = 0


class TilePlanes(NamedTuple):
    """What ``tile_planes_plain`` returns, for tiles (ti, tj) and planes m."""

    run: torch.Tensor  # (nI, nJ, K) bool: the tile may composite plane m
    # (nI, K) int64: the a-rows the tile's taps and nearest label rows can
    # read, clipped to [0, Na); staged when a_hi - a_lo < WIN_ROWS.
    a_lo: torch.Tensor
    a_hi: torch.Tensor


def tile_planes_plain(pp, scalars, Na: int, O: int, use_clip: bool,
                      has_rows: bool) -> TilePlanes:
    """Plain PyTorch mirror of K1's per-tile plane culling and a-row windows
    (``csrc/composite.cu``), for the tests: a tile of TILE_I x TILE_J
    pixels (clipped to the image) runs plane m when its first and last
    rows' pos_a straddle the a-mask, its first and last columns' pos_b the
    b-mask, own > 0, and lam >= 0 without a clip (``pallas_composite.py:
    205-215``). Positions round as the plain version's do, so a plane a
    tile culls holds none of its pixels that composite."""
    _, _, _, _, _, _, _, _, bml, bmh, acl, ach, acn, aml, amh, _ = \
        scalars.unbind()
    off_a, sc_a, off_b, sc_b, lam, own, _ = pp.unbind(-1)  # (K,)

    def ends(tile):
        first = torch.arange(0, O, tile, device=pp.device)
        last = torch.clamp(first + tile, max=O) - 1
        return first.to(_F32)[:, None], last.to(_F32)[:, None]

    (i0, i1), (j0, j1) = ends(TILE_I), ends(TILE_J)
    pa0, pa1 = off_a + i0 * sc_a, off_a + i1 * sc_a  # (nI, K)
    pb0, pb1 = off_b + j0 * sc_b, off_b + j1 * sc_b  # (nJ, K)
    a_min, a_max = torch.minimum(pa0, pa1), torch.maximum(pa0, pa1)
    a_ok = (a_max >= aml) & (a_min <= amh)
    b_ok = (torch.maximum(pb0, pb1) >= bml) & (torch.minimum(pb0, pb1) <= bmh)
    plane_ok = own > 0.0
    if not use_clip:
        plane_ok = plane_ok & (lam >= 0.0)
    run = a_ok[:, None, :] & b_ok[None, :, :] & plane_ok
    lo = torch.floor(torch.clamp(a_min, acl, ach))
    hi = torch.floor(torch.clamp(a_max, acl, ach)) + 1
    if has_rows:
        lo = torch.minimum(lo, torch.round(torch.clamp(a_min, acl, acn)))
        hi = torch.maximum(hi, torch.round(torch.clamp(a_max, acl, acn)))
    return TilePlanes(run, torch.clamp(lo.long(), min=0),
                      torch.clamp(hi.long(), max=Na - 1))


def nearest_rows(vol_s: torch.Tensor, zi, off_b, sc_b, out_res: int,
                 clamp_lo, clamp_hi) -> torch.Tensor:
    """out[k, n, o] = vol_s[zi[k], n, round(clip(off_b[k] + o*sc_b[k]))]
    as uint8 labels, 0 where that column lies outside [0, Nb) (a cropped
    volume's absent voxel) and for labels outside [1, 8) (transparent)."""
    Nb = vol_s.shape[2]
    o = torch.arange(out_res, dtype=_F32, device=vol_s.device)
    pos = off_b[:, None] + o[None, :] * sc_b[:, None]  # (K, O)
    q = torch.round(torch.clamp(pos, clamp_lo, clamp_hi)).long()
    inb = (q >= 0) & (q < Nb)
    lab = vol_s.index_select(0, zi)  # (K, Na, Nb)
    lab = torch.where((lab > 0) & (lab < 8), lab, 0).to(torch.uint8)
    K, Na = lab.shape[:2]
    picked = torch.gather(lab, 2, torch.where(inb, q, 0)[:, None, :]
                          .expand(K, Na, out_res))
    return picked * inb[:, None, :].to(torch.uint8)


class K1Inputs(NamedTuple):
    """Stage 1's output: the leading arguments of ``composite_planes``."""

    t1b: torch.Tensor  # (K, Na, O) bf16
    seg_rows: Optional[torch.Tensor]  # (K, Na, O) uint8
    pred_rows: Optional[torch.Tensor]  # (K, Na, O) uint8
    pp: torch.Tensor  # (K, 7)
    scalars: torch.Tensor  # (16,)
    lut: torch.Tensor  # (8, 4)
    vmag: torch.Tensor  # (O, O)
    dt_map: torch.Tensor  # (O, O)
    r_map: torch.Tensor  # (O, O)


def stage1(mixed_s: torch.Tensor, seg_s: Optional[torch.Tensor],
           pred_s: Optional[torch.Tensor], geom: sw.SweepGeom,
           p: BratsRenderParams, axis: int, out_res: int, z_offset=None,
           nk_global: Optional[int] = None) -> K1Inputs:
    """Plane table, b-axis bf16 resample and label rows for one frame."""
    with profiling.span("stage1"):
        Nk, Na, Nb = mixed_s.shape
        n_planes = Nk + 1
        nk_g = nk_global if nk_global is not None else Nk

        # ---------------- per-plane geometry in sweep order
        z, z_glob, lam, off_a, sc_a, off_b, sc_b = sw.sweep_plane_affines(
            geom, p, axis, n_planes, z_offset=z_offset)
        acl, ach, acn, aml, amh = sw._geom_bounds(geom, 0, Na)
        bcl, bch, bcn, bml, bmh = sw._geom_bounds(geom, 1, Nb)
        # Plane ownership: a slab owns its closing plane only when it holds
        # the volume end.
        own = ((z < Nk - 1e-6) | (z_glob >= nk_g - 1e-6)).to(_F32)
        # Plane position in per-ray dt units:
        # t_k/dt = lam * |w_base - e_k|/vox_k
        # (vmag cancels, so it is a per-plane scalar).
        vox_k = sw._permute3(p.voxel_size, axis)[0]
        qfac = torch.abs(geom.w_base - geom.e[0]) / torch.clamp(vox_k,
                                                                min=1e-6)
        pp = torch.stack([off_a, sc_a, off_b, sc_b, lam, own, lam * qfac],
                         dim=-1).contiguous()
        near = torch.clamp(p.near, min=0.0)
        r_map = sw.entry_ratio_map(geom, near, geom.dt_map)

        # ---------------- stage 1: b-axis halves, bf16
        zi = torch.clamp(z, 0.0, Nk - 1).long()
        slices = mixed_s.index_select(0, zi).to(torch.bfloat16)  # (K, Na, Nb)
        Wb, _ = sw._batched_hat(off_b, sc_b, Nb, out_res, bcl, bch, bml, bmh,
                                dtype=torch.bfloat16)  # (K, O, Nb)
        t1b = torch.bmm(slices, Wb.transpose(1, 2))  # (K, Na, O) bf16
        seg_rows = None if seg_s is None else \
            nearest_rows(seg_s, zi, off_b, sc_b, out_res, bcl, bcn)
        pred_rows = None if pred_s is None else \
            nearest_rows(pred_s, zi, off_b, sc_b, out_res, bcl, bcn)

        far = sw._where(p.far > 0.0, p.far, 3e38)
        scalars = torch.stack([
            p.ww, p.wl, p.gamma, p.intensity_alpha, near, far,
            (p.show_seg > 0).to(_F32), (p.show_pred > 0).to(_F32),
            bml, bmh, acl, ach, acn, aml, amh,
            torch.zeros_like(p.ww)]).to(_F32)
        return K1Inputs(t1b, seg_rows, pred_rows, pp, scalars, p.lut.to(_F32),
                        geom.vmag.contiguous(), geom.dt_map.contiguous(),
                        r_map.contiguous())


def field_labels(field: torch.Tensor) -> torch.Tensor:
    """Integer labels -> the uint8 field K1b reads; labels outside [1, 8)
    (transparent) become 0, as ``nearest_rows`` stores them."""
    return torch.where((field > 0) & (field < 8), field, 0).to(torch.uint8)


def sweep_composite_fused(mixed_s: torch.Tensor, seg_s: Optional[torch.Tensor],
                          pred_s: Optional[torch.Tensor], geom: sw.SweepGeom,
                          p: BratsRenderParams, axis: int, out_res: int,
                          use_gamma: bool = True, use_clip: bool = True,
                          z_offset=None, nk_global: Optional[int] = None,
                          pred_field: Optional[torch.Tensor] = None,
                          field_stride: int = 1, field_kstride: int = 1,
                          count_planes: bool = False
                          ) -> Tuple[torch.Tensor, ...]:
    """Fused counterpart of ``shearwarp.sweep_composite`` (supersample 1):
    stage 1 then K1. Returns intermediate (O,O,3) emission and (O,O)
    transmittance, and with ``count_planes`` K1c's (O,O) int32
    executed-plane map. Slab mode as in ``sweep_composite``.
    ``pred_field``: integer INR labels (ceil((Nk+1) / field_kstride),
    O / field_stride, O / field_stride) in sweep order, composited by K1b;
    exclusive with ``pred_s``."""
    k1 = stage1(mixed_s, seg_s, pred_s, geom, p, axis, out_res, z_offset,
                nk_global)
    field = None if pred_field is None else field_labels(pred_field)
    return composite_planes(*k1, use_gamma, use_clip, field, field_stride,
                            field_kstride, count_planes)
