"""Stage 1, the compositor and the warp of the reference frame.

Frozen copies, in plain PyTorch, of ``ops/composite.stage1``,
``nearest_rows`` and ``composite_planes_plain`` (kernel K1's plain
version, with K1b's field overlay) and of ``ops/warp.warp_screen_plain``
(kernel K2's), computed in the precision ``Precision`` names: at ``STATED``
the float32 and bf16 arithmetic of the port's plain versions.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from benchmark.reference import geometry as g

_F32 = torch.float32
_BF16 = torch.bfloat16
_FP8 = torch.float8_e4m3fn
_FP8_MAX = 448.0


class Precision(NamedTuple):
    """The type each part of the frame computes in."""

    resample: torch.dtype  # stage 1's operands (the volume and hat weights)
    composite: torch.dtype  # the compositor's and the warp's arithmetic
    mlp: torch.dtype  # the INR's operands (its coordinate part one above)


STATED = Precision(_BF16, _F32, _BF16)
# One step below what the configurations state, one part at a time.
CONTROLS = {
    "resample_fp8": STATED._replace(resample=_FP8),
    "composite_bf16": STATED._replace(composite=_BF16),
    "mlp_fp8": STATED._replace(mlp=_FP8),
}


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held in float32. fp8 is scaled per
    tensor to its largest value, as an fp8 product is."""
    if dtype == _F32:
        return x.to(_F32)
    if dtype == _FP8:
        amax = float(x.abs().max())
        if amax == 0.0 or not math.isfinite(amax):
            return x.to(_F32)
        s = _FP8_MAX / amax
        return (x * s).to(_FP8).to(_F32) / s
    return x.to(dtype).to(_F32)


class Stage1(NamedTuple):
    t1b: torch.Tensor  # (K, Na, O) bf16
    seg_rows: Optional[torch.Tensor]  # (K, Na, O) uint8
    pp: torch.Tensor  # (K, 7)
    scalars: dict
    lut: torch.Tensor
    vmag: torch.Tensor
    dt_map: torch.Tensor
    r_map: torch.Tensor


def nearest_rows(vol_s, zi, off_b, sc_b, out_res: int, clamp_lo, clamp_hi):
    Nb = vol_s.shape[2]
    o = torch.arange(out_res, dtype=_F32, device=vol_s.device)
    pos = off_b[:, None] + o[None, :] * sc_b[:, None]
    q = torch.round(torch.clamp(pos, clamp_lo, clamp_hi)).long()
    inb = (q >= 0) & (q < Nb)
    lab = vol_s.index_select(0, zi)
    lab = torch.where((lab > 0) & (lab < 8), lab, 0).to(torch.uint8)
    K, Na = lab.shape[:2]
    picked = torch.gather(lab, 2, torch.where(inb, q, 0)[:, None, :]
                          .expand(K, Na, out_res))
    return picked * inb[:, None, :].to(torch.uint8)


def stage1(mixed_s, seg_s, geom: g.Geom, p: g.Params, fr: g.Frame,
           prec: Precision) -> Stage1:
    Nk, Na, Nb = mixed_s.shape
    n_planes = Nk + 1
    out_res = fr.out_res
    k_lo = fr.crops[0][0]
    z, z_glob, lam, off_a, sc_a, off_b, sc_b = g.plane_affines(
        geom, p, fr.axis, n_planes, float(k_lo))
    acl, ach, acn, aml, amh = g.crop_bounds(geom, 0, Na)
    bcl, bch, bcn, bml, bmh = g.crop_bounds(geom, 1, Nb)
    nk_g = fr.dims_perm[0]
    own = ((z < Nk - 1e-6) | (z_glob >= nk_g - 1e-6)).to(_F32)
    vox_k = g.permute3(p.voxel_size, fr.axis)[0]
    qfac = torch.abs(geom.w_base - geom.e[0]) / torch.clamp(vox_k, min=1e-6)
    pp = torch.stack([off_a, sc_a, off_b, sc_b, lam, own, lam * qfac],
                     dim=-1)
    near = torch.clamp(p.near, min=0.0)
    r_map = g.entry_ratio_map(geom, near, geom.dt_map)

    # The b-axis half of the separable resample: operands rounded to the
    # resample type, products summed in float32, rows stored in bf16.
    zi = torch.clamp(z, 0.0, Nk - 1).long()
    slices = rounded(mixed_s.index_select(0, zi), prec.resample)
    Wb, _ = g.hat_weights(off_b, sc_b, Nb, out_res, bcl, bch, bml, bmh)
    Wb = rounded(Wb.to(_BF16), prec.resample)
    t1b = torch.bmm(slices, Wb.transpose(1, 2)).to(_BF16)
    del slices, Wb
    seg_rows = None if seg_s is None else \
        nearest_rows(seg_s, zi, off_b, sc_b, out_res, bcl, bcn)
    far = g.where(p.far > 0.0, p.far, 3e38)
    scalars = dict(ww=p.ww, wl=p.wl, gamma=p.gamma, ia=p.intensity_alpha,
                   near=near, far=far, show_seg=(p.show_seg > 0).to(_F32),
                   show_pred=(p.show_pred > 0).to(_F32), bml=bml, bmh=bmh,
                   acl=acl, ach=ach, acn=acn, aml=aml, amh=amh)
    return Stage1(t1b, seg_rows, pp, scalars, p.lut.to(_F32), geom.vmag,
                  geom.dt_map, r_map)


class Composited(NamedTuple):
    C: torch.Tensor  # (O, O, 3) float32
    T: torch.Tensor  # (O, O)
    planes: torch.Tensor  # (O, O) int32: the planes each pixel composited
    n_labeled: torch.Tensor  # (2,) overlay taps with a shown label, seg, pred


def composite(s1: Stage1, use_gamma: bool, use_clip: bool, prec: Precision,
              field=None, field_stride: int = 1,
              field_kstride: int = 1) -> Composited:
    """Front-to-back compositing of every plane, K1's plain version; with
    ``field`` its labels overlay each plane (K1b)."""
    t1b = s1.t1b
    K, Na, O = t1b.shape
    dev = t1b.device
    cd = prec.composite
    sc = {k: v.to(cd) for k, v in s1.scalars.items()}
    lo = sc["wl"] - 0.5 * sc["ww"]
    inv_ww = 1.0 / sc["ww"]
    lab_lut = g.label_table(s1.lut).to(cd)
    fi = torch.arange(O, dtype=_F32, device=dev)[:, None]
    fj = torch.arange(O, dtype=_F32, device=dev)[None, :]
    zeros = torch.zeros((O, O), dtype=cd, device=dev)
    cg, lr, lgr, lb = zeros, zeros.clone(), zeros.clone(), zeros.clone()
    T = torch.ones((O, O), dtype=cd, device=dev)
    started = torch.zeros((O, O), dtype=_F32, device=dev)
    planes = torch.zeros((O, O), dtype=torch.int32, device=dev)
    n_labeled = torch.zeros(2, dtype=torch.int64, device=dev)
    vmag = s1.vmag
    dt_map = s1.dt_map.to(cd)
    r_map = s1.r_map
    f32s = s1.scalars

    def rows(src, m, a):
        inb = (a >= 0) & (a < Na)
        picked = src[m].index_select(0, torch.clamp(a, 0, Na - 1).reshape(-1))
        return torch.where(inb, picked.to(cd), 0.0)

    if field is not None:
        fsel = torch.arange(O, device=dev) // field_stride

    def overlay(lab, T, act, dt_e, rate, show):
        lab = lab.long()
        rgba = lab_lut[torch.where(lab < 8, lab, 0)]
        aS = (1.0 - torch.exp(-rgba[..., 3] * dt_e * rate)) * act * show
        w = aS * T
        n = ((lab > 0) & (lab < 8) & (act > 0) & (show > 0)).sum()
        return (w * rgba[..., 0], w * rgba[..., 1], w * rgba[..., 2],
                T * (1.0 - aS), n)

    for m in range(K):
        off_a, sc_a, off_b, sc_b, lam, own, q_m = s1.pp[m].unbind()
        pos_a = off_a + fi * sc_a
        pos_b = off_b + fj * sc_b
        act = (pos_a >= f32s["aml"]) & (pos_a <= f32s["amh"]) \
            & (pos_b >= f32s["bml"]) & (pos_b <= f32s["bmh"]) \
            & (own > 0.0) & (T > 0.01)
        if use_clip:
            t_k = lam * vmag
            act = act & (t_k >= f32s["near"]) & (t_k <= f32s["far"])
        else:
            act = act & (lam >= 0.0)
        gq = q_m - r_map
        act = act & g.entry_active(gq, r_map)
        planes += act
        actf = act.to(_F32)
        scale, started = g.entry_correction(g.entry_extension(gq), actf,
                                            started)
        actc = actf.to(cd)
        dt_e = dt_map * scale.to(cd)

        qa = torch.clamp(pos_a, f32s["acl"], f32s["ach"])
        a0 = torch.floor(qa)
        fa = (qa - a0).to(cd)
        a0 = a0.long()
        v = (1.0 - fa) * rows(t1b, m, a0) + fa * rows(t1b, m, a0 + 1)
        val = torch.clamp((v - lo) * inv_ww, 0.0, 1.0)
        if use_gamma:
            val = torch.pow(val, sc["gamma"])
        aI = (1.0 - torch.exp(-val * sc["ia"] * dt_e)) * actc
        cg = cg + aI * T * val
        T = T * (1.0 - aI)

        labs = []
        if s1.seg_rows is not None:
            an = torch.round(torch.clamp(pos_a, f32s["acl"], f32s["acn"]))
            labs.append((0, rows(s1.seg_rows, m, an.long()),
                         1.0, sc["show_seg"]))
        if field is not None:
            fm = field[m // field_kstride]
            labs.append((1, fm.index_select(0, fsel).index_select(1, fsel),
                         1.5, sc["show_pred"]))
        for src, lab, rate, show in labs:
            r, g_, b, T, n = overlay(lab, T, actc, dt_e, rate, show)
            lr, lgr, lb = lr + r, lgr + g_, lb + b
            n_labeled[src] += n
    C = torch.stack([cg + lr, cg + lgr, cg + lb], dim=-1)
    return Composited(C.to(_F32), T.to(_F32), planes, n_labeled)


def screen_maps(cam, geom: g.Geom, axis: int, O: int, width: int,
                height: int):
    """Per screen pixel the intermediate coordinates (clamped to
    [0, O - 1]) and whether its ray meets the intermediate plane in front
    of the eye inside it."""
    eye, right, up, forward, fov_y = cam
    dev = eye.device
    f = 1.0 / torch.tan(0.5 * fov_y)
    aspect = width / max(1.0, float(height))
    xs = (torch.arange(width, dtype=_F32, device=dev) + 0.5) / width * 2.0 \
        - 1.0
    ys = (torch.arange(height, dtype=_F32, device=dev) + 0.5) / height \
        * 2.0 - 1.0
    cx = (xs * aspect / f)[None, :]
    cy = (-ys / f)[:, None]
    R = g.permute3(right, axis)
    U = g.permute3(up, axis)
    F = g.permute3(forward, axis)
    e = geom.e
    dk = cx * R[0] + cy * U[0] + F[0]
    da_ = cx * R[1] + cy * U[1] + F[1]
    db_ = cx * R[2] + cy * U[2] + F[2]
    denom = torch.where(torch.abs(dk) < 1e-6, torch.full_like(dk, 1e-6), dk)
    t_base = (geom.w_base - e[0]) / denom
    hit_a = e[1] + t_base * da_
    hit_b = e[2] + t_base * db_
    i_map = (hit_a - geom.a0) / geom.da
    j_map = (hit_b - geom.b0) / geom.db
    valid = (t_base > 0.0) & (i_map >= 0.0) & (i_map <= O - 1) & \
            (j_map >= 0.0) & (j_map <= O - 1)
    return (torch.clamp(i_map, 0.0, O - 1.0), torch.clamp(j_map, 0.0, O - 1.0),
            valid)


def warp(C, cam, geom: g.Geom, axis: int, width: int, height: int,
         bg, prec: Precision) -> torch.Tensor:
    """The intermediate (O, O, 3) warped to the (height, width, 3) frame,
    bilinearly, K2's plain version."""
    cd = prec.composite
    O = C.shape[0]
    i_map, j_map, valid = screen_maps(cam, geom, axis, O, width, height)
    i0 = torch.clamp(torch.floor(i_map).long(), 0, O - 2)
    j0 = torch.clamp(torch.floor(j_map).long(), 0, O - 2)
    fi = torch.clamp(i_map - i0.to(_F32), 0.0, 1.0)[..., None].to(cd)
    fj = torch.clamp(j_map - j0.to(_F32), 0.0, 1.0)[..., None].to(cd)
    flat = C.to(cd).reshape(O * O, 3)
    base = i0 * O + j0
    out = (flat[base] * ((1 - fi) * (1 - fj)) + flat[base + 1] * ((1 - fi) * fj)
           + flat[base + O] * (fi * (1 - fj)) + flat[base + O + 1] * (fi * fj))
    out = torch.where(valid[..., None], out, 0.0)
    return (bg.to(cd) + out).to(_F32)
