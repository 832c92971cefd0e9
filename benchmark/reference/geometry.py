"""Render parameters, content crop and sweep geometry of the reference.

Frozen copies, in plain PyTorch, of ``render/params.default_render_params``,
``render/brats.BratsRenderer``'s occupancy crop (``_refresh_bbox``,
``_crop16``, ``_geometry``) and the geometry of ``ops/shearwarp``
(``sweep_geometry``, ``content_geometry``, ``sweep_plane_affines``,
``_batched_hat`` and the entry correction). The float32 operations are the
port's, in the port's order, so that on one device both sides place every
plane and tap alike.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

_EPS = 1e-6
_F32 = torch.float32
ORDER = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}


class Params(NamedTuple):
    """The frame's render parameters, float32 tensors on one device."""

    vol_min: torch.Tensor  # (3,)
    voxel_size: torch.Tensor  # (3,)
    near: torch.Tensor
    far: torch.Tensor
    bg_color: torch.Tensor  # (3,)
    vol_enabled: torch.Tensor  # (4,)
    vol_weight: torch.Tensor  # (4,)
    ww: torch.Tensor
    wl: torch.Tensor
    intensity_alpha: torch.Tensor
    gamma: torch.Tensor
    show_seg: torch.Tensor
    show_pred: torch.Tensor
    lut: torch.Tensor  # (8, 4)


def make_params(dims: Sequence[int], render: dict, device) -> Params:
    """The box centred on the origin, ``world_extent`` along its largest
    axis, and the transfer function of ``render`` (a configuration's
    ``render`` block)."""
    dims_f = np.asarray(dims, np.float32)
    zooms = np.asarray(render.get("voxel_mm", (1.0, 1.0, 1.0)), np.float32)
    scale = render["world_extent"] / float(dims_f.max())
    voxel = (zooms * scale).astype(np.float32)
    vol_min = (-0.5 * voxel * dims_f).astype(np.float32)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Params(
        vol_min=f32(vol_min), voxel_size=f32(voxel), near=f32(render["near"]),
        far=f32(render["far"]), bg_color=f32(render["bg_color"]),
        vol_enabled=f32(render["vol_enabled"]),
        vol_weight=f32(render["vol_weight"]), ww=f32(render["ww"]),
        wl=f32(render["wl"]), intensity_alpha=f32(render["intensity_alpha"]),
        gamma=f32(render["gamma"]),
        show_seg=f32(1.0 if render["show_seg"] else 0.0),
        show_pred=f32(1.0 if render["show_pred"] else 0.0),
        lut=f32(render["lut"]))


# ------------------------------------------------------------ content crop
def crop16(lo: int, hi: int, n: int, guard: int = 4) -> Tuple[int, int]:
    """A crop range padded to 16 slices with ``guard`` zero slices kept on
    both sides (clamped at the volume edge)."""
    return (max(0, lo - guard) // 16) * 16, \
        min(n, -(-(hi + guard) // 16) * 16)


def content_box(mods: torch.Tensor, seg) -> list:
    """Per volume axis (x, y, z) the crop of the occupied box (any
    modality or label nonzero), padded by ``crop16``."""
    occ = torch.any(mods != 0.0, dim=0)
    if seg is not None:
        occ |= seg != 0
    occ = occ.cpu().numpy()
    box = []
    for ax in range(3):
        proj = np.any(occ, axis=tuple(a for a in range(3) if a != ax))
        nz = np.nonzero(proj)[0]
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) \
            else (0, int(proj.shape[0]))
        box.append(crop16(lo, hi, int(occ.shape[ax])))
    return box


def dominant_axis(forward: np.ndarray) -> int:
    return int(np.argmax(np.abs(np.asarray(forward))))


def crop_out_res(base_res: int, crops, dims_perm) -> Tuple[int, bool]:
    """The intermediate resolution: the in-plane content fraction of
    ``base_res``, rounded up to 128 with a 128 floor, when cropped."""
    (_, _), (a_lo, a_hi), (b_lo, b_hi) = crops
    _, na_g, nb_g = dims_perm
    cropped = (a_lo, a_hi, b_lo, b_hi) != (0, na_g, 0, nb_g)
    if not cropped:
        return base_res, False
    frac = max((a_hi - a_lo) / na_g, (b_hi - b_lo) / nb_g)
    return min(base_res, max(128, -(-int(base_res * frac) // 128) * 128)), \
        True


class Frame(NamedTuple):
    """The frame's sweep: axis, crops along (k, a, b), resolution."""

    axis: int
    dims_perm: Tuple[int, int, int]
    crops: Tuple[Tuple[int, int], ...]
    out_res: int
    inplane_cropped: bool


def frame_sweep(forward, dims, box, p: Params, base_res: int) -> Frame:
    axis = dominant_axis(forward)
    order = ORDER[axis]
    dims_perm = tuple(int(dims[o]) for o in order)
    if float(p.wl) >= 0.5 * float(p.ww):
        crops = tuple(box[o] for o in order)
    else:
        crops = tuple((0, n) for n in dims_perm)
    out_res, cropped = crop_out_res(base_res, crops, dims_perm)
    return Frame(axis, dims_perm, crops, out_res, cropped)


# ------------------------------------------------------------- geometry
class Geom(NamedTuple):
    w_base: torch.Tensor
    e: torch.Tensor  # (3,) eye, permuted to (k, a, b)
    a0: torch.Tensor
    b0: torch.Tensor
    da: torch.Tensor
    db: torch.Tensor
    flip: torch.Tensor
    vmag: torch.Tensor  # (O, O)
    dt_map: torch.Tensor  # (O, O)
    a_off: torch.Tensor
    b_off: torch.Tensor
    na_g: torch.Tensor
    nb_g: torch.Tensor
    t_entry: torch.Tensor  # (O, O)


def permute3(v: torch.Tensor, axis: int) -> torch.Tensor:
    o = ORDER[axis]
    return torch.stack([v[o[0]], v[o[1]], v[o[2]]])


def where(cond, a, b):
    ref = b if isinstance(b, torch.Tensor) else a
    a = torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
    b = torch.as_tensor(b, dtype=ref.dtype, device=ref.device)
    return torch.where(cond, a, b)


def sweep_geometry(cam, p: Params, dims_perm, axis: int, out_res: int,
                   content_lo, content_hi, frustum_wh) -> Geom:
    """``cam``: (eye, right, up, forward, fov_y) tensors on the device."""
    eye, right, up, forward, fov_y = cam
    dev = eye.device
    Nk, Na, Nb = dims_perm
    bmin = permute3(p.vol_min, axis)
    vox = permute3(p.voxel_size, axis)
    e = permute3(eye, axis)
    dimsf = torch.tensor([Nk, Na, Nb], dtype=_F32, device=dev)
    c_lo = torch.as_tensor(content_lo, dtype=_F32, device=dev)
    c_hi = torch.as_tensor(content_hi, dtype=_F32, device=dev)

    w_lo = bmin[0] + vox[0] * c_lo[0]
    w_hi = bmin[0] + vox[0] * c_hi[0]
    use_hi = torch.abs(w_hi - e[0]) > torch.abs(w_lo - e[0])
    w_base = torch.where(use_hi, w_hi, w_lo)

    ca = bmin[1] + vox[1] * torch.stack([c_lo[1], c_hi[1]])
    cb = bmin[2] + vox[2] * torch.stack([c_lo[2], c_hi[2]])
    ck = torch.stack([w_lo, w_hi])
    K, A, B = torch.meshgrid(ck, ca, cb, indexing="ij")
    denom = K.reshape(-1) - e[0]
    denom = where(torch.abs(denom) < _EPS, _EPS, denom)
    lam = torch.clamp((w_base - e[0]) / denom, 0.0, 64.0)
    proj_a = e[1] + lam * (A.reshape(-1) - e[1])
    proj_b = e[2] + lam * (B.reshape(-1) - e[2])
    size_a = ca[1] - ca[0]
    size_b = cb[1] - cb[0]
    amin = torch.amin(proj_a)
    amax = torch.amax(proj_a)
    bmin2 = torch.amin(proj_b)
    bmax2 = torch.amax(proj_b)
    W, H = frustum_wh
    f = 1.0 / torch.tan(0.5 * fov_y)
    aspect = W / max(1.0, float(H))
    ux = (0.5 / W) * 2.0 - 1.0
    vy = (0.5 / H) * 2.0 - 1.0
    hits_a, hits_b, ts = [], [], []
    for sx in (ux, -ux):
        for sy in (vy, -vy):
            d = (sx * aspect / f) * right + (-sy / f) * up + forward
            dp = permute3(d, axis)
            dk = where(torch.abs(dp[0]) < _EPS, _EPS, dp[0])
            t = (w_base - e[0]) / dk
            ts.append(t)
            hits_a.append(e[1] + t * dp[1])
            hits_b.append(e[2] + t * dp[2])
    ok = torch.amin(torch.stack(ts)) > 0.0
    fa = torch.stack(hits_a)
    fb = torch.stack(hits_b)
    pad_a = 0.01 * (fa.amax() - fa.amin())
    pad_b = 0.01 * (fb.amax() - fb.amin())
    amin = torch.where(ok, torch.maximum(amin, fa.amin() - pad_a), amin)
    amax = torch.where(ok, torch.minimum(amax, fa.amax() + pad_a), amax)
    bmin2 = torch.where(ok, torch.maximum(bmin2, fb.amin() - pad_b), bmin2)
    bmax2 = torch.where(ok, torch.minimum(bmax2, fb.amax() + pad_b), bmax2)
    amin = torch.clamp(amin, ca[0] - 8.0 * size_a, ca[1] + 8.0 * size_a)
    amax = torch.clamp(amax, ca[0] - 8.0 * size_a, ca[1] + 8.0 * size_a)
    bmin2 = torch.clamp(bmin2, cb[0] - 8.0 * size_b, cb[1] + 8.0 * size_b)
    bmax2 = torch.clamp(bmax2, cb[0] - 8.0 * size_b, cb[1] + 8.0 * size_b)
    da = torch.clamp(amax - amin, min=_EPS) / (out_res - 1)
    db = torch.clamp(bmax2 - bmin2, min=_EPS) / (out_res - 1)

    ii = torch.arange(out_res, dtype=_F32, device=dev)
    va = (amin + ii * da) - e[1]
    vb = (bmin2 + ii * db) - e[2]
    vk = w_base - e[0]
    vmag = torch.sqrt(va[:, None] ** 2 + vb[None, :] ** 2 + vk ** 2)
    dt_map = vox[0] * vmag / torch.clamp(torch.abs(vk), min=_EPS)

    d_k = where(torch.abs(vk) < _EPS, _EPS, vk)
    d_a = where(torch.abs(va) < _EPS, _EPS, va)
    d_b = where(torch.abs(vb) < _EPS, _EPS, vb)
    a_lo_w = bmin[1]
    a_hi_w = bmin[1] + vox[1] * dimsf[1]
    b_lo_w = bmin[2]
    b_hi_w = bmin[2] + vox[2] * dimsf[2]
    s_k = torch.minimum((w_lo - e[0]) / d_k, (w_hi - e[0]) / d_k)
    s_a = torch.minimum((a_lo_w - e[1]) / d_a, (a_hi_w - e[1]) / d_a)
    s_b = torch.minimum((b_lo_w - e[2]) / d_b, (b_hi_w - e[2]) / d_b)
    s_in = torch.maximum(s_k, torch.maximum(s_a[:, None], s_b[None, :]))
    t_entry = torch.clamp(s_in, min=0.0) * vmag

    flip = (vox[0] / d_k) < 0.0
    return Geom(w_base=w_base, e=e, a0=amin, b0=bmin2, da=da, db=db,
                flip=flip, vmag=vmag, dt_map=dt_map, a_off=c_lo[1],
                b_off=c_lo[2], na_g=dimsf[1], nb_g=dimsf[2], t_entry=t_entry)


def content_geometry(cam, p: Params, fr: Frame, width: int,
                     height: int) -> Geom:
    """The geometry of the cropped volumes: the crops' content box."""
    (k_lo, k_hi), (a_lo, a_hi), (b_lo, b_hi) = fr.crops
    return sweep_geometry(cam, p, fr.dims_perm, fr.axis, fr.out_res,
                          (float(k_lo), float(a_lo), float(b_lo)),
                          (float(k_hi), float(a_hi), float(b_hi)),
                          (width, height))


def inplane_affine(geom: Geom, in_axis: int, bmin_a, vox_a, w_k):
    e_in = geom.e[1 + in_axis]
    g0 = geom.a0 if in_axis == 0 else geom.b0
    dg = geom.da if in_axis == 0 else geom.db
    off_g = geom.a_off if in_axis == 0 else geom.b_off
    lam = (w_k - geom.e[0]) / (geom.w_base - geom.e[0])
    off = (e_in * (1.0 - lam) + lam * g0 - bmin_a) / vox_a - off_g
    sc = lam * dg / vox_a
    return off, sc, lam


def plane_affines(geom: Geom, p: Params, axis: int, n_planes: int,
                  z_offset: float):
    """Per plane in sweep order: (z local slice, z global, lam, off_a,
    sc_a, off_b, sc_b), each (n_planes,)."""
    dev = geom.e.device
    bmin = permute3(p.vol_min, axis)
    vox = permute3(p.voxel_size, axis)
    m = torch.arange(n_planes, dtype=_F32, device=dev)
    z = torch.where(geom.flip, (n_planes - 1) - m, m)
    z_glob = z + z_offset
    w_k = bmin[0] + z_glob * vox[0]
    off_a, sc_a, lam = inplane_affine(geom, 0, bmin[1], vox[1], w_k)
    off_b, sc_b, _ = inplane_affine(geom, 1, bmin[2], vox[2], w_k)
    return z, z_glob, lam, off_a, sc_a, off_b, sc_b


def crop_bounds(geom: Geom, in_axis: int, n_local: int):
    """(clamp_lo, clamp_hi_hat, clamp_hi_near, mask_lo, mask_hi) in local
    index units along in-plane axis 0 (a) or 1 (b)."""
    off_g = geom.a_off if in_axis == 0 else geom.b_off
    n_g = geom.na_g if in_axis == 0 else geom.nb_g
    n = torch.where(n_g < 0, torch.full_like(n_g, float(n_local)), n_g)
    return (-off_g, n - 1.001 - off_g, n - 1.0 - off_g, -off_g, n - off_g)


def hat_weights(offs, scs, n_in: int, out_res: int, clamp_lo, clamp_hi,
                mask_lo, mask_hi, dtype=_F32):
    """(S, O, N) two-tap hat weights of positions offs[s] + i * scs[s],
    clamped to [clamp_lo, clamp_hi]; a tap outside [0, n_in) gets no
    weight. Also the (S, O) inside mask."""
    i = torch.arange(out_res, dtype=_F32, device=offs.device)
    pos = offs[:, None] + i[None, :] * scs[:, None]
    inside = ((pos >= mask_lo) & (pos <= mask_hi)).to(_F32)
    q = torch.clamp(pos, clamp_lo, clamp_hi)
    base = torch.floor(q)
    frac = q - base
    col = base.long() + 1
    w = torch.zeros(pos.shape + (n_in + 2,), dtype=dtype, device=offs.device)
    w.scatter_(2, torch.clamp(col + 1, 0, n_in + 1)[..., None],
               frac[..., None].to(dtype))
    w.scatter_(2, torch.clamp(col, 0, n_in + 1)[..., None],
               (1.0 - frac)[..., None].to(dtype))
    return w[..., 1:n_in + 1], inside


def entry_ratio_map(geom: Geom, near, dt_plane) -> torch.Tensor:
    t_start = torch.maximum(geom.t_entry, near)
    return where(geom.t_entry < 0.0, 3e38,
                 t_start / torch.clamp(dt_plane, min=_EPS))


def entry_active(g, r):
    return (g >= -1e-3) | (r >= 1e37)


def entry_extension(g):
    return torch.clamp(g, 0.0, 2.0) * (g < 2.0).to(_F32)


def entry_correction(ext, act, started):
    first = act * (1.0 - started)
    scale = 1.0 + ext * first
    return scale, torch.maximum(started, act)


def label_table(lut: torch.Tensor) -> torch.Tensor:
    """The (8, 4) LUT with row 0 transparent."""
    return torch.cat([torch.zeros_like(lut[:1]), lut[1:8]])


def blend(mods: torch.Tensor, enabled, weight) -> torch.Tensor:
    w = enabled * weight
    wsum = torch.sum(w)
    mixed = torch.tensordot(w, mods, dims=([0], [0]))
    return torch.where(wsum > 0.0, mixed / torch.clamp(wsum, min=1e-12),
                       torch.zeros_like(mixed))


def perm_volume(vol: torch.Tensor, axis: int) -> torch.Tensor:
    """(..., X, Y, Z) -> (..., K, A, B), the sweep axis leading."""
    lead = vol.dim() - 3
    o = ORDER[axis]
    return vol.permute(*range(lead), *(lead + i for i in o))


def crop_volume(vol: torch.Tensor, crops) -> torch.Tensor:
    """The crops of the last three dims, made contiguous."""
    for dim, (lo, hi) in enumerate(crops):
        vol = vol.narrow(vol.dim() - 3 + dim, lo, hi - lo)
    return vol.contiguous()
