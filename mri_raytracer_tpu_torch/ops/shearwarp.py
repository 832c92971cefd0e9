"""Fast BraTS renderer: perspective shear-warp factorization.

Port of the main-path part of ``ops/shearwarp.py``. The emission-absorption
integral of the oracle (``ops/raymarch.py``) is reformulated so that volume
access is separable 1-D resampling:

  1. Pick the volume axis most aligned with the view direction (host-side).
  2. An "intermediate image" of rays is anchored on the content face
     FARTHEST from the eye (the base plane). For slice plane k, the ray of
     intermediate pixel (i, j) crosses at pos_a(i,k) = off_a(k) + i * sc_a(k)
     — affine in i, independent of j (and symmetrically for j) — so each
     plane's resample is two separable 1-D interpolations.
  3. Front-to-back compositing at intermediate resolution over all planes
     with the shader's math (``inr/viewer/brats_rt.slang:115-165``): either
     ``sweep_composite`` below (plain scan, any device) or
     ``ops.composite.sweep_composite_fused`` (stage 1 + kernel K1).
  4. One 2-D homography warp to screen pixels (``ops.warp``, kernel K2).

The scan is differentiable (hat-matrix resampling is linear in the volume,
the transfer function piecewise smooth), so autograd through
``composite='scan_remat'`` trains against images from this renderer
(reference ``docs/Goals.md:36-39``): each plane is rematerialized in the
backward (``torch.utils.checkpoint``), and the warp is the plain gather
on every device, since K1 and K2 have no backward and refuse inputs that
require grad on the card. Clips on the differentiated path are
``torch.minimum(torch.maximum(x, lo), hi)``: at a tie that splits the
gradient 0.5/0.5 as ``jnp.clip`` does, where ``torch.clamp`` passes all
of it (the value clip ties on every zero-background voxel at the default
window, wl 0.5 / ww 1.0).

Sample positions differ from the uniform-delta-t oracle (plane crossings vs
fixed steps); both discretize the same integral.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from torch.utils.checkpoint import checkpoint

from mri_raytracer_tpu_torch.env import resolve_device
from mri_raytracer_tpu_torch.ops import warp
from mri_raytracer_tpu_torch.ops.raymarch import blend_modalities
from mri_raytracer_tpu_torch.render.camera import CameraBasis
from mri_raytracer_tpu_torch.render.params import BratsRenderParams
from mri_raytracer_tpu_torch.utils import profiling

_EPS = 1e-6
_ORDER = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}
_F32 = torch.float32


# --------------------------------------------------------------------- geometry
class SweepGeom(NamedTuple):
    """Per-frame scalars/maps for one sweep axis (tensors on one device).

    The trailing fields carry the in-plane CONTENT CROP: prepared volumes
    may be sliced to the occupied (a, b) bounding box, with ``a_off``/
    ``b_off`` the global index of the crop's first row/column and
    ``na_g``/``nb_g`` the full (uncropped) in-plane dims.
    """

    w_base: torch.Tensor  # () world coord of the base plane along sweep axis
    e: torch.Tensor  # (3,) eye, permuted to (k, a, b)
    a0: torch.Tensor  # () world a-coord of intermediate pixel (i=0)
    b0: torch.Tensor  # ()
    da: torch.Tensor  # () intermediate pixel pitch in a
    db: torch.Tensor  # ()
    flip: torch.Tensor  # () bool: sweep slices in descending k order
    vmag: torch.Tensor  # (O, O) |base_point - eye| per intermediate pixel
    dt_map: torch.Tensor  # (O, O) per-ray spacing between consecutive planes
    a_off: torch.Tensor  # () global index of cropped volume's a row 0
    b_off: torch.Tensor  # ()
    na_g: torch.Tensor  # () global a dim
    nb_g: torch.Tensor  # ()
    t_entry: torch.Tensor  # (O, O) ray-param of box entry


def _crop_bounds(off_g, n_g, n_local: int):
    """(clamp_lo, clamp_hi_hat, clamp_hi_near, mask_lo, mask_hi) in LOCAL
    index units for a volume cropped at global row ``off_g`` of ``n_g``
    global rows (n_g < 0 means uncropped)."""
    n = torch.where(n_g < 0, torch.full_like(n_g, float(n_local)), n_g)
    return (-off_g, n - 1.001 - off_g, n - 1.0 - off_g, -off_g, n - off_g)


def _permute3(v: torch.Tensor, axis: int) -> torch.Tensor:
    """Reorder an xyz vector so the sweep axis comes first."""
    o = _ORDER[axis]
    return torch.stack([v[o[0]], v[o[1]], v[o[2]]])


def _perm_volume(vol: torch.Tensor, axis: int) -> torch.Tensor:
    """(X,Y,Z) -> (K, A, B) with the sweep axis leading."""
    return vol.permute(*_ORDER[axis])


def _where(cond, a, b):
    """``jnp.where`` for a 0-d/broadcast condition with scalar branches."""
    ref = b if isinstance(b, torch.Tensor) else a
    a = torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
    b = torch.as_tensor(b, dtype=ref.dtype, device=ref.device)
    return torch.where(cond, a, b)


def sweep_geometry(basis: CameraBasis, p: BratsRenderParams,
                   dims_perm: Tuple[int, int, int], axis: int,
                   out_res: int, content_lo=None, content_hi=None,
                   frustum_wh: Optional[Tuple[int, int]] = None) -> SweepGeom:
    """``dims_perm`` are the GLOBAL permuted dims. ``content_lo``/``hi``
    ((3,) index-unit bounds, default the full box) define the content box
    whose eye-projection sets the intermediate extent and base plane.
    ``frustum_wh`` (width, height): bound the intermediate extent by the
    screen frustum's footprint on the base plane as well."""
    dev = basis.eye.device
    Nk, Na, Nb = dims_perm
    bmin = _permute3(p.vol_min, axis)
    vox = _permute3(p.voxel_size, axis)
    e = _permute3(basis.eye, axis)
    dimsf = torch.tensor([Nk, Na, Nb], dtype=_F32, device=dev)
    c_lo = torch.zeros(3, dtype=_F32, device=dev) if content_lo is None \
        else torch.as_tensor(content_lo, dtype=_F32, device=dev)
    c_hi = dimsf if content_hi is None \
        else torch.as_tensor(content_hi, dtype=_F32, device=dev)

    # Base plane: the content k-face farthest from the eye.
    w_lo = bmin[0] + vox[0] * c_lo[0]
    w_hi = bmin[0] + vox[0] * c_hi[0]
    use_hi = torch.abs(w_hi - e[0]) > torch.abs(w_lo - e[0])
    w_base = torch.where(use_hi, w_hi, w_lo)

    # Intermediate extent: projections of the 8 content-box corners from the
    # eye onto the base plane.
    ca = bmin[1] + vox[1] * torch.stack([c_lo[1], c_hi[1]])
    cb = bmin[2] + vox[2] * torch.stack([c_lo[2], c_hi[2]])
    ck = torch.stack([w_lo, w_hi])
    K, A, B = torch.meshgrid(ck, ca, cb, indexing="ij")
    denom = K.reshape(-1) - e[0]
    denom = _where(torch.abs(denom) < _EPS, _EPS, denom)
    lam = torch.clamp((w_base - e[0]) / denom, 0.0, 64.0)
    proj_a = e[1] + lam * (A.reshape(-1) - e[1])
    proj_b = e[2] + lam * (B.reshape(-1) - e[2])
    size_a = ca[1] - ca[0]
    size_b = cb[1] - cb[0]
    amin = torch.amin(proj_a)
    amax = torch.amax(proj_a)
    bmin2 = torch.amin(proj_b)
    bmax2 = torch.amax(proj_b)
    if frustum_wh is not None:
        # Screen footprint on the base plane from the 4 corner-pixel-center
        # rays; valid only when every corner ray crosses the base plane
        # forward (t > 0) — degenerate poses keep the content-only extent.
        W, H = frustum_wh
        f = 1.0 / torch.tan(0.5 * basis.fov_y)
        aspect = W / max(1.0, float(H))
        ux = (0.5 / W) * 2.0 - 1.0  # outermost pixel-center NDC
        vy = (0.5 / H) * 2.0 - 1.0
        hits_a, hits_b, ts = [], [], []
        for sx in (ux, -ux):
            for sy in (vy, -vy):
                d = (sx * aspect / f) * basis.right \
                    + (-sy / f) * basis.up + basis.forward
                dp = _permute3(d, axis)
                dk = _where(torch.abs(dp[0]) < _EPS, _EPS, dp[0])
                t = (w_base - e[0]) / dk
                ts.append(t)
                hits_a.append(e[1] + t * dp[1])
                hits_b.append(e[2] + t * dp[2])
        ok = torch.amin(torch.stack(ts)) > 0.0
        fa = torch.stack(hits_a)
        fb = torch.stack(hits_b)
        # 1% margin: the screen edge rays sit half a pixel beyond the
        # corner centers and the warp's bilinear needs one source pixel.
        pad_a = 0.01 * (fa.amax() - fa.amin())
        pad_b = 0.01 * (fb.amax() - fb.amin())
        amin = torch.where(ok, torch.maximum(amin, fa.amin() - pad_a), amin)
        amax = torch.where(ok, torch.minimum(amax, fa.amax() + pad_a), amax)
        bmin2 = torch.where(ok, torch.maximum(bmin2, fb.amin() - pad_b), bmin2)
        bmax2 = torch.where(ok, torch.minimum(bmax2, fb.amax() + pad_b), bmax2)
    # Wide numeric guard: 8x the content box on either side keeps degenerate
    # poses finite.
    amin = torch.clamp(amin, ca[0] - 8.0 * size_a, ca[1] + 8.0 * size_a)
    amax = torch.clamp(amax, ca[0] - 8.0 * size_a, ca[1] + 8.0 * size_a)
    bmin2 = torch.clamp(bmin2, cb[0] - 8.0 * size_b, cb[1] + 8.0 * size_b)
    bmax2 = torch.clamp(bmax2, cb[0] - 8.0 * size_b, cb[1] + 8.0 * size_b)
    da = torch.clamp(amax - amin, min=_EPS) / (out_res - 1)
    db = torch.clamp(bmax2 - bmin2, min=_EPS) / (out_res - 1)

    ii = torch.arange(out_res, dtype=_F32, device=dev)
    va = (amin + ii * da) - e[1]  # (O,)
    vb = (bmin2 + ii * db) - e[2]
    vk = w_base - e[0]
    vmag = torch.sqrt(va[:, None] ** 2 + vb[None, :] ** 2 + vk ** 2)
    dt_map = vox[0] * vmag / torch.clamp(torch.abs(vk), min=_EPS)

    # Ray parameter (arc length from the eye) of entry into the compositing
    # box: k spans the CONTENT range, (a, b) span the GLOBAL box. The
    # compositors extend the FIRST crossing's dt by the entry->crossing
    # distance so the entry segment's emission is not lost.
    d_k = _where(torch.abs(vk) < _EPS, _EPS, vk)
    d_a = _where(torch.abs(va) < _EPS, _EPS, va)
    d_b = _where(torch.abs(vb) < _EPS, _EPS, vb)
    a_lo_w = bmin[1]
    a_hi_w = bmin[1] + vox[1] * dimsf[1]
    b_lo_w = bmin[2]
    b_hi_w = bmin[2] + vox[2] * dimsf[2]
    s_k = torch.minimum((w_lo - e[0]) / d_k, (w_hi - e[0]) / d_k)  # ()
    s_a = torch.minimum((a_lo_w - e[1]) / d_a, (a_hi_w - e[1]) / d_a)  # (O,)
    s_b = torch.minimum((b_lo_w - e[2]) / d_b, (b_hi_w - e[2]) / d_b)  # (O,)
    s_in = torch.maximum(s_k, torch.maximum(s_a[:, None], s_b[None, :]))
    t_entry = torch.clamp(s_in, min=0.0) * vmag

    flip = (vox[0] / d_k) < 0.0
    return SweepGeom(w_base=w_base, e=e, a0=amin, b0=bmin2, da=da, db=db,
                     flip=flip, vmag=vmag, dt_map=dt_map,
                     a_off=c_lo[1], b_off=c_lo[2],
                     na_g=dimsf[1], nb_g=dimsf[2], t_entry=t_entry)


# ------------------------------------------------------------ weight matrices
def _inplane_affine(geom: SweepGeom, in_axis: int, bmin_a, vox_a, w_k):
    """Scale/offset of the crossing position (LOCAL index units of the
    possibly-cropped volume) along in-plane axis ``in_axis`` (0 = a, 1 = b)
    for the slice plane at world ``w_k``: pos(i) = off + i * sc."""
    e_in = geom.e[1 + in_axis]
    g0 = geom.a0 if in_axis == 0 else geom.b0
    dg = geom.da if in_axis == 0 else geom.db
    off_g = geom.a_off if in_axis == 0 else geom.b_off
    lam = (w_k - geom.e[0]) / (geom.w_base - geom.e[0])
    off = (e_in * (1.0 - lam) + lam * g0 - bmin_a) / vox_a - off_g
    sc = lam * dg / vox_a
    return off, sc, lam


def sweep_plane_affines(geom: SweepGeom, p, axis: int, n_planes: int,
                        z_offset=None):
    """Per-plane sweep affines for ALL ``n_planes`` planes in SWEEP order
    (flip applied): returns (z local slice index, z_glob, lam, off_a, sc_a,
    off_b, sc_b), each (n_planes,)."""
    dev = geom.e.device
    bmin = _permute3(p.vol_min, axis)
    vox = _permute3(p.voxel_size, axis)
    z_off = 0.0 if z_offset is None else float(z_offset)
    m = torch.arange(n_planes, dtype=_F32, device=dev)
    z = torch.where(geom.flip, (n_planes - 1) - m, m)  # local slice index
    z_glob = z + z_off
    w_k = bmin[0] + z_glob * vox[0]
    off_a, sc_a, lam = _inplane_affine(geom, 0, bmin[1], vox[1], w_k)
    off_b, sc_b, _ = _inplane_affine(geom, 1, bmin[2], vox[2], w_k)
    return z, z_glob, lam, off_a, sc_a, off_b, sc_b


def _batched_hat(offs, scs, n_in: int, out_res: int, clamp_lo=0.0,
                 clamp_hi=None, mask_lo=0.0, mask_hi=None, dtype=_F32):
    """(S,O,N) trilinear hat weights + (S,O) inside mask for positions
    pos(s, i) = offs[s] + i*scs[s], clamped to [clamp_lo, clamp_hi] (the
    shader sampler's global-box clamp, default [0, n_in - 1.001]); the mask
    marks pos in [mask_lo, mask_hi]. A tap outside [0, n_in) — a cropped
    volume's absent (= empty) voxel — gets no weight: it is never clamped
    back into range. Built by scattering the two taps into a zero matrix
    with one guard column per side (same values as the dense hat)."""
    clamp_hi = n_in - 1.001 if clamp_hi is None else clamp_hi
    mask_hi = float(n_in) if mask_hi is None else mask_hi
    i = torch.arange(out_res, dtype=_F32, device=offs.device)
    pos = offs[:, None] + i[None, :] * scs[:, None]  # (S, O)
    inside = ((pos >= mask_lo) & (pos <= mask_hi)).to(_F32)
    q = torch.clamp(pos, clamp_lo, clamp_hi)
    base = torch.floor(q)
    frac = q - base
    col = base.long() + 1  # column of tap `base` in the guarded matrix
    w = torch.zeros(pos.shape + (n_in + 2,), dtype=dtype, device=offs.device)
    w.scatter_(2, torch.clamp(col + 1, 0, n_in + 1)[..., None],
               frac[..., None].to(dtype))
    w.scatter_(2, torch.clamp(col, 0, n_in + 1)[..., None],
               (1.0 - frac)[..., None].to(dtype))
    return w[..., 1:n_in + 1], inside


def _batched_nearest(offs, scs, n_in: int, out_res: int, clamp_lo=0.0,
                     clamp_hi=None):
    """(S,O,N) one-hot nearest weights (label channels): round(clamp(pos));
    out-of-crop positions match no row (label 0 = empty, exact)."""
    clamp_hi = float(n_in - 1) if clamp_hi is None else clamp_hi
    i = torch.arange(out_res, dtype=_F32, device=offs.device)
    pos = offs[:, None] + i[None, :] * scs[:, None]
    q = torch.round(torch.clamp(pos, clamp_lo, clamp_hi))
    y = torch.arange(n_in, dtype=_F32, device=offs.device)
    return (y[None, None, :] == q[..., None]).to(_F32)


def hat_matrix(off, sc, n_in: int, out_res: int, clamp_lo=0.0, clamp_hi=None,
               mask_lo=0.0, mask_hi=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, N) trilinear hat weights + (O,) inside-box mask for one plane."""
    off = torch.as_tensor(off, dtype=_F32).reshape(1)
    sc = torch.as_tensor(sc, dtype=_F32, device=off.device).reshape(1)
    w, inside = _batched_hat(off, sc, n_in, out_res, clamp_lo, clamp_hi,
                             mask_lo, mask_hi)
    return w[0], inside[0]


def nearest_matrix(off, sc, n_in: int, out_res: int, clamp_lo=0.0,
                   clamp_hi=None) -> torch.Tensor:
    """(O, N) one-hot nearest weights for one plane."""
    off = torch.as_tensor(off, dtype=_F32).reshape(1)
    sc = torch.as_tensor(sc, dtype=_F32, device=off.device).reshape(1)
    return _batched_nearest(off, sc, n_in, out_res, clamp_lo, clamp_hi)[0]


def entry_ratio_map(geom: SweepGeom, near, dt_plane) -> torch.Tensor:
    """Per-pixel r = max(t_entry, near) / dt: the march start position in
    plane-spacing units. The first crossing at or after the start satisfies
    0 <= q - r < 1 with q = t_k/dt a per-plane scalar; the compositors
    extend that plane's dt by (q - r) * dt. Sentinel t_entry < 0 disables
    (r = 3e38)."""
    t_start = torch.maximum(geom.t_entry, near)
    return _where(geom.t_entry < 0.0, 3e38,
                  t_start / torch.clamp(dt_plane, min=_EPS))


def entry_active(g: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Pre-entry gate: planes before the march start (g < 0) never
    composite; the sentinel r >= 1e37 passes everything. The -1e-3
    tolerance keeps rays that enter through a k-face exactly at g = 0 from
    losing their first plane to fp rounding."""
    return (g >= -1e-3) | (r >= 1e37)


def entry_extension(g):
    """The entry->crossing distance g = q - r by which a ray's FIRST active
    plane extends its dt, clipped to [0, 2] (g >= 2: no correction)."""
    return torch.clamp(g, 0.0, 2.0) * (g < 2.0).to(_F32)


def entry_correction(ext, act, started):
    """First-active-plane dt scale + updated per-ray 'started' mask: the
    FIRST active plane along each ray extends its dt by ``ext``
    (``entry_extension``)."""
    first = act * (1.0 - started)
    scale = 1.0 + ext * first
    return scale, torch.maximum(started, act)


def _geom_bounds(geom: SweepGeom, in_axis: int, n_local: int):
    """Weight-builder bounds for in-plane axis 0 (a) or 1 (b)."""
    off_g = geom.a_off if in_axis == 0 else geom.b_off
    n_g = geom.na_g if in_axis == 0 else geom.nb_g
    return _crop_bounds(off_g, n_g, n_local)


def _label_table(lut: torch.Tensor) -> torch.Tensor:
    """(8, 4) LUT with row 0 transparent: the row every label outside
    [1, 8) resolves to."""
    return torch.cat([torch.zeros_like(lut[:1]), lut[1:8]])


def _lut_rgba(lab: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """(O,O) float label (exact small ints) -> (O,O,4); labels outside
    [1,8) resolve to transparent zeros."""
    idx = torch.round(lab).long()
    idx = torch.where((idx > 0) & (idx < 8), idx, torch.zeros_like(idx))
    return _label_table(lut)[idx]


def _nearest_resample(vol_s, zn, Wan, Wbn):
    """One-hot (nearest) separable resample of an integer label slice; exact
    in float32 (each output sums one label)."""
    sl = torch.index_select(vol_s, 0, zn.reshape(1))[0].to(_F32)
    return Wan @ sl @ Wbn.T


# ------------------------------------------------------------------ the sweep
def _composite(C, T, rgb, alpha):
    C = C + (alpha * T)[..., None] * rgb
    T = T * (1.0 - alpha)
    return C, T


def _bf16_dot(a, b):
    """bf16 operands, float32 accumulation (the JAX package's
    ``preferred_element_type=f32`` dot). Its backward rounds the
    cotangent through bf16, as JAX's transpose of a bf16 dot does."""
    return a.to(torch.bfloat16).to(_F32) @ b.to(torch.bfloat16).to(_F32)


def sweep_composite(mixed_s: torch.Tensor, seg_s: Optional[torch.Tensor],
                    pred_s: Optional[torch.Tensor], geom: SweepGeom,
                    p: BratsRenderParams, axis: int, out_res: int,
                    supersample: int = 1, use_gamma: bool = True,
                    use_clip: bool = True,
                    out_cols: Optional[int] = None, z_offset=None,
                    nk_global: Optional[int] = None,
                    term_gate: bool = True,
                    pred_field: Optional[torch.Tensor] = None,
                    field_stride: int = 1, field_kstride: int = 1,
                    remat: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain scan over slice planes; returns intermediate (O,O,3) emission
    and (O,O) transmittance. Volumes are pre-permuted to (K, A, B).

    ``remat=True`` runs each plane's body under ``torch.utils.checkpoint``
    (non-reentrant) with the carry (C, T, started) as its inputs: the
    backward recomputes a plane's resample instead of storing every
    plane's activations, so backward memory is O(out_res^2) a plane
    whatever the volume depth (the training path; forward-only rendering
    keeps remat=False).

    ``out_cols`` < out_res composites a column stripe of the intermediate
    (spatial sharding, ``parallel/render.py``): ``geom`` then carries the
    stripe's vmag / dt_map / t_entry columns and a b0 shifted by j0 * db,
    and C, T are (out_res, out_cols).

    Slab mode: ``mixed_s`` holds slices [z_offset, z_offset + K) of an
    ``nk_global``-deep volume; the slab composites its own planes, plus the
    closing plane z = nk_global only when it holds the volume end.
    ``term_gate=False`` drops the T <= 0.01 early exit, so that slabs
    composited apart fold exactly (the gate needs the upstream
    transmittance, which another rank holds).

    ``pred_field``: the neural march's mode-2 overlay in place of
    ``pred_s`` (``neural_march.py:383-395``): integer labels
    (ceil(n_planes / field_kstride), O / field_stride, O / field_stride)
    in sweep order; plane m reads row m // field_kstride, each label
    nearest-replicated over a field_stride square.
    """
    Nk, Na, Nb = mixed_s.shape
    dev = mixed_s.device
    cols = out_cols or out_res
    if pred_field is not None and cols != out_res:
        raise ValueError("pred_field covers the whole intermediate; it "
                         "takes no out_cols")
    if pred_field is not None:
        n_rows = -(-(Nk * supersample + 1) // field_kstride)
        want = (n_rows, out_res // field_stride, out_res // field_stride)
        if pred_s is not None or out_res % field_stride \
                or tuple(pred_field.shape) != want:
            raise ValueError(f"pred_field must be {want} without pred_s, "
                             f"got {tuple(pred_field.shape)}")
    bmin = _permute3(p.vol_min, axis)
    vox = _permute3(p.voxel_size, axis)
    slab_mode = z_offset is not None
    nk_g = nk_global if nk_global is not None else Nk
    z_off = 0.0 if z_offset is None else float(z_offset)
    # Planes cover the FULL box depth, index z in [0, Nk]; samples in the
    # outer [N-1, N] margin clamp to the edge slice like the shader.
    n_planes = Nk * supersample + 1
    dt = geom.dt_map / supersample

    near_t = torch.clamp(p.near, min=0.0)
    tmax = _where(p.far > 0.0, p.far, 3e38)
    qfac = torch.abs(geom.w_base - geom.e[0]) * supersample \
        / torch.clamp(vox[0], min=_EPS)
    r_map = entry_ratio_map(geom, near_t, dt)
    acl, ach, acn, aml, amh = _geom_bounds(geom, 0, Na)
    bcl, bch, bcn, bml, bmh = _geom_bounds(geom, 1, Nb)
    show_seg = (p.show_seg > 0).to(_F32)
    show_pred = (p.show_pred > 0).to(_F32)

    # Plane indices along the sweep (flip for back-to-front eyes), all at
    # once so the loop below needs no host sync.
    m_all = torch.arange(n_planes, device=dev)
    mm_all = torch.where(geom.flip, n_planes - 1 - m_all, m_all)
    z_all = mm_all.to(_F32) / supersample  # local fractional index
    # Value sampling clamps to [0, Nk - 1.001] (shader clamp); the plane's
    # world position keeps the UNclamped z.
    zq_all = torch.clamp(z_all, 0.0, Nk - 1.001)
    z0_all = torch.floor(zq_all).long()
    fz_all = zq_all - z0_all.to(_F32)
    z1_all = torch.clamp(z0_all + 1, max=Nk - 1)
    zn_all = torch.clamp(torch.round(z_all).long(), 0, Nk - 1)
    w_k_all = bmin[0] + (z_all + z_off) * vox[0]
    off_a_all, sc_a_all, lam_all = _inplane_affine(geom, 0, bmin[1], vox[1],
                                                   w_k_all)
    off_b_all, sc_b_all, _ = _inplane_affine(geom, 1, bmin[2], vox[2],
                                             w_k_all)

    if remat:
        # Training: every plane's weights at once (they do not depend on
        # the volume, so the backward's recomputation of a plane only
        # indexes them), at the cost of holding all of them, which the
        # forward-only path does not pay.
        all_a = _batched_hat(off_a_all, sc_a_all, Na, out_res, acl, ach, aml,
                             amh)
        all_b = _batched_hat(off_b_all, sc_b_all, Nb, cols, bcl, bch, bml,
                             bmh)

    def hats(m: int):
        """Plane m's (O, N) hat weights and (O,) in-box masks, a then b."""
        if remat:
            return all_a[0][m], all_a[1][m], all_b[0][m], all_b[1][m]
        return (*hat_matrix(off_a_all[m], sc_a_all[m], Na, out_res, acl, ach,
                            aml, amh),
                *hat_matrix(off_b_all[m], sc_b_all[m], Nb, cols, bcl, bch,
                            bml, bmh))

    v_lo = p.wl - p.ww * 0.5
    zero = torch.zeros((), dtype=_F32, device=dev)
    one = torch.ones((), dtype=_F32, device=dev)

    def gate(m: int, mask_a, mask_b):
        """Plane m's gate apart from the T <= 0.01 exit (in the box, inside
        the clip or in front of the eye, past the march start, owned by
        the slab) and its first-crossing dt extension: neither depends on
        the volume, so the backward of 'remat' does not recompute them."""
        z, lam = z_all[m], lam_all[m]
        inplane = mask_a[:, None] * mask_b[None, :]
        g = lam * qfac - r_map
        if use_clip:
            t_k = lam * geom.vmag
            on = (inplane > 0.0) & (t_k >= near_t) & (t_k <= tmax)
        else:
            # near/far both disabled: behind-eye planes have lam < 0.
            on = (inplane > 0.0) & (lam >= 0.0)
        on = on & entry_active(g, r_map)
        if slab_mode:
            on = on & ((z < Nk - 1e-6) | (z + z_off >= nk_g - 1e-6))
        return on, entry_extension(g)

    def plane(C, T, started, m: int, Wa, Wb, on, ext):
        fz = fz_all[m]

        # z-lerp the two bracketing slices, then separable in-plane resample
        # (bf16 operands, f32 accumulation, as in the JAX package).
        sl = ((1.0 - fz) * torch.index_select(mixed_s, 0, z0_all[m:m + 1])[0]
              + fz * torch.index_select(mixed_s, 0, z1_all[m:m + 1])[0])
        t1 = _bf16_dot(Wa, sl)
        v = _bf16_dot(t1, Wb.T)  # (O, O)

        act = (on & (T > 0.01) if term_gate else on).to(_F32)
        scale, started = entry_correction(ext, act, started)
        dt_e = dt * scale
        # jnp.clip(x, 0, 1) with its 0.5/0.5 gradient at a tie.
        val = torch.minimum(torch.maximum((v - v_lo) / p.ww, zero), one)
        if use_gamma:
            val = torch.pow(val, p.gamma)
        a = (1.0 - torch.exp(-val * p.intensity_alpha * dt_e)) * act
        C, T = _composite(C, T, val[..., None], a)

        if seg_s is not None or pred_s is not None:
            Wan = nearest_matrix(off_a_all[m], sc_a_all[m], Na, out_res, acl,
                                 acn)
            Wbn = nearest_matrix(off_b_all[m], sc_b_all[m], Nb, cols, bcl,
                                 bcn)
            zn = zn_all[m]
        if seg_s is not None:
            rgba = _lut_rgba(_nearest_resample(seg_s, zn, Wan, Wbn), p.lut)
            a = (1.0 - torch.exp(-rgba[..., 3] * dt_e)) * act * show_seg
            C, T = _composite(C, T, rgba[..., :3], a)
        pred = None
        if pred_s is not None:
            pred = _nearest_resample(pred_s, zn, Wan, Wbn)
        elif pred_field is not None:
            pred = pred_field[m // field_kstride].to(_F32)
            if field_stride > 1:
                pred = pred.repeat_interleave(field_stride, 0) \
                    .repeat_interleave(field_stride, 1)
        if pred is not None:
            rgba = _lut_rgba(pred, p.lut)
            a = (1.0 - torch.exp(-rgba[..., 3] * dt_e * 1.5)) * act \
                * show_pred
            C, T = _composite(C, T, rgba[..., :3], a)
        return C, T, started

    C = torch.zeros((out_res, cols, 3), dtype=_F32, device=dev)
    T = torch.ones((out_res, cols), dtype=_F32, device=dev)
    started = torch.zeros((out_res, cols), dtype=_F32, device=dev)
    for m in range(n_planes):
        Wa, mask_a, Wb, mask_b = hats(m)
        on, ext = gate(m, mask_a, mask_b)
        if remat:
            C, T, started = checkpoint(plane, C, T, started, m, Wa, Wb, on,
                                       ext, use_reentrant=False)
        else:
            C, T, started = plane(C, T, started, m, Wa, Wb, on, ext)
    return C, T


# ---------------------------------------------------------------- final warp
def warp_to_screen(C: torch.Tensor, geom: SweepGeom, basis: CameraBasis,
                   axis: int, width: int, height: int,
                   bg: torch.Tensor, gather: bool = False) -> torch.Tensor:
    """Homography warp intermediate (O,O,3) -> screen (H,W,3): each screen
    pixel's ray hits the base plane at t = (w_base - e_k)/d_k, whose
    in-plane coordinates index the intermediate bilinearly (``ops.warp``:
    kernel K2 on the card, its plain gather version on the CPU).
    ``gather``: the plain gather warp on every device, the differentiable
    one (K2 has no backward)."""
    s = warp_scalars(geom, basis, bg)
    if gather:
        return warp.warp_screen_plain(C, s, axis, width, height)
    return warp.warp_screen(C.contiguous(), s, axis, width, height)


def warp_scalars(geom: SweepGeom, basis: CameraBasis,
                 bg: torch.Tensor) -> torch.Tensor:
    """The (24,) scalar vector of ``ops.warp`` for one frame."""
    return torch.cat([basis.pack(), geom.w_base.reshape(1), geom.e,
                      torch.stack([geom.a0, geom.da, geom.b0, geom.db]),
                      bg.reshape(3)]).to(_F32)


# ------------------------------------------------------------------ front-end
def prepare_sweep_volumes(mods, seg, pred, p, axis):
    """Blend modalities + permute volumes for one sweep axis. Camera
    independent, so callers cache the result across frames."""
    M = mods.shape[0]
    mixed = blend_modalities(mods, p.vol_enabled[:M], p.vol_weight[:M])
    mixed_s = _perm_volume(mixed, axis).contiguous()
    seg_s = None if seg is None else _perm_volume(seg, axis).contiguous()
    pred_s = None if pred is None else _perm_volume(pred, axis).contiguous()
    return mixed_s, seg_s, pred_s


def content_geometry(basis, p, dims_local, axis, out_res, width, height,
                     z_offset=None, nk_global=None, ab_offset=None,
                     inplane_global=None) -> SweepGeom:
    """Sweep geometry for (possibly cropped/slabbed) prepared volumes: the
    single source of the content-box contract. Offsets are host ints."""
    with profiling.span("content_geometry"):
        Kl, Nal, Nbl = dims_local
        nk = nk_global if nk_global is not None else Kl
        na_g, nb_g = inplane_global if inplane_global is not None \
            else (Nal, Nbl)
        z0 = 0.0 if z_offset is None else float(z_offset)
        a_lo, b_lo = (0.0, 0.0) if ab_offset is None \
            else (float(ab_offset[0]), float(ab_offset[1]))
        k_hi = z0 + Kl if z_offset is not None else float(nk)
        return sweep_geometry(basis, p, (nk, na_g, nb_g), axis, out_res,
                              (z0, a_lo, b_lo), (k_hi, a_lo + Nal, b_lo + Nbl),
                              frustum_wh=(width, height))


def crop_out_res(base_res: int, crops, dims_perm):
    """Shared crop->intermediate-resolution rule: when the in-plane content
    box is cropped, shrink the intermediate plane to the content fraction,
    rounded UP to 128 with a 128 floor (the round-up only ever raises
    sampling density). Returns ``(out_res, inplane_cropped)``."""
    (_, _), (a_lo, a_hi), (b_lo, b_hi) = crops
    _, na_g, nb_g = dims_perm
    inplane_cropped = (a_lo, a_hi, b_lo, b_hi) != (0, na_g, 0, nb_g)
    if not inplane_cropped:
        return base_res, False
    frac = max((a_hi - a_lo) / na_g, (b_hi - b_lo) / nb_g)
    return min(base_res, max(128, -(-int(base_res * frac) // 128) * 128)), \
        True


def dominant_axis(basis) -> int:
    """Host-side choice of sweep axis (forward component largest)."""
    fwd = basis.forward if isinstance(basis, CameraBasis) else basis[9:12]
    if isinstance(fwd, torch.Tensor):
        fwd = fwd.detach().cpu().numpy()
    return int(np.argmax(np.abs(np.asarray(fwd))))


def render_prepared(mixed_s, seg_s, pred_s, basis: CameraBasis, p, axis,
                    width, height, out_res, supersample=1, use_gamma=True,
                    use_clip=True, composite="scan", z_offset=None,
                    nk_global=None, ab_offset=None, inplane_global=None,
                    echo=None):
    """Per-frame renderer over cached prepared volumes (the interactive
    path). ``composite``: 'scan' (``sweep_composite``), 'scan_remat' (the
    same with per-plane rematerialization and the gather warp on every
    device: the differentiable-training variant) or 'fused' (stage 1 +
    kernel K1, ``ops.composite``; supersample 1 only).

    ``z_offset``/``nk_global``: the prepared volumes hold slices
    [z_offset, z_offset + K) of an ``nk_global``-deep volume.
    ``ab_offset``/``inplane_global``: they hold rows [a_off, a_off + Na) x
    cols [b_off, b_off + Nb) of an (na_g, nb_g) in-plane extent, and the
    intermediate image covers only the content box's projection.
    ``echo``: the fused compositor's instrumentation channel; 'planes'
    returns K1c's (out_res, out_res) int32 executed-plane map INSTEAD of an
    image (no warp), for ``utils.arith``. Fused compositor only.
    """
    if echo is not None and (composite != "fused" or echo != "planes"):
        raise ValueError("echo instrumentation requires the fused "
                         f"compositor and echo='planes' (got composite="
                         f"{composite!r}, echo={echo!r})")
    geom = content_geometry(basis, p, tuple(mixed_s.shape), axis, out_res,
                            width, height, z_offset, nk_global, ab_offset,
                            inplane_global)
    if composite == "fused":
        if supersample != 1:
            raise ValueError("the fused compositor samples integer planes "
                             "only (supersample=1)")
        from mri_raytracer_tpu_torch.ops.composite import \
            sweep_composite_fused

        out = sweep_composite_fused(mixed_s, seg_s, pred_s, geom, p, axis,
                                    out_res, use_gamma, use_clip,
                                    z_offset=z_offset, nk_global=nk_global,
                                    count_planes=echo is not None)
        if echo is not None:
            return out[2]  # the count map, not an image: no warp
        C = out[0]
    elif composite in ("scan", "scan_remat"):
        C, _ = sweep_composite(mixed_s, seg_s, pred_s, geom, p, axis, out_res,
                               supersample, use_gamma, use_clip,
                               z_offset=z_offset, nk_global=nk_global,
                               remat=composite == "scan_remat")
    else:
        raise ValueError(f"unknown composite {composite!r}")
    # The differentiable variant keeps the gather warp on every device, as
    # the JAX package does on every backend (shearwarp.py:1277-1281).
    return warp_to_screen(C, geom, basis, axis, width, height, p.bg_color,
                          gather=composite == "scan_remat")


def static_flags(p: BratsRenderParams) -> Tuple[bool, bool]:
    """Host-side (use_gamma, use_clip): gamma != 1 needs the pow; a near or
    far clip needs the per-pixel t test (else the plane gate is lam >= 0)."""
    use_gamma = abs(float(p.gamma) - 1.0) > 1e-12
    use_clip = float(p.near) > 0.0 or float(p.far) > 0.0
    return use_gamma, use_clip


def render_brats(mods, seg, pred, basis: CameraBasis, p: BratsRenderParams,
                 width: int = 1024, height: int = 1024,
                 out_res: Optional[int] = None, supersample: int = 1,
                 composite: str = "scan", axis: Optional[int] = None,
                 device=None) -> torch.Tensor:
    """Fast counterpart of ``ops.raymarch.render_brats`` -> (H, W, 3) on
    ``device`` (``cuda`` unless given). ``composite``: 'scan', 'scan_remat'
    (autograd w.r.t. ``mods`` flows through the whole shear-warp
    factorization with O(out_res^2) backward memory a plane) or 'fused'.
    ``axis``: the sweep axis, by default ``dominant_axis(basis)``."""
    dev = resolve_device(device)
    out_res = out_res or max(width, height)
    if axis is None:
        axis = dominant_axis(basis)
    use_gamma, use_clip = static_flags(p)
    mods = torch.as_tensor(mods, dtype=_F32, device=dev)
    seg = None if seg is None else torch.as_tensor(seg, device=dev)
    pred = None if pred is None else torch.as_tensor(pred, device=dev)
    p = p.to(dev)
    vols = prepare_sweep_volumes(mods, seg, pred, p, axis)
    return render_prepared(*vols, basis.to(dev), p, axis, width, height,
                           out_res, supersample, use_gamma, use_clip,
                           composite)
