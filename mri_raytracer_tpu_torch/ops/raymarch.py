"""The lockstep BraTS ray-marcher: the golden oracle.

Port of ``ops/raymarch_xla.py:38-150``: pinhole rays, slab AABB clip,
fixed-delta-t front-to-back march, windowed/gamma transfer on the blended
intensity, nearest-neighbor GT-seg and INR-pred label overlays with an
8-entry RGBA LUT, early termination at T <= 0.01
(``inr/viewer/brats_rt.slang:85-168``).

All pixels march in lockstep; the while-loop is a Python loop that stops
when no ray is active (one device sync per step — this is the reference,
not the fast path).

The u8 grid renderers (``ops/raymarch_xla.py:153-306``, reference
``scripts/volumeRendering/volume_render.slang:104-148``) step a fixed
count between the near and far planes through the [-1,1]^3 cube:
``render_grid_u8`` accumulates ``a += (1-a) * s * 4/steps`` until 0.995,
``render_grid_mip`` takes the maximum sample and ``render_grid_iso`` the
first crossing of an iso value, Phong-shaded. Their loops have a fixed
trip count and never sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mri_raytracer_tpu_torch.env import device_floats, resolve_device
from mri_raytracer_tpu_torch.ops.trilinear import (nearest_sample,
                                                   trilinear_sample_base)
from mri_raytracer_tpu_torch.render.camera import CameraBasis, camera_rays
from mri_raytracer_tpu_torch.render.params import BratsRenderParams


def _safe_dir(d: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Avoid div-by-zero exactly like the shader (brats_rt.slang:96-99)."""
    return torch.where(torch.abs(d) < eps, torch.full_like(d, eps), d)


def aabb_hit(ro: torch.Tensor, rcp: torch.Tensor, bmin: torch.Tensor,
             bmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab test; returns (hit, tmin, tmax). Shapes broadcast over pixels."""
    t0 = (bmin - ro) * rcp
    t1 = (bmax - ro) * rcp
    tsm = torch.minimum(t0, t1)
    tbg = torch.maximum(t0, t1)
    tmin = torch.amax(tsm, dim=-1)
    tmax = torch.amin(tbg, dim=-1)
    return tmax >= torch.clamp(tmin, min=0.0), tmin, tmax


def blend_modalities(mods: torch.Tensor, enabled: torch.Tensor,
                     weight: torch.Tensor) -> torch.Tensor:
    """(M,X,Y,Z) -> (X,Y,Z) weighted blend, normalized by the enabled-weight
    sum (matches the shader's v / wSum; zero when nothing enabled)."""
    w = enabled * weight  # (M,)
    wsum = torch.sum(w)
    mixed = torch.tensordot(w, mods, dims=([0], [0]))
    return torch.where(wsum > 0.0, mixed / torch.clamp(wsum, min=1e-12),
                       torch.zeros_like(mixed))


def bake_label_rgba(labels: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """(X,Y,Z) int labels -> (4,X,Y,Z) RGBA voxel grid via the LUT.

    Labels outside [1,8) composite as nothing; lut[0] is transparent so the
    clamp-to-0 covers them (shader check l>0 && l<8, brats_rt.slang:145).
    """
    safe = torch.where((labels > 0) & (labels < 8), labels,
                       torch.zeros_like(labels)).long()
    return torch.movedim(lut[safe], -1, 0)


def transfer_function(v: torch.Tensor, ww, wl, gamma) -> torch.Tensor:
    """Window/level + gamma (brats_rt.slang:132-133). The clip is
    ``jnp.clip``'s ``min(max(x, 0), 1)``: where it is differentiated (the
    ROI policy renderer), a tie passes half the gradient, as in JAX, where
    ``torch.clamp`` would pass all of it."""
    x = (v - (wl - ww * 0.5)) / ww
    val = torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))
    return torch.pow(val, gamma)


def render_brats(mods, seg: Optional[torch.Tensor],
                 pred: Optional[torch.Tensor], basis: CameraBasis,
                 p: BratsRenderParams, width: int = 512, height: int = 512,
                 max_steps: int = 1024, device=None) -> torch.Tensor:
    """Full-parity BraTS render -> (height, width, 3) float32 RGB on
    ``device`` (``cuda`` unless given).

    mods: (M, X, Y, Z) float volumes (display-normalized).
    seg/pred: (X, Y, Z) int labels or None.
    """
    dev = resolve_device(device)
    mods = torch.as_tensor(mods, dtype=torch.float32, device=dev)
    seg = None if seg is None else torch.as_tensor(seg, device=dev)
    pred = None if pred is None else torch.as_tensor(pred, device=dev)
    basis = basis.to(dev)
    p = p.to(dev)

    X, Y, Z = mods.shape[1:]
    dims = torch.tensor([X, Y, Z], dtype=torch.float32, device=dev)
    M = mods.shape[0]
    mixed = blend_modalities(mods, p.vol_enabled[:M], p.vol_weight[:M])
    seg_rgba = bake_label_rgba(seg, p.lut) if seg is not None else None
    pred_rgba = bake_label_rgba(pred, p.lut) if pred is not None else None

    ro, rd = camera_rays(basis, width, height)
    rcp = 1.0 / _safe_dir(rd)
    bmin = p.vol_min
    bmax = p.vol_min + p.voxel_size * dims
    hit, t0, t1 = aabb_hit(ro, rcp, bmin, bmax)
    t0 = torch.maximum(t0, torch.clamp(p.near, min=0.0))
    t1 = torch.where(p.far > 0.0, torch.minimum(t1, p.far), t1)
    valid = hit & (t1 > t0)

    dt = p.step_size
    C = p.bg_color.expand(height, width, 3).clone()
    T = torch.ones((height, width), dtype=torch.float32, device=dev)
    t = torch.where(valid, t0, t1)  # invalid rays start finished

    def composite(C, T, rgb, alpha):
        C = C + (alpha * T)[..., None] * rgb
        T = T * (1.0 - alpha)
        return C, T

    for _ in range(max_steps):
        active = (t < t1) & (T > 0.01) & valid
        if not bool(torch.any(active)):
            break
        pos = ro + t[..., None] * rd
        pidx = (pos - bmin) / p.voxel_size

        v = trilinear_sample_base(mixed, pidx)
        val = transfer_function(v, p.ww, p.wl, p.gamma)
        a = 1.0 - torch.exp(-val * p.intensity_alpha * dt)
        a = torch.where(active, a, 0.0)
        C, T = composite(C, T, val[..., None], a)

        if seg_rgba is not None:
            rgba = torch.stack([nearest_sample(seg_rgba[c], pidx)
                                for c in range(4)], -1)
            a = 1.0 - torch.exp(-rgba[..., 3] * dt)
            a = torch.where(active & (p.show_seg > 0), a, 0.0)
            C, T = composite(C, T, rgba[..., :3], a)
        if pred_rgba is not None:
            rgba = torch.stack([nearest_sample(pred_rgba[c], pidx)
                                for c in range(4)], -1)
            # Prediction overlay marches at 1.5x opacity (brats_rt.slang:158).
            a = 1.0 - torch.exp(-rgba[..., 3] * dt * 1.5)
            a = torch.where(active & (p.show_pred > 0), a, 0.0)
            C, T = composite(C, T, rgba[..., :3], a)

        t = t + dt
    return C


# ------------------------------------------------------------ u8 grid volume
class GridRenderParams(NamedTuple):
    """The grid renderers' scalars: float32 numbers (numpy scalars, floats
    or 0-d tensors), read on the host once a frame."""

    step_count: object  # ()
    near: object  # ()
    far: object  # ()


def _f32(x) -> np.float32:
    return np.float32(float(x))


def _grid_ray_setup(vol_u8, basis: CameraBasis, p: GridRenderParams,
                    width: int, height: int, device=None):
    """Shared near/far-plane stepping setup of the grid renderers: the
    volume in [0, 1], its index extent, the near-plane points and the step
    vector, on ``device`` (``cuda`` unless given), plus the float32 step
    count. The scalar math is float32 on the host, as JAX does it on the
    device."""
    dev = resolve_device(device)
    vol = torch.as_tensor(vol_u8, device=dev).to(torch.float32) / 255.0
    X, Y, Z = vol.shape
    dims1 = device_floats([X - 1, Y - 1, Z - 1], dev)
    basis = basis.to(dev)
    ro, rd_unit = camera_rays(basis, width, height)
    # The WGSL-style setup scales the *unnormalized* camera-space vector by
    # near/far; camera_rays normalized rd, so recover it by dividing by the
    # camera-space z == dot(rd, forward).
    z_cam = (rd_unit * basis.forward).sum(-1)
    dir_plane = rd_unit / z_cam[..., None]
    n = np.maximum(np.float32(0.0), _f32(p.near))
    f = np.maximum(n, _f32(p.far))
    steps = np.maximum(np.float32(1.0), _f32(p.step_count))
    return (vol, dims1, ro + dir_plane * float(n),
            dir_plane * float(f - n) / float(steps), steps)


def _grid_sample(vol, dims1, pos):
    """Trilinear sample of the [-1,1]^3 grid at world ``pos`` (masked to 0
    outside the cube), and the inside mask."""
    inside = torch.all((pos < 1.0) & (pos > -1.0), dim=-1)
    pidx = 0.5 * (pos + 1.0) * dims1
    return torch.where(inside, trilinear_sample_base(vol, pidx), 0.0), inside


def render_grid_u8(vol_u8, basis: CameraBasis, p: GridRenderParams,
                   width: int = 512, height: int = 512, max_steps: int = 512,
                   device=None) -> torch.Tensor:
    """u8 grid renderer parity (volume_render.slang): the volume occupies
    [-1,1]^3; rays step uniformly between the near and far *planes* and only
    accumulate inside the cube. Returns (H, W, 3) grayscale."""
    vol, dims1, pos, step_vec, steps = _grid_ray_setup(
        vol_u8, basis, p, width, height, device)
    count = _f32(p.step_count)
    gain = float(np.float32(4.0) / steps)
    accum = torch.zeros((height, width), dtype=torch.float32,
                        device=vol.device)
    for i in range(max_steps):
        # Steps at or past the step count change nothing.
        if i < count:
            inside = torch.all((pos < 1.0) & (pos > -1.0), dim=-1)
            pidx = 0.5 * (pos + 1.0) * dims1
            s = trilinear_sample_base(vol, pidx) * gain
            # Gate matches the shader's end-of-loop `accum > 0.995` break:
            # a step accumulates iff accum entering the step is <= 0.995.
            do = inside & (accum <= 0.995)
            accum = torch.where(do, accum + (1.0 - accum) * s, accum)
        pos = pos + step_vec
    return accum[..., None].repeat(1, 1, 3)


def render_grid_mip(vol_u8, basis: CameraBasis, p: GridRenderParams,
                    width: int = 512, height: int = 512, max_steps: int = 512,
                    device=None) -> torch.Tensor:
    """Maximum-intensity projection of the u8 grid: max of trilinear
    samples along each ray between the near/far planes. Same camera and
    stepping setup as ``render_grid_u8``; order-independent, so no early
    termination."""
    vol, dims1, pos, step_vec, _ = _grid_ray_setup(
        vol_u8, basis, p, width, height, device)
    count = _f32(p.step_count)
    best = torch.zeros((height, width), dtype=torch.float32,
                       device=vol.device)
    for i in range(max_steps):
        if i < count:
            s, _ = _grid_sample(vol, dims1, pos)
            best = torch.maximum(best, s)
        pos = pos + step_vec
    return best[..., None].repeat(1, 1, 3)


def render_grid_iso(vol_u8, basis: CameraBasis, p: GridRenderParams,
                    width: int = 512, height: int = 512, max_steps: int = 512,
                    iso: float = 0.25, light_dir=(0.4, 0.6, 0.7),
                    device=None) -> torch.Tensor:
    """First-crossing iso-surface render with gradient Phong shading.

    Fixed-trip masked march: the first step whose trilinear sample crosses
    ``iso`` records a linearly refined hit position; the surface normal is
    the central-difference intensity gradient at the hit, shaded with
    Lambert + Blinn-Phong against a fixed light plus a headlight ambient
    term."""
    vol, dims1, world_near, step_vec, _ = _grid_ray_setup(
        vol_u8, basis, p, width, height, device)
    dev = vol.device
    count = _f32(p.step_count)
    iso_f = float(np.float32(iso))
    H, W = height, width
    found = torch.zeros((H, W), dtype=torch.bool, device=dev)
    hit = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    prev_s = torch.zeros((H, W), dtype=torch.float32, device=dev)
    pos = world_near
    for i in range(max_steps):
        if i < count:
            s, inside = _grid_sample(vol, dims1, pos)
            cross = inside & ~found & (prev_s < iso_f) & (s >= iso_f)
            # Linear refinement between the previous and current step. At
            # i == 0 there is no previous sample (prev_s is the 0 init): the
            # segment start is the near-plane point itself, so the refined
            # hit never lands in front of the near clip.
            seg_start = pos if i == 0 else pos - step_vec
            frac = torch.clamp((iso_f - prev_s)
                               / torch.clamp(s - prev_s, min=1e-6), 0.0, 1.0)
            hit_new = seg_start + frac[..., None] * (pos - seg_start)
            found = found | cross
            hit = torch.where(cross[..., None], hit_new, hit)
            prev_s = s
        pos = pos + step_vec

    # Central-difference gradient at the hit (2-voxel stencil in world
    # units of the largest axis).
    eps = float(np.float32(2.0) / np.float32(max(vol.shape) - 1))
    grads = []
    for a in range(3):
        d = torch.zeros(3, dtype=torch.float32, device=dev)
        d[a] = eps
        sp, _ = _grid_sample(vol, dims1, hit + d)
        sm, _ = _grid_sample(vol, dims1, hit - d)
        grads.append(sp - sm)
    g = torch.stack(grads, -1)
    n_vec = -g / torch.clamp(_norm(g), min=1e-6)
    l = device_floats(np.asarray(light_dir, np.float32), dev)
    l = l / _norm(l)
    _, rd_unit = camera_rays(basis.to(dev), width, height)
    v = -rd_unit
    h = (l + v) / torch.clamp(_norm(l + v), min=1e-6)
    diff = torch.clamp((n_vec * l).sum(-1), min=0.0)
    spec = torch.clamp((n_vec * h).sum(-1), min=0.0) ** 32
    shade = torch.clamp(0.12 + 0.75 * diff + 0.35 * spec, 0.0, 1.0)
    out = torch.where(found, shade, 0.0)
    return out[..., None].repeat(1, 1, 3)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(x, axis=-1, keepdims=True)``."""
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)
