"""The lockstep BraTS ray-marcher: the golden oracle.

Port of ``ops/raymarch_xla.py:38-150``: pinhole rays, slab AABB clip,
fixed-delta-t front-to-back march, windowed/gamma transfer on the blended
intensity, nearest-neighbor GT-seg and INR-pred label overlays with an
8-entry RGBA LUT, early termination at T <= 0.01
(``inr/viewer/brats_rt.slang:85-168``).

All pixels march in lockstep; the while-loop is a Python loop that stops
when no ray is active (one device sync per step — this is the reference,
not the fast path).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mri_raytracer_tpu_torch.env import resolve_device
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
