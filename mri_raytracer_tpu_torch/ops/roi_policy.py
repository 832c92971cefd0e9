"""ROI-aware policy-MLP adaptive renderer (port of ``ops/roi_policy.py``;
reference ``docs/Methodology-ROI-Neural-Volumetric-Rendering.md``).

A tiny MLP reads 8 features at N_c coarse probes per ray and emits a
delta-t scale in [0.25, 2.0], a skip probability and an optional LOD
offset; the fine budget N_f is then redistributed along each ray by
inverse-CDF placement under the density rho = (1 - skip) / scale
(Methodology:35-47), with ROI clamps (tumor probability or boundary
proximity high => at least the base rate, never skipped).

  Phase 1 (coarse): probes on a strided pixel grid gather the feature rows
  (one nearest 8-channel row per probe) and the raw intensity (trilinear),
  build the features (density, gradient magnitude, view alignment, coarse
  transmittance, depth, P(x), B(x), dilated occupancy) and run the policy
  in bfloat16.
  Phase 2 (fine): per decision block, ``ops/importance.inverse_cdf_sample_mm``
  places the fine samples in normalized ray coordinates; each ray maps them
  onto its own [t0, t1] and marches them in blocks, compositing each block
  with the associative over-operator (peak memory O(H W block)).

Everything is a function of tensors on one device (the volume's). The path
is differentiable in the policy's parameters (inverse CDF, the packed
trilinear positions, the compositing adjoint of ``ops/diffrender``), so
``train_policy`` trains it against rendered references. Clips and maxima on
that path are ``torch.minimum``/``torch.maximum`` with tensor bounds, which
split the gradient at a tie as ``jnp.clip``/``jnp.maximum`` do.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mri_raytracer_tpu_torch.ops.diffrender import (composite_fronttoback,
                                                    cumprod_last)
from mri_raytracer_tpu_torch.ops.importance import (_full,
                                                    inverse_cdf_sample_mm)
from mri_raytracer_tpu_torch.ops.raymarch import (_safe_dir, aabb_hit,
                                                  transfer_function)
from mri_raytracer_tpu_torch.ops.trilinear import (
    _dims, nearest_sample_rows, trilinear_sample_base,
    trilinear_sample_packed)
from mri_raytracer_tpu_torch.render.camera import (CameraBasis, camera_rays,
                                                   camera_rays_window,
                                                   unpack_basis)
from mri_raytracer_tpu_torch.render.params import BratsRenderParams
from mri_raytracer_tpu_torch.train.optimizers import (ClippedOptimizer,
                                                      _warmup_cosine)

N_FEATURES = 8
Policy = Dict[str, torch.Tensor]


class PolicyConfig(NamedTuple):
    hidden: int = 24  # 16-32 per the methodology (:42)
    scale_min: float = 0.25  # delta-t scale range (:43)
    scale_max: float = 2.0
    p_hi: float = 0.5  # ROI clamp thresholds (:45-46)
    b_hi: float = 0.5
    skip_floor: float = 0.02  # density floor so no segment fully starves


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)`` with its gradient at ties."""
    return torch.maximum(x, _full(x, c))


def _np(x) -> np.ndarray:
    """A host array of a tensor (any device) or array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def init_policy(generator: torch.Generator,
                cfg: PolicyConfig = PolicyConfig(),
                device="cpu") -> Policy:
    """Tiny policy MLP: 8 -> hidden -> 3 (dt-scale logit, skip logit,
    LOD-offset logit).

    Occupancy-informed initialization (``roi_policy.py:66-92``): dt-scale
    pinned at 1 and skip = sigmoid(8 * relu(1 - 50 * occupancy) - 4), so
    the start skips exactly where the dilated occupancy feature proves no
    content is near. The pinned entries are exact; the small random parts
    come from ``generator`` (float32 normals on the CPU; never the global
    generator)."""
    if not isinstance(generator, torch.Generator):
        raise TypeError("init_policy needs a torch.Generator")
    g = generator
    s1 = float(np.sqrt(2.0 / N_FEATURES))
    s_one = (1.0 - cfg.scale_min) / (cfg.scale_max - cfg.scale_min)
    b_scale = float(np.log(s_one / (1.0 - s_one)))
    W1 = torch.randn((N_FEATURES, cfg.hidden), generator=g) * (0.05 * s1)
    W1[7, 0] = -50.0  # hidden 0 = relu(1 - 50*occupancy)
    b1 = torch.zeros(cfg.hidden)
    b1[0] = 1.0
    W2 = torch.randn((cfg.hidden, 3), generator=g) * 0.01
    W2[0, 1] = 8.0  # -> skip logit
    W2[0, 0] = 0.0  # keep dt-scale at 1 regardless of occupancy
    W2[0, 2] = 0.0  # LOD offset starts neutral
    b2 = torch.tensor([b_scale, -4.0, 0.0], dtype=torch.float32)
    return {k: v.to(device) for k, v in
            (("W1", W1), ("b1", b1), ("W2", W2), ("b2", b2))}


def apply_policy(params: Policy, feats: torch.Tensor, cfg: PolicyConfig,
                 dtype=torch.bfloat16
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """feats (..., 8) -> (dt_scale in [scale_min, scale_max], skip in [0,1],
    lod_offset in (-4, 4)), float32. The MLP runs in bfloat16 (the
    reference's FP16 weight path, Methodology:44); a 2-output checkpoint
    reports a neutral 0 offset."""
    x = feats.to(dtype)
    h = torch.relu(x @ params["W1"].to(dtype) + params["b1"].to(dtype))
    out = (h @ params["W2"].to(dtype) + params["b2"].to(dtype)) \
        .to(torch.float32)
    s = torch.sigmoid(out[..., 0])
    dt_scale = cfg.scale_min + (cfg.scale_max - cfg.scale_min) * s
    skip = torch.sigmoid(out[..., 1])
    if params["W2"].shape[-1] >= 3:
        # (-4, 4): wide enough to fully disable the blend at coarse budgets.
        lod_off = 4.0 * torch.tanh(out[..., 2])
    else:
        lod_off = torch.zeros_like(skip)
    return dt_scale, skip, lod_off


# ------------------------------------------------------------ feature volumes
def build_feature_volumes(mixed: np.ndarray, seg: Optional[np.ndarray],
                          smooth_sigma: float = 2.0) -> Dict[str, np.ndarray]:
    """Precompute the ROI feature volumes (host numpy, once per case).

    P(x): smoothed tumor probability from labels (Methodology:24);
    B(x): boundary proximity 1/(1+EDT) (:25); gradmag and its direction
    (view alignment, :36-38); occupancy: the intensity max-filtered over
    a coarse segment's span, the signal that makes a skip safe."""
    from scipy import ndimage

    mixed = np.asarray(mixed, np.float32)
    gx, gy, gz = np.gradient(mixed)
    gradmag = np.sqrt(gx * gx + gy * gy + gz * gz).astype(np.float32)
    gnorm = np.maximum(gradmag, 1e-6)
    graddir = np.stack([gx / gnorm, gy / gnorm, gz / gnorm]).astype(np.float32)
    # Dilation radius: half a coarse-segment span + trilinear support
    # (size 5 beat size 9 by ~1.8 dB at equal budget on 96^3 scenes in the
    # JAX package's runs; size 3 under-protects).
    occ_r = max(5, min(mixed.shape) // 20) | 1
    occupancy = ndimage.maximum_filter(mixed, size=occ_r).astype(np.float32)

    if seg is not None:
        tumor = (np.asarray(seg) > 0).astype(np.float32)
        P = ndimage.gaussian_filter(tumor, smooth_sigma).astype(np.float32)
        if tumor.any() and not tumor.all():
            d_out = ndimage.distance_transform_edt(tumor == 0)
            d_in = ndimage.distance_transform_edt(tumor == 1)
            dist = np.where(tumor > 0, d_in, d_out).astype(np.float32)
            B = (1.0 / (1.0 + dist)).astype(np.float32)
        else:
            B = np.zeros_like(tumor)
    else:
        P = np.zeros_like(mixed)
        B = np.zeros_like(mixed)
    return {"P": P, "B": B, "gradmag": gradmag, "graddir": graddir,
            "occupancy": occupancy}


def pack_feature_rows(mixed: np.ndarray, feats: Dict[str, np.ndarray]
                      ) -> np.ndarray:
    """(X, Y, Z, 8) channel-packed probe volume: [raw intensity, gradmag,
    graddir_xyz, P, B, dilated occupancy]: one row gather per probe."""
    return np.stack([mixed, feats["gradmag"], feats["graddir"][0],
                     feats["graddir"][1], feats["graddir"][2], feats["P"],
                     feats["B"],
                     feats.get("occupancy", np.zeros_like(mixed))], axis=-1) \
        .astype(np.float32)


# ----------------------------------------------------------------- rendering
def _ray_setup(basis: CameraBasis, p: BratsRenderParams, dims: torch.Tensor,
               width: int, height: int, window=None):
    """Rays, AABB entry/exit and validity. ``window``: optional ((x0, y0),
    (win_w, win_h)): rays for a sub-rectangle of the ``width x height``
    frame, equal to the same pixels of the full frame."""
    if window is None:
        ro, rd = camera_rays(basis, width, height)
    else:
        (x0, y0), (win_w, win_h) = window
        ro, rd = camera_rays_window(basis, width, height, x0, y0,
                                    win_w, win_h)
    rcp = 1.0 / _safe_dir(rd)
    bmin = p.vol_min
    bmax = p.vol_min + p.voxel_size * dims
    hit, t0, t1 = aabb_hit(ro, rcp, bmin, bmax)
    t0 = torch.maximum(t0, torch.clamp(p.near, min=0.0))
    t1 = torch.where(p.far > 0.0, torch.minimum(t1, p.far), t1)
    valid = hit & (t1 > t0)
    t0 = torch.where(valid, t0, torch.zeros_like(t0))
    t1 = torch.where(valid, t1, torch.full_like(t1, 1e-3))
    return ro, rd, t0, t1, valid, bmin


def _sample_any(vol: torch.Tensor, pidx: torch.Tensor) -> torch.Tensor:
    if vol.ndim == 4:
        return trilinear_sample_packed(vol, pidx)
    return trilinear_sample_base(vol, pidx)


def _march_composite(mixed, pidx, dt, p, valid, lod_vol=None, lam=None):
    """Fine-phase compositing: trilinear sample -> transfer -> alpha ->
    front-to-back (O(N) adjoint via ``ops/diffrender``). ``mixed`` is the
    plain (X, Y, Z) or the corner-packed (X, Y, Z, 8) volume. ``lod_vol``/
    ``lam``: the sample lerps toward the 2x mip by the per-sample level
    ``lam``; level-1 index space is voxel-center aligned,
    l1 = (l0 - 0.5) / 2."""
    v = _sample_any(mixed, pidx)
    if lod_vol is not None:
        v1 = _sample_any(lod_vol, (pidx - 0.5) * 0.5)
        v = v + (v1 - v) * lam
    val = transfer_function(v, p.ww, p.wl, p.gamma)
    a = 1.0 - torch.exp(-val * p.intensity_alpha * dt)
    a = a * valid[..., None].to(torch.float32)
    return composite_fronttoback(val[..., None].expand(val.shape + (3,)), a)


def _on(x: torch.Tensor, basis_vec, p: BratsRenderParams):
    """The packed camera and the params on ``x``'s device (no copy when
    they are there already: an upload from host memory waits for the
    card's queue)."""
    dev = x.device
    return torch.as_tensor(basis_vec, dtype=torch.float32).to(dev), p.to(dev)


def render_fixed(mixed: torch.Tensor, basis_vec, p: BratsRenderParams,
                 width: int, height: int, n_steps: int,
                 block: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-step baseline (B1): n_steps uniform samples per ray between the
    per-ray AABB entry/exit, on the volume's device. Returns (image
    (H, W, 3), steps-per-ray scalar tensor).

    ``block``: composite in sample blocks, generating each block's samples
    in turn (exact; memory O(H W block)), never the full (H, W, N) train:
    required at protocol scale (1080p, n_steps up to 512)."""
    basis_vec, p = _on(mixed, basis_vec, p)
    dev = mixed.device
    dims = _dims(mixed.shape[:3], dev)
    ro, rd, t0, t1, valid, bmin = _ray_setup(unpack_basis(basis_vec), p,
                                             dims, width, height)
    if block is not None and block < n_steps:
        nb = -(-n_steps // block)
        dt0 = (t1 - t0) / n_steps
        ar = torch.arange(block, dtype=torch.float32, device=dev)
        C = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
        T = torch.ones((height, width), dtype=torch.float32, device=dev)
        for bi in range(nb):
            k = float(bi * block) + ar + 0.5
            in_n = (k < n_steps).to(torch.float32)
            tk = t0[..., None] + (k / n_steps) * (t1 - t0)[..., None]
            dtk = dt0[..., None] * in_n
            pos = ro[..., None, :] + tk[..., None] * rd[..., None, :]
            pidx = (pos - bmin) / p.voxel_size
            del pos, tk
            Cb, Tb = _march_composite(mixed, pidx, dtk, p, valid)
            C = C + T[..., None] * Cb
            T = T * Tb
    else:
        k = (torch.arange(n_steps, dtype=torch.float32, device=dev) + 0.5) \
            / n_steps
        t = t0[..., None] + k * (t1 - t0)[..., None]  # (H, W, N)
        dt = ((t1 - t0) / n_steps)[..., None] \
            * torch.ones((1, 1, n_steps), device=dev)
        pos = ro[..., None, :] + t[..., None] * rd[..., None, :]
        pidx = (pos - bmin) / p.voxel_size
        C, T = _march_composite(mixed, pidx, dt, p, valid)
    steps = float(n_steps) * torch.mean(valid.to(torch.float32))
    return C + p.bg_color[None, None, :] * T[..., None], steps


def _repeat2(x: torch.Tensor, s: int, h: int, w: int) -> torch.Tensor:
    """``jnp.repeat`` by ``s`` along the first two axes, cut to (h, w)."""
    if s > 1:
        x = x.repeat_interleave(s, 0).repeat_interleave(s, 1)
    return x[:h, :w]


def _resize_hw(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (h, w, C), 'linear')`` for an integer upscale
    of (h0, w0, C): bilinear, half-pixel centers."""
    y = F.interpolate(x.permute(2, 0, 1)[None], size=(h, w),
                      mode="bilinear", align_corners=False)
    return y[0].permute(1, 2, 0)


def render_policy(policy: Policy, mixed: torch.Tensor,
                  feat_rows: torch.Tensor, basis_vec, p: BratsRenderParams,
                  width: int, height: int, n_coarse: int = 32,
                  n_fine: int = 64, cfg: PolicyConfig = PolicyConfig(),
                  roi_clamp: bool = True, probe_stride: int = 1,
                  block: Optional[int] = None,
                  lod_vol: Optional[torch.Tensor] = None,
                  rho_upsample: int = 1, window_origin=None,
                  window_size=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Policy-guided adaptive render (``roi_policy.py:291-510``). Returns
    (image, stats) on the volume's device.

    ``feat_rows``: (X, Y, Z, 8) packed probe volume from
    ``pack_feature_rows``. ``probe_stride``: a stride-S probe grid shares the
    coarse pass and the policy's decisions across S x S pixel blocks (each
    ray still places its own fine samples in its own [t0, t1]).
    ``rho_upsample``: bilinearly interpolate the density rho from the probe
    grid to a stride S/u decision grid before the CDF inversion (at 1080p an
    8 x 8 piecewise-constant block is too blocky). ``block``: march the fine
    samples in blocks of ``block`` (exact, memory O(H W block)). ``lod_vol``:
    the 2x mip of ``mixed`` (same plain/packed form): each fine sample
    blends toward it by lam = sigmoid(4 (log2(dt in voxels) + offset -
    0.5)), the policy's per-ray learned offset shifting the level.
    ``window_origin``/``window_size``: render only the (w, h) window at
    origin (x0, y0) of the ``width x height`` frame (the foveated inset;
    x0, y0 numbers or float32 0-d tensors on the device).

    stats: 'steps_per_ray' (fine samples landing in live segments + the
    amortized probes), 'mean_scale', 'mean_skip', 'expected_steps'."""
    basis_vec, p = _on(mixed, basis_vec, p)
    dev = mixed.device
    window = None if window_size is None \
        else (window_origin, tuple(window_size))
    dims = _dims(mixed.shape[:3], dev)
    ro, rd, t0, t1, valid, bmin = _ray_setup(unpack_basis(basis_vec), p,
                                             dims, width, height,
                                             window=window)
    h_out, w_out = (window_size[1], window_size[0]) \
        if window_size is not None else (height, width)

    # ---- coarse probe on a strided pixel grid: one nearest 8-channel row
    # (the smooth feature channels) and one trilinear intensity per probe.
    S = probe_stride
    if S > 1:
        ro_c, rd_c = ro[::S, ::S], rd[::S, ::S]
        t0_c, t1_c = t0[::S, ::S], t1[::S, ::S]
    else:
        ro_c, rd_c, t0_c, t1_c = ro, rd, t0, t1
    kk = torch.arange(n_coarse + 1, dtype=torch.float32, device=dev) \
        / n_coarse
    t_bins_c = t0_c[..., None] + kk * (t1_c - t0_c)[..., None]
    t_mid = 0.5 * (t_bins_c[..., :-1] + t_bins_c[..., 1:])
    pos_c = ro_c[..., None, :] + t_mid[..., None] * rd_c[..., None, :]
    pidx_c = (pos_c - bmin) / p.voxel_size

    probe = nearest_sample_rows(feat_rows, pidx_c)  # (h, w, Nc, 8)
    val_c = transfer_function(_sample_any(mixed, pidx_c), p.ww, p.wl,
                              p.gamma)
    g_c = probe[..., 1]
    gd = probe[..., 2:5]
    align = torch.abs(torch.sum(gd * rd_c[..., None, :], dim=-1))
    P_c = probe[..., 5]
    B_c = probe[..., 6]
    seg_dt = (t1_c - t0_c)[..., None] / n_coarse
    # Coarse transmittance estimate entering each segment (exclusive).
    a_c = 1.0 - torch.exp(-val_c * p.intensity_alpha * seg_dt)
    T_c = cumprod_last(1.0 - a_c)
    T_in = torch.cat([torch.ones_like(T_c[..., :1]), T_c[..., :-1]], dim=-1)
    depth = (t_mid - t0_c[..., None]) \
        / _max((t1_c - t0_c)[..., None], 1e-6)
    occ_c = probe[..., 7]
    feats = torch.stack([val_c, g_c, align, T_in, depth, P_c, B_c, occ_c],
                        dim=-1)  # (h, w, Nc, 8)
    dt_scale, skip, lod_off = apply_policy(policy, feats, cfg)

    # ---- density + ROI clamps
    rho = (1.0 - skip) / dt_scale
    if roi_clamp:
        in_roi = (P_c > cfg.p_hi) | (B_c > cfg.b_hi)
        # ROI: step at least at the base rate (scale <= 1), never skip.
        rho = torch.where(in_roi, torch.maximum(rho, 1.0 / torch.minimum(
            _full(dt_scale, 1.0), dt_scale)), rho)
    rho = _max(rho, cfg.skip_floor)
    # Occluded segments get few samples; 1e-3 keeps the PSNR ceiling past
    # 60 dB (1e-2 caps it near 40 dB) while reclaiming opaque tails.
    rho = torch.where(T_in > 1e-3, rho, cfg.skip_floor * 0.5)

    lam_of = None
    if lod_vol is not None:
        # Per-ray LOD offset: density-weighted over probes, shared across
        # the S x S probe block.
        w_rho = rho / _max(torch.sum(rho, -1, keepdim=True), 1e-6)
        lod_ray = _repeat2(torch.sum(w_rho * lod_off, -1), S, h_out, w_out)
        vox_m = torch.mean(p.voxel_size)

        def lam_of(dt_f):
            # Mip level = log2(sample footprint in voxels), a smooth
            # saturation (a clipped lam has zero gradient where training
            # starts, so the LOD head could never learn).
            x = torch.log2(_max(dt_f / vox_m, 1e-6)) + lod_ray[..., None]
            return torch.sigmoid(4.0 * (x - 0.5))

    # Stats and LOD read the probe-grid rho; the CDF may read a finer
    # interpolated copy.
    rho_c = rho
    Su = S
    if rho_upsample > 1 and S > 1:
        if S % rho_upsample:
            raise ValueError(f"rho_upsample={rho_upsample} must divide "
                             f"probe_stride={S}")
        hs, ws, _ = rho.shape
        rho = _resize_hw(rho, hs * rho_upsample, ws * rho_upsample)
        Su = S // rho_upsample

    # ---- fine placement + march: the CDF inversion runs once per decision
    # block in normalized ray coordinates s in [0, 1], then maps affinely
    # onto each ray's [t0, t1]; per-sample dt is the expected local spacing.
    s_bins = torch.broadcast_to(kk, rho.shape[:-1] + kk.shape)
    span = (t1 - t0)[..., None]

    def sample_block(u_blk):
        s_f, ds_f = inverse_cdf_sample_mm(s_bins, rho, u_blk,
                                          return_bin_dt=True,
                                          n_total=n_fine)
        s_f = _repeat2(s_f, Su, h_out, w_out)
        ds_f = _repeat2(ds_f, Su, h_out, w_out)
        return t0[..., None] + s_f * span, ds_f * span

    if block is not None and block < n_fine:
        nb = -(-n_fine // block)
        ar = torch.arange(block, dtype=torch.float32, device=dev)
        C = torch.zeros((h_out, w_out, 3), dtype=torch.float32, device=dev)
        T = torch.ones((h_out, w_out), dtype=torch.float32, device=dev)
        for bi in range(nb):
            j = float(bi * block) + ar
            u_blk = (j + 0.5) / n_fine
            in_n = (j < n_fine).to(torch.float32)
            t_f, dt_f = sample_block(torch.minimum(
                u_blk, _full(u_blk, 1.0 - 1e-6)))
            pos_f = ro[..., None, :] + t_f[..., None] * rd[..., None, :]
            pidx_f = (pos_f - bmin) / p.voxel_size
            del pos_f, t_f
            Cb, Tb = _march_composite(
                mixed, pidx_f, dt_f * in_n, p, valid, lod_vol=lod_vol,
                lam=lam_of(dt_f) if lam_of is not None else None)
            del pidx_f, dt_f
            C = C + T[..., None] * Cb
            T = T * Tb
    else:
        u = (torch.arange(n_fine, dtype=torch.float32, device=dev) + 0.5) \
            / n_fine
        t_f, dt_f = sample_block(u)
        pos_f = ro[..., None, :] + t_f[..., None] * rd[..., None, :]
        pidx_f = (pos_f - bmin) / p.voxel_size
        C, T = _march_composite(
            mixed, pidx_f, dt_f, p, valid, lod_vol=lod_vol,
            lam=lam_of(dt_f) if lam_of is not None else None)

    # ---- stats: useful samples = fine samples in live segments.
    valid_c = valid[::S, ::S] if S > 1 else valid
    mass = rho_c * ((t1_c - t0_c)[..., None] / n_coarse)
    frac_live = torch.sum(torch.where(T_in > 0.01, mass, 0.0), -1) \
        / _max(torch.sum(mass, -1), 1e-9)
    steps = torch.mean(torch.where(
        valid_c, frac_live * n_fine + n_coarse / (S * S), 0.0))
    stats = {"steps_per_ray": steps,
             "mean_scale": torch.mean(dt_scale),
             "mean_skip": torch.mean(skip),
             "expected_steps": torch.mean(torch.sum(mass, -1) / p.step_size)}
    return C + p.bg_color[None, None, :] * T[..., None], stats


# --------------------------------------------------------------- foveated mode
def roi_world_corners(P_vol, B_vol, p: BratsRenderParams,
                      thresh: float = 0.3) -> np.ndarray:
    """Host-side, once per scene: world-space corner points (8, 3) of the
    ROI bounding box (tumor probability or boundary proximity above
    ``thresh``), padded by one voxel."""
    m = (_np(P_vol) > thresh) | (_np(B_vol) > thresh)
    dims = np.array(m.shape, np.float32)
    if m.any():
        idx = np.nonzero(m)
        lo = np.array([i.min() for i in idx], np.float32) - 1.0
        hi = np.array([i.max() for i in idx], np.float32) + 2.0
    else:
        lo = np.zeros(3, np.float32)
        hi = dims
    vmin = _np(p.vol_min).astype(np.float32)
    vox = _np(p.voxel_size).astype(np.float32)
    corners = np.array([[lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]],
                        [lo[0], hi[1], lo[2]], [lo[0], hi[1], hi[2]],
                        [hi[0], lo[1], lo[2]], [hi[0], lo[1], hi[2]],
                        [hi[0], hi[1], lo[2]], [hi[0], hi[1], hi[2]]],
                       np.float32)
    return vmin[None, :] + vox[None, :] * corners


def _project_to_pixels(basis: CameraBasis, pts: torch.Tensor,
                       width: int, height: int):
    """World points (N, 3) -> pixel coordinates (px, py), the inverse of
    ``camera_rays``'s pinhole."""
    v = pts - basis.eye[None, :]
    x = v @ basis.right
    y = v @ basis.up
    z = _max(v @ basis.forward, 1e-3)  # behind-eye guard
    f = 1.0 / torch.tan(0.5 * basis.fov_y)
    aspect = width / max(1.0, float(height))
    u_ndc = (x / z) * f / aspect
    v_ndc = -(y / z) * f
    px = (u_ndc + 1.0) * 0.5 * width
    py = (v_ndc + 1.0) * 0.5 * height
    return px, py


def foveation_rect(width: int, height: int, rect_frac: float = 0.5,
                   probe_stride: int = 1) -> Tuple[int, int]:
    """Inset size: ``rect_frac`` of each frame axis, rounded to a multiple
    of 2 x probe_stride."""
    q = 2 * max(1, probe_stride)
    rw = max(q, int(width * rect_frac) // q * q)
    rh = max(q, int(height * rect_frac) // q * q)
    return rw, rh


def render_policy_foveated(policy: Policy, mixed: torch.Tensor,
                           feat_rows: torch.Tensor, basis_vec,
                           p: BratsRenderParams, width: int, height: int,
                           roi_corners, n_coarse: int = 32,
                           n_fine: int = 64, nf_bg: Optional[int] = None,
                           cfg: PolicyConfig = PolicyConfig(),
                           probe_stride: int = 1,
                           block: Optional[int] = None,
                           lod_vol: Optional[torch.Tensor] = None,
                           rho_upsample: int = 1, rect_frac: float = 0.5,
                           feather: int = 16
                           ) -> Tuple[torch.Tensor, Dict]:
    """Foveated policy render (``roi_policy.py:567-661``): the full frame
    at half resolution (bilinear upsample) plus the projected-ROI rectangle
    at full resolution, feather-blended over the upsample. ROI pixels equal
    the full-resolution ``render_policy`` of the same pixels: window rays
    are the full frame's, and the inset origin is aligned to
    max(2, probe_stride) so the probe and decision grids coincide.

    The origin stays on the device (no host sync a frame): the inset is
    read and written back through index tensors. ``roi_corners``: (8, 3)
    from ``roi_world_corners``. ``nf_bg``: background fine budget (default
    ``n_fine``). stats['rect'] = (x0, y0, rw, rh), x0/y0 0-d int tensors."""
    basis_vec, p = _on(mixed, basis_vec, p)
    basis = unpack_basis(basis_vec)
    dev = mixed.device
    rw, rh = foveation_rect(width, height, rect_frac, probe_stride)
    q = max(2, probe_stride)
    px, py = _project_to_pixels(
        basis, torch.as_tensor(roi_corners, dtype=torch.float32).to(dev),
        width, height)
    cx = 0.5 * (torch.min(px) + torch.max(px))
    cy = 0.5 * (torch.min(py) + torch.max(py))
    x0 = torch.clamp(torch.round(cx - 0.5 * rw), 0, width - rw)
    y0 = torch.clamp(torch.round(cy - 0.5 * rh), 0, height - rh)
    x0 = torch.div(x0.to(torch.int32), q, rounding_mode="floor") * q
    y0 = torch.div(y0.to(torch.int32), q, rounding_mode="floor") * q

    # Background: the full frame at half resolution, same frustum; the
    # probe stride halves so world-space probe density matches the inset's.
    bg_stride = max(1, probe_stride // 2)
    img_bg, st_bg = render_policy(
        policy, mixed, feat_rows, basis_vec, p, width // 2, height // 2,
        n_coarse, nf_bg or n_fine, cfg, probe_stride=bg_stride,
        block=block, lod_vol=lod_vol,
        rho_upsample=min(rho_upsample, bg_stride) if bg_stride > 1 else 1)
    bg = _resize_hw(img_bg, height, width)

    img_roi, st_roi = render_policy(
        policy, mixed, feat_rows, basis_vec, p, width, height,
        n_coarse, n_fine, cfg, probe_stride=probe_stride, block=block,
        lod_vol=lod_vol, rho_upsample=rho_upsample,
        window_origin=(x0.to(torch.float32), y0.to(torch.float32)),
        window_size=(rw, rh))

    # Feathered paste (static mask; the ramp hides the resolution seam).
    fy = torch.minimum(torch.arange(rh, dtype=torch.float32, device=dev),
                       torch.arange(rh - 1, -1, -1, dtype=torch.float32,
                                    device=dev))
    fx = torch.minimum(torch.arange(rw, dtype=torch.float32, device=dev),
                       torch.arange(rw - 1, -1, -1, dtype=torch.float32,
                                    device=dev))
    m = torch.clamp(torch.minimum(fy[:, None], fx[None, :]) / max(1, feather),
                    0.0, 1.0)[..., None]
    iy = (y0 + torch.arange(rh, device=dev))[:, None].long()
    ix = (x0 + torch.arange(rw, device=dev))[None, :].long()
    patch = bg[iy, ix]
    out = bg.index_put((iy, ix), patch + m * (img_roi - patch))
    stats = {"steps_per_ray":
             0.25 * st_bg["steps_per_ray"]
             + (rw * rh) / (width * height) * st_roi["steps_per_ray"],
             "mean_scale": st_roi["mean_scale"],
             "mean_skip": st_bg["mean_skip"],
             "expected_steps": st_bg["expected_steps"],
             "rect": (x0, y0, rw, rh)}
    return out, stats


# ------------------------------------------------------------------- training
def roi_weight_map(P_img: torch.Tensor, B_img: torch.Tensor,
                   beta: float = 4.0, gamma: float = 2.0) -> torch.Tensor:
    """Per-pixel weights w = 1 + beta*P + gamma*boundary (Methodology:59)."""
    return 1.0 + beta * P_img + gamma * B_img


def project_roi_maps(P: torch.Tensor, B: torch.Tensor, basis_vec,
                     p: BratsRenderParams, width: int, height: int,
                     n_steps: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max-project P/B along rays -> per-pixel ROI maps for weighting."""
    basis_vec, p = _on(P, basis_vec, p)
    dev = P.device
    ro, rd, t0, t1, valid, bmin = _ray_setup(unpack_basis(basis_vec), p,
                                             _dims(P.shape, dev), width,
                                             height)
    k = (torch.arange(n_steps, dtype=torch.float32, device=dev) + 0.5) \
        / n_steps
    t = t0[..., None] + k * (t1 - t0)[..., None]
    pos = ro[..., None, :] + t[..., None] * rd[..., None, :]
    pidx = (pos - bmin) / p.voxel_size
    P_img = torch.amax(trilinear_sample_base(P, pidx), dim=-1)
    B_img = torch.amax(trilinear_sample_base(B, pidx), dim=-1)
    m = valid.to(torch.float32)
    return P_img * m, B_img * m


def policy_loss(policy: Policy, scene, basis_vec, ref_img, p, width, height,
                n_coarse, n_fine, cfg: PolicyConfig, alpha: float = 0.0,
                w_img: Optional[torch.Tensor] = None, probe_stride: int = 1,
                lod_vol=None):
    """J = ROI-weighted image MSE + alpha * expected-steps cost
    (Methodology:51). ``scene`` = (mixed, feat_rows)."""
    mixed, feat_rows = scene
    img, stats = render_policy(policy, mixed, feat_rows, basis_vec, p, width,
                               height, n_coarse, n_fine, cfg,
                               probe_stride=probe_stride, lod_vol=lod_vol)
    err = torch.square(img - ref_img).mean(-1)
    if w_img is not None:
        err = err * w_img / torch.mean(w_img)
    return torch.mean(err) + alpha * stats["expected_steps"] / 1000.0, stats


def train_policy(generator: Optional[torch.Generator], scene, views, refs,
                 p, width, height, cfg: PolicyConfig = PolicyConfig(),
                 n_coarse: int = 32, n_fine: int = 64, steps: int = 200,
                 lr: float = 3e-4, alpha: float = 0.0,
                 weights: Optional[list] = None, probe_stride: int = 1,
                 extra_scenes: Optional[list] = None,
                 val_views: Optional[list] = None,
                 val_refs: Optional[list] = None,
                 val_weights: Optional[list] = None,
                 eval_every: int = 50, patience: int = 5,
                 init: Optional[Policy] = None,
                 lod_vols: Optional[list] = None,
                 val_budgets: Optional[Sequence[int]] = None):
    """AdamW + warmup-cosine + clip(1.0) (Methodology:52), on the scene's
    device; ``roi_policy.py:705-831``. ``views``/``refs``/``weights``:
    packed camera vectors, reference images and optional per-pixel ROI
    weight maps. ``generator`` seeds ``init_policy`` (unused with
    ``init``).

    ``extra_scenes``: (scene_tuple, p, views, refs, weights) tasks to
    round-robin alongside the primary scene. With ``val_views``/
    ``val_refs`` (held-out views of the primary scene), the validation
    ROI-wPSNR (mean over views and ``val_budgets``, default
    [max(8, n_fine // 2), n_fine]) is evaluated every ``eval_every`` steps;
    training stops after ``patience`` evaluations without improvement and
    the best checkpoint is returned. ``lod_vols``: per-task 2x mips (primary
    first): training renders with the LOD blend so the third output gets
    gradient.

    Returns ``(policy, losses, selection)``; ``selection`` records the
    selected step, the validation curve and whether early stop fired."""
    dev = scene[0].device
    policy = init_policy(generator, cfg, dev) if init is None \
        else {k: v.detach().to(dev, torch.float32) for k, v in init.items()}
    policy = {k: v.clone().requires_grad_(True) for k, v in policy.items()}
    sched = _warmup_cosine(0.0, lr, max(steps // 10, 1), steps, lr * 0.05)
    opt = ClippedOptimizer(
        torch.optim.AdamW(list(policy.values()), lr=sched(0),
                          betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4),
        sched, 1.0)

    val_lod = lod_vols[0] if lod_vols else None
    vb = tuple(val_budgets) if val_budgets else (max(8, n_fine // 2), n_fine)

    @torch.no_grad()
    def val_wpsnr(pol):
        ws = val_weights if val_weights is not None else [None] * len(val_views)
        qs = []
        for v, r, w in zip(val_views, val_refs, ws):
            for nf in vb:
                img, _ = render_policy(pol, scene[0], scene[1], v, p, width,
                                       height, n_coarse, nf, cfg,
                                       probe_stride=probe_stride,
                                       lod_vol=val_lod)
                err = torch.square(img - r).mean(-1)
                if w is not None:
                    err = err * w / _max(torch.mean(w), 1e-12)
                mse = _max(torch.mean(err), 1e-12)
                qs.append(-10.0 * torch.log10(mse))
        return float(torch.stack(qs).double().mean())

    tasks = [(scene, p, views, refs, weights)]
    if extra_scenes:
        tasks.extend(extra_scenes)
    lvs = (list(lod_vols) + [None] * (len(tasks) - len(lod_vols))
           if lod_vols else [None] * len(tasks))
    losses: List[torch.Tensor] = []
    use_val = bool(val_views) and bool(val_refs)
    snap = lambda: {k: v.detach().clone() for k, v in policy.items()}
    best_pol, best_q, best_step = snap(), -np.inf, 0
    curve, stall, early = [], 0, False
    steps_run = 0
    for s in range(steps):
        sc, sp, vs, rs, ws = tasks[s % len(tasks)]
        i = (s // len(tasks)) % len(vs)
        w = ws[i] if ws is not None else None
        opt.zero_grad()
        loss, _ = policy_loss(policy, sc, vs[i], rs[i], sp, width, height,
                              n_coarse, n_fine, cfg, alpha, w, probe_stride,
                              lod_vol=lvs[s % len(tasks)])
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        steps_run = s + 1
        if use_val and steps_run % eval_every == 0:
            q = val_wpsnr(policy)
            curve.append([steps_run, q])
            if q > best_q:
                best_pol, best_q, best_step = snap(), q, steps_run
                stall = 0
            else:
                stall += 1
            if stall >= patience:
                early = True
                break
    result = best_pol if use_val and best_step > 0 else snap()
    selection = {"selected_step": best_step if use_val else steps_run,
                 "best_val_wpsnr": best_q if use_val else None,
                 "val_wpsnr_curve": curve, "early_stopped": early,
                 "steps_run": steps_run, "eval_every": eval_every,
                 "patience": patience, "val_budgets": list(vb)}
    loss_list = torch.stack(losses).tolist() if losses else []
    return result, loss_list, selection


# --------------------------------------------------------------- persistence
def save_policy(path, policy: Policy, cfg: PolicyConfig = PolicyConfig(),
                meta: Optional[Dict] = None) -> None:
    """Export the policy as FP16 weights + JSON meta, in the JAX package's
    format (Methodology:54: row-major FP16 weights/biases, dims, activation
    flags)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: _np(v).astype(np.float16)
                      for k, v in policy.items()})
    n_out = int(policy["W2"].shape[-1])
    side = {"dims": [N_FEATURES, cfg.hidden, n_out], "activation": "relu",
            "outputs": ["dt_scale_sigmoid", "skip_sigmoid",
                        "lod_offset_2sigmoid_minus_1"][:n_out],
            "scale_range": [cfg.scale_min, cfg.scale_max],
            "layout": "row_major", "dtype": "float16", **(meta or {})}
    path.with_name(f"{path.stem}_meta.json").write_text(
        json.dumps(side, indent=2))


def load_policy(path, device="cpu") -> Policy:
    """A saved policy (``save_policy`` of either package) as float32
    tensors on ``device``."""
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k].astype(np.float32), device=device)
                for k in z.files}
