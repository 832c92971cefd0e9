"""Inverse rendering: fit an INR field from rendered multi-modal views (port
of ``train/fit_views.py``; reference phase-3 goal, ``docs/Goals.md:36-39,
257`` + ``docs/DifferentiableRendering.md:133-148``).

Two fits, each from nothing but 2-D renders of a synthetic BraTS-like
volume:

  * ``run`` / ``fit_from_views``: an RFF + ReLU MLP radiance field (sigma
    a scaled sigmoid inside the unit box, a sigmoid 3-modality emission)
    trained on random pixel batches through the differentiable marcher
    (``ops/diffrender``) with inverse-CDF coarse-to-fine importance
    sampling (``ops/importance``); the targets are emission-absorption
    renders whose colour channels are three raw modalities;
  * ``run_shearwarp`` / ``fit_views_shearwarp``: an RFF + MLP intensity
    field baked differentiably to the voxel grid each step and rendered by
    the production shear-warp renderer (``composite='scan_remat'``); the
    image MSE backpropagates through bake + sweep + gather warp.

Both use Adam (``torch.optim.Adam``, optax.adam's b1 0.9, b2 0.999, eps
1e-8) under optax's cosine decay read at the update count before each
update (``train.optimizers._cosine``). Ray and view draws come from an
explicit ``torch.Generator`` seeded from ``seed``: JAX's key stream cannot
be matched, so a whole run agrees with JAX's by its PSNR bars, and a step
agrees with JAX's when both are fed the same draws. Evaluation renders the
recovered field at full resolution from the train and held-out poses and
reports PSNR.

The fits train their field in place and return it. Entry points run on
``cuda`` unless ``device`` names another.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mri_raytracer_tpu_torch.data import synthetic
from mri_raytracer_tpu_torch.data.brats import percentile_normalize
from mri_raytracer_tpu_torch.env import resolve_device
from mri_raytracer_tpu_torch.models.features import init_rff
from mri_raytracer_tpu_torch.models.mlp import RffField, count_params, init_mlp
from mri_raytracer_tpu_torch.ops import diffrender as dr
from mri_raytracer_tpu_torch.ops import importance as imp
from mri_raytracer_tpu_torch.ops import shearwarp as sw
from mri_raytracer_tpu_torch.ops.trilinear import trilinear_sample
from mri_raytracer_tpu_torch.render import params as rp
from mri_raytracer_tpu_torch.render.camera import (CameraBasis, OrbitalCamera,
                                                   camera_rays)
from mri_raytracer_tpu_torch.train.optimizers import _cosine

_F32 = torch.float32
# The marcher fit's ray interval: orbit radius 2.6 against a unit-box scene.
T0, T1 = 0.9, 4.3


def _adam(params: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """optax.adam's constants."""
    return torch.optim.Adam(params.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def _update(opt: torch.optim.Optimizer, loss: torch.Tensor, lr: float
            ) -> None:
    """One update at the schedule's ``lr`` for this count."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


def _display_case(shape, seed: int, device) -> torch.Tensor:
    """The synthetic case's modalities, percentile-normalized (M,X,Y,Z)."""
    mods, _ = synthetic.synthetic_case(shape, seed=seed)
    return torch.as_tensor(np.stack([percentile_normalize(m) for m in mods]),
                           dtype=_F32, device=device)


# ----------------------------------------------------------------- target
def make_target_field(mods_disp: torch.Tensor, sigma_scale: float = 6.0):
    """Ground-truth multi-modal field from a display-normalized (M,X,Y,Z)
    volume stack: sigma = scale * trilinear(blend of all modalities),
    rgb = trilinear of modalities 0..2. World frame: volume centered at the
    origin in [-1, 1]^3 (longest axis)."""
    shape = tuple(mods_disp.shape[1:])
    n = max(shape)
    dev = mods_disp.device
    vol_min = -torch.tensor(shape, dtype=_F32, device=dev) / n
    voxel = torch.full((3,), 2.0 / n, dtype=_F32, device=dev)
    blend = torch.mean(mods_disp, dim=0)

    def field(x):
        pidx = (x - vol_min) / voxel
        sigma = sigma_scale * trilinear_sample(blend, pidx)
        rgb = torch.stack([trilinear_sample(mods_disp[c], pidx)
                           for c in range(3)], dim=-1)
        return sigma, rgb

    return field


def make_orbit_bases(n_views: int, radius: float = 2.6, phi: float = 1.15,
                     phase: float = 0.0, fov_y: float = 0.9
                     ) -> List[CameraBasis]:
    """Evenly-spaced orbit poses (host-side bases on the CPU); ``phase``
    shifts the orbit so held-out views are disjoint from training views."""
    bases = []
    for i in range(n_views):
        theta = phase + 2.0 * np.pi * i / n_views
        cam = OrbitalCamera(radius=radius, theta=theta,
                            phi=phi + 0.25 * np.sin(3.1 * i), fov_y=fov_y)
        bases.append(cam.basis())
    return bases


def _rows(render: Callable, bases, res: int, row_chunk: int, device
          ) -> np.ndarray:
    """(V, res, res, 3) of ``render(ro, rd)`` over row chunks of each
    view's rays, without grad."""
    views = []
    with torch.no_grad():
        for basis in bases:
            ro, rd = camera_rays(basis.to(device), res, res)
            views.append(torch.cat([render(ro[r:r + row_chunk],
                                           rd[r:r + row_chunk])
                                    for r in range(0, res, row_chunk)])
                         .cpu().numpy())
    return np.stack(views)


def render_target_views(field, bases, res: int, t0: float, t1: float,
                        n_samples: int = 192, row_chunk: int = 64,
                        device=None) -> np.ndarray:
    """(V, res, res, 3) reference renders, row-chunked to bound memory."""
    return _rows(lambda ro, rd: dr.render_field(field, ro, rd, t0, t1,
                                                n_samples).rgb,
                 bases, res, row_chunk, resolve_device(device))


# ------------------------------------------------------------------- model
def init_inr_field(generator: torch.Generator, rff_dim: int = 96,
                   rff_sigma: float = 1.6,
                   hidden: Sequence[int] = (128, 128, 128, 128)) -> RffField:
    """RFF + MLP radiance field (sigma + 3 emissions): B (3, F), then the
    MLP (2F -> hidden -> 4), both drawn from ``generator``."""
    B = init_rff(generator, 3, rff_dim, rff_sigma)
    return RffField(B, init_mlp(generator, 2 * rff_dim, hidden, 4))


def make_inr_field(params: RffField, sigma_scale: float = 6.0):
    def field(x):
        o = params(x)
        sigma = sigma_scale * torch.sigmoid(o[..., 0])
        # Support bound: the scene is the volume box ([-1,1]^3 on the
        # longest axis) and the target field is identically zero outside
        # it. Without this mask the MLP is free to hallucinate density in
        # the (train-ray-unsupervised) shell between the box and a NOVEL
        # camera, which occludes the scene and collapses held-out PSNR
        # while train views still fit.
        inside = torch.all(torch.abs(x) <= 1.0, dim=-1)
        sigma = sigma * inside.to(sigma.dtype)
        rgb = torch.sigmoid(o[..., 1:4])
        return sigma, rgb

    return field


def _coarse_to_fine(field, ro, rd, t0, t1, n_coarse, n_fine):
    """The fit's renderer: a coarse probe of the live field's own density
    (no grad: the fine march already differentiates through sample
    PLACEMENT via the inverse CDF; probing gradients add cost, not signal),
    inverse-CDF fine placement, the fine march."""
    def importance_fn(x):
        with torch.no_grad():
            s, _ = field(x)
        return s + 1e-3

    C, _, _ = imp.coarse_to_fine_render(field, importance_fn, ro, rd, t0, t1,
                                        n_coarse=n_coarse, n_fine=n_fine)
    return C


# ---------------------------------------------------------------- training
def _draw_rays(generator: torch.Generator, n: int, batch: int
               ) -> torch.Tensor:
    """A step's ray indices, uniform over every pixel of every view."""
    return torch.randint(0, n, (batch,), generator=generator,
                         device=generator.device)


def build_fit_step(params: RffField, all_ro, all_rd, all_tg, t0: float,
                   t1: float, steps: int, lr: float, n_coarse: int,
                   n_fine: int, sigma_scale: float) -> Callable:
    """``step(idx, count) -> loss``: one Adam update of the marcher fit on
    the rays ``idx`` at the schedule's lr for ``count``; the loss is the
    batch's image MSE before the update."""
    sched = _cosine(lr, steps, alpha=0.02)
    opt = _adam(params, sched(0))
    field = make_inr_field(params, sigma_scale)

    def step(idx: torch.Tensor, count: int) -> torch.Tensor:
        C = _coarse_to_fine(field, all_ro[idx], all_rd[idx], t0, t1,
                            n_coarse, n_fine)
        loss = torch.mean((C - all_tg[idx]) ** 2)
        _update(opt, loss, sched(count))
        return loss.detach()

    return step


def fit_from_views(targets: np.ndarray, bases, t0: float, t1: float,
                   steps: int = 2500, batch_rays: int = 4096,
                   n_coarse: int = 48, n_fine: int = 96, lr: float = 3e-3,
                   sigma_scale: float = 6.0, seed: int = 0,
                   params: Optional[RffField] = None, log_every: int = 250,
                   log_fn=print, device=None) -> Tuple[RffField, List[float]]:
    """Optimize the INR from target images only. Returns (params, losses):
    ``params`` (drawn from ``seed`` unless given) trained in place on
    ``device``, the loss at every ``log_every``-th step and the last."""
    dev = resolve_device(device)
    if params is None:
        params = init_inr_field(torch.Generator().manual_seed(seed))
    params = params.to(dev)
    V, R = targets.shape[0], targets.shape[1]
    rays = [camera_rays(b.to(dev), R, R) for b in bases]
    all_ro = torch.stack([o for o, _ in rays]).reshape(V * R * R, 3)
    all_rd = torch.stack([d for _, d in rays]).reshape(V * R * R, 3)
    all_tg = torch.as_tensor(np.asarray(targets), dtype=_F32,
                             device=dev).reshape(V * R * R, 3)
    step = build_fit_step(params, all_ro, all_rd, all_tg, t0, t1, steps, lr,
                          n_coarse, n_fine, sigma_scale)
    gen = torch.Generator(device=dev).manual_seed(seed)
    losses = []
    for it in range(steps):
        loss = step(_draw_rays(gen, V * R * R, batch_rays), it)
        if it % log_every == 0 or it == steps - 1:
            lval = float(loss)
            losses.append(lval)
            log_fn(f"[fit] step {it}/{steps} loss {lval:.3e}")
    return params, losses


def render_inr_views(params: RffField, bases, res: int, t0: float, t1: float,
                     n_coarse: int = 48, n_fine: int = 96,
                     sigma_scale: float = 6.0,
                     row_chunk: int = 64) -> np.ndarray:
    """Recovered renders with the SAME coarse-to-fine sampler used in
    training (V, res, res, 3), on the params' device."""
    field = make_inr_field(params, sigma_scale)
    return _rows(lambda ro, rd: _coarse_to_fine(field, ro, rd, t0, t1,
                                                n_coarse, n_fine),
                 bases, res, row_chunk, params.B.device)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 10.0 * float(np.log10(1.0 / max(mse, 1e-12)))


# ------------------------------------- fitting THROUGH the fast renderer
def init_modality_inr(generator: torch.Generator, n_mods: int = 4,
                      rff_dim: int = 96, rff_sigma: float = 1.6,
                      hidden: Sequence[int] = (128, 128, 128)) -> RffField:
    """RFF + MLP predicting per-modality display intensities."""
    B = init_rff(generator, 3, rff_dim, rff_sigma)
    return RffField(B, init_mlp(generator, 2 * rff_dim, hidden, n_mods))


def bake_modalities(params: RffField, shape, chunk: int = 8192
                    ) -> torch.Tensor:
    """Differentiably evaluate the INR on the full voxel grid ->
    (M, X, Y, Z) display volumes on the params' device. Coordinates use the
    training convention (index / max-dim in [0, 1)); each chunk of
    ``chunk`` voxels (the last zero-padded) runs under
    ``torch.utils.checkpoint``, which keeps the bake's backward memory at
    O(chunk)."""
    X, Y, Z = shape
    n = float(max(shape))
    dev = params.B.device
    ii, jj, kk = torch.meshgrid(*(torch.arange(d, device=dev)
                                  for d in (X, Y, Z)), indexing="ij")
    coords = torch.stack([ii, jj, kk], -1).reshape(-1, 3).to(_F32) / n
    coords = F.pad(coords, (0, 0, 0, (-coords.shape[0]) % chunk))

    def block(c):
        return torch.sigmoid(params(c))

    out = torch.cat([checkpoint(block, c, use_reentrant=False)
                     for c in coords.split(chunk)])[: X * Y * Z]
    return out.reshape(X, Y, Z, -1).permute(3, 0, 1, 2)


def _draw_views(generator: torch.Generator, group: Sequence[int], k: int
                ) -> List[int]:
    """A step's views: ``k`` of ``group``, with replacement."""
    pick = torch.randint(0, len(group), (k,), generator=generator)
    return [group[i] for i in pick.tolist()]


def build_shearwarp_step(params: RffField, bases: Sequence[CameraBasis],
                         targets: torch.Tensor, p, shape, out_res: int,
                         steps: int, lr: float) -> Callable:
    """``step(idx, axis, count) -> loss``: one Adam update of the
    shear-warp fit on the views ``idx`` (all swept along ``axis``) at the
    schedule's lr for ``count``. The loss, the mean over the views of each
    full frame's MSE, is taken before the update."""
    sched = _cosine(lr, steps, alpha=0.05)
    opt = _adam(params, sched(0))
    R = targets.shape[1]

    def step(idx: Sequence[int], axis: int, count: int) -> torch.Tensor:
        # The step's views share the sweep axis, so the baked volume is
        # blended and permuted once for all of them.
        vols = sw.prepare_sweep_volumes(bake_modalities(params, shape), None,
                                        None, p, axis)
        errs = [torch.mean((sw.render_prepared(
            *vols, bases[i], p, axis, R, R, out_res, use_gamma=False,
            use_clip=False, composite="scan_remat") - targets[i]) ** 2)
            for i in idx]
        loss = torch.mean(torch.stack(errs))
        _update(opt, loss, sched(count))
        return loss.detach()

    return step


def fit_views_shearwarp(targets: np.ndarray, bases, p, shape,
                        out_res: int = 128, steps: int = 300,
                        views_per_step: int = 2, lr: float = 2e-3,
                        seed: int = 0, params: Optional[RffField] = None,
                        log_every: int = 25, log_fn=print, device=None
                        ) -> Tuple[RffField, List[float]]:
    """Fit the INR against images rendered by the PRODUCTION shear-warp
    renderer (``composite='scan_remat'``): each step differentiably bakes
    the INR to the full voxel grid, renders full frames through the sweep,
    and backprops the image MSE through bake + sweep + warp. The sweep
    axis selects the volume permutation, so views are grouped by
    ``dominant_axis`` and step ``it`` draws its views from group
    ``it % n_groups``; the step's views run one after another (JAX vmaps
    them)."""
    dev = resolve_device(device)
    if params is None:
        params = init_modality_inr(torch.Generator().manual_seed(seed))
    params = params.to(dev)
    groups: Dict[int, List[int]] = {}
    for i, b in enumerate(bases):
        groups.setdefault(sw.dominant_axis(b), []).append(i)
    axes = sorted(groups)
    tg = torch.as_tensor(np.asarray(targets), dtype=_F32, device=dev)
    step = build_shearwarp_step(params, [b.to(dev) for b in bases], tg,
                                p.to(dev), shape, out_res, steps, lr)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for it in range(steps):
        axis = axes[it % len(axes)]
        loss = step(_draw_views(gen, groups[axis], views_per_step), axis, it)
        if it % log_every == 0 or it == steps - 1:
            lval = float(loss)
            losses.append(lval)
            log_fn(f"[fit-sw] step {it}/{steps} axis {axis} "
                   f"loss {lval:.3e}")
    return params, losses


def _psnrs(rec: np.ndarray, tg: np.ndarray) -> List[float]:
    return [psnr(r, t) for r, t in zip(rec, tg)]


def run_shearwarp(shape=(64, 64, 64), res: int = 256, out_res: int = 128,
                  n_train_views: int = 16, n_held_views: int = 4,
                  steps: int = 300, views_per_step: int = 2, seed: int = 0,
                  log_fn=print, device=None) -> Dict:
    """Inverse rendering with the PRODUCTION renderer end to end: targets,
    loss, and evaluation all use ``shearwarp.render_brats`` ('scan' for
    targets and evaluation, 'scan_remat' in the loss). The record has the
    JAX package's keys plus ``wall_s_render`` (the evaluation) and
    ``_params`` (the trained field)."""
    dev = resolve_device(device)
    disp = _display_case(shape, seed, dev)
    p = rp.default_render_params(shape, show_seg=False)
    radius = rp.default_camera_radius(p, shape)
    bases_tr = make_orbit_bases(n_train_views, radius=radius)
    bases_ho = make_orbit_bases(n_held_views, radius=radius,
                                phase=np.pi / n_train_views, phi=1.3)

    def render_views(vols, bases):
        with torch.no_grad():
            return np.stack([sw.render_brats(
                vols, None, None, b, p, res, res, out_res=out_res,
                composite="scan", device=dev).cpu().numpy() for b in bases])

    t_start = time.perf_counter()
    tg_tr = render_views(disp, bases_tr)
    tg_ho = render_views(disp, bases_ho)
    t_targets = time.perf_counter() - t_start

    t_start = time.perf_counter()
    params, losses = fit_views_shearwarp(
        tg_tr, bases_tr, p, shape, out_res=out_res, steps=steps,
        views_per_step=views_per_step, seed=seed, log_fn=log_fn, device=dev)
    t_fit = time.perf_counter() - t_start

    t_start = time.perf_counter()
    with torch.no_grad():
        baked = bake_modalities(params, shape)
    rec_tr = render_views(baked, bases_tr)
    rec_ho = render_views(baked, bases_ho)
    t_render = time.perf_counter() - t_start

    psnr_tr = _psnrs(rec_tr, tg_tr)
    psnr_ho = _psnrs(rec_ho, tg_ho)
    return {
        "renderer": "shearwarp", "shape": list(shape), "res": res,
        "out_res": out_res, "n_train_views": n_train_views,
        "n_held_views": n_held_views, "steps": steps,
        "views_per_step": views_per_step,
        "n_params": count_params(params.mlp),
        "losses": losses,
        "psnr_train_mean": float(np.mean(psnr_tr)),
        "psnr_train_min": float(np.min(psnr_tr)),
        "psnr_heldout_mean": float(np.mean(psnr_ho)),
        "psnr_heldout_min": float(np.min(psnr_ho)),
        "wall_s_targets": round(t_targets, 1),
        "wall_s_fit": round(t_fit, 1),
        "wall_s_render": round(t_render, 1),
        "volume_psnr_db": psnr(baked.cpu().numpy(), disp.cpu().numpy()),
        "_recovered": rec_tr, "_targets": tg_tr,
        "_recovered_ho": rec_ho, "_targets_ho": tg_ho,
        "_params": params,
    }


def run(shape=(64, 64, 64), res: int = 256, n_train_views: int = 16,
        n_held_views: int = 4, steps: int = 2500, batch_rays: int = 4096,
        n_coarse: int = 48, n_fine: int = 96, seed: int = 0,
        log_fn=print, device=None) -> Dict:
    """End-to-end marcher protocol; returns the result record (the JAX
    package's keys plus ``_params``, the trained field)."""
    dev = resolve_device(device)
    target_field = make_target_field(_display_case(shape, seed, dev))
    bases_tr = make_orbit_bases(n_train_views)
    bases_ho = make_orbit_bases(n_held_views,
                                phase=np.pi / n_train_views, phi=1.3)

    t_start = time.perf_counter()
    tg_tr = render_target_views(target_field, bases_tr, res, T0, T1,
                                device=dev)
    tg_ho = render_target_views(target_field, bases_ho, res, T0, T1,
                                device=dev)
    t_targets = time.perf_counter() - t_start

    t_start = time.perf_counter()
    params, losses = fit_from_views(tg_tr, bases_tr, T0, T1, steps=steps,
                                    batch_rays=batch_rays,
                                    n_coarse=n_coarse, n_fine=n_fine,
                                    seed=seed, log_fn=log_fn, device=dev)
    t_fit = time.perf_counter() - t_start

    t_start = time.perf_counter()
    rec_tr = render_inr_views(params, bases_tr, res, T0, T1,
                              n_coarse=n_coarse, n_fine=n_fine)
    rec_ho = render_inr_views(params, bases_ho, res, T0, T1,
                              n_coarse=n_coarse, n_fine=n_fine)
    t_render = time.perf_counter() - t_start

    psnr_tr = _psnrs(rec_tr, tg_tr)
    psnr_ho = _psnrs(rec_ho, tg_ho)
    return {
        "shape": list(shape), "res": res,
        "n_train_views": n_train_views, "n_held_views": n_held_views,
        "steps": steps, "batch_rays": batch_rays,
        "n_coarse": n_coarse, "n_fine": n_fine,
        "n_params": count_params(params.mlp),
        "losses": losses,
        "psnr_train_mean": float(np.mean(psnr_tr)),
        "psnr_train_min": float(np.min(psnr_tr)),
        "psnr_heldout_mean": float(np.mean(psnr_ho)),
        "psnr_heldout_min": float(np.min(psnr_ho)),
        "wall_s_targets": round(t_targets, 1),
        "wall_s_fit": round(t_fit, 1),
        "wall_s_render": round(t_render, 1),
        "_recovered": rec_tr, "_targets": tg_tr,
        "_recovered_ho": rec_ho, "_targets_ho": tg_ho,
        "_params": params,
    }
