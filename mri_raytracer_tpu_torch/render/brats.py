"""User-facing BraTS volume renderer (port of ``render/brats.py:47-326``).

Owns the device-resident volumes; per frame the host passes a camera basis
and a params tuple, and the renderer caches everything camera-independent.

Backends:
  * 'sweep_cuda' — shear-warp sweep with the fused compositor: stage 1 in
                   PyTorch, then kernel K1 (``ops/composite``) and kernel K2
                   (``ops/warp``); the counterpart of 'sweep_pallas'
  * 'sweep'      — the same sweep with the plain scan compositor
                   (``ops/shearwarp.sweep_composite``)
  * 'oracle'     — the lockstep marcher (``ops/raymarch``), the golden
                   reference; the counterpart of 'xla'
  * 'auto'       — 'sweep_cuda' on a card, 'sweep' on the CPU
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mri_raytracer_tpu_torch.env import resolve_device
from mri_raytracer_tpu_torch.ops import raymarch, shearwarp
from mri_raytracer_tpu_torch.render.camera import CameraBasis, OrbitalCamera
from mri_raytracer_tpu_torch.render.params import BratsRenderParams
from mri_raytracer_tpu_torch.utils import profiling

_BACKENDS = ("auto", "sweep", "sweep_cuda", "oracle")
# (theta, phi) of the warm-up frames: one per sweep axis.
_WARMUP_POSES = ((0.0, math.pi / 2), (math.pi / 2, math.pi / 2), (0.0, 0.05))


class SweepFrame(NamedTuple):
    """Per-frame arguments of ``shearwarp.render_prepared``."""

    mixed_s: torch.Tensor
    seg_s: Optional[torch.Tensor]
    pred_s: Optional[torch.Tensor]
    basis: CameraBasis
    p: BratsRenderParams
    axis: int
    out_res: int
    use_gamma: bool
    use_clip: bool
    z_offset: Optional[int]
    nk_global: Optional[int]
    ab_offset: Optional[Tuple[int, int]]
    inplane_global: Optional[Tuple[int, int]]
    # The renderer's ``extra`` volumes, permuted and cropped like the rest;
    # not an argument of ``render_prepared``.
    extra_s: Optional[torch.Tensor] = None


def _resolve_backend(backend: str, device: torch.device) -> str:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {_BACKENDS}")
    if backend != "auto":
        return backend
    return "sweep_cuda" if device.type == "cuda" else "sweep"


class BratsRenderer:
    def __init__(self, mods, seg=None, pred=None, width: int = 1024,
                 height: int = 1024, max_steps: int = 1024,
                 backend: str = "auto", sweep_res: Optional[int] = None,
                 supersample: int = 1, extra=None, device=None):
        """``extra``: optional (M', X, Y, Z) float volumes that each frame
        carries permuted and cropped with the rest (``SweepFrame.extra_s``)
        and that are not rendered: the neural march's z-scored modalities."""
        self.device = resolve_device(device)
        self.sweep_res = sweep_res
        self.supersample = supersample
        self.mods = torch.as_tensor(mods, dtype=torch.float32,
                                    device=self.device)
        self.seg = None if seg is None else \
            torch.as_tensor(seg, device=self.device).to(torch.int32)
        self.pred = None if pred is None else \
            torch.as_tensor(pred, device=self.device).to(torch.int32)
        self.extra = None if extra is None else \
            torch.as_tensor(extra, dtype=torch.float32, device=self.device)
        # Host-side occupancy bounding box (any modality or label nonzero):
        # the sweep crops to it along ALL THREE axes when the transfer
        # function maps empty space to zero (content crop, exact by
        # construction).
        occ = torch.any(self.mods != 0.0, dim=0)
        if self.seg is not None:
            occ |= self.seg != 0
        occ = occ.cpu().numpy()
        self._occ_proj = [np.any(occ, axis=tuple(a for a in range(3)
                                                 if a != ax))
                          for ax in range(3)]
        self._refresh_bbox()
        self.width = int(width)
        self.height = int(height)
        self.max_steps = int(max_steps)
        self.backend = _resolve_backend(backend, self.device)
        if self.backend == "sweep_cuda" and supersample != 1:
            raise ValueError("backend 'sweep_cuda' samples integer planes "
                             "only (supersample=1)")
        self._p_cache = (None, None, None, None)
        self._prep_cache = {}  # (axis, crops, blend weights) -> volumes

    def _refresh_bbox(self) -> None:
        """Tight occupancy bbox per axis = base projections OR pred's."""
        pred = None if self.pred is None else (self.pred != 0).cpu().numpy()
        self._bbox = []
        for ax in range(3):
            proj = self._occ_proj[ax]
            if pred is not None:
                proj = proj | np.any(pred, axis=tuple(a for a in range(3)
                                                      if a != ax))
            nz = np.nonzero(proj)[0]
            if len(nz):
                self._bbox.append((int(nz[0]), int(nz[-1]) + 1))
            else:
                self._bbox.append((0, int(proj.shape[0])))

    @staticmethod
    def _crop16(lo: int, hi: int, n: int, guard: int = 4) -> tuple:
        """Pad a crop range to 16-slice granularity, keeping ``guard`` zero
        slices on BOTH sides (clamped at the volume edge): the guard keeps
        the crop-box faces in zero territory, since the sweep misses the
        ray segment between box entry and the first plane crossing (up to
        one spacing), and lands the closing plane's edge clamp on a zero
        slice."""
        return (max(0, lo - guard) // 16) * 16, \
            min(n, -(-(hi + guard) // 16) * 16)

    def _geometry(self, basis, params):
        """Host-side per-frame geometry: dominant sweep axis, content crop
        per permuted dim, and the intermediate resolution. The crop is
        exact whenever transfer(0) == 0 (wl >= ww/2)."""
        axis = shearwarp.dominant_axis(basis)
        order = shearwarp._ORDER[axis]
        dims_perm = [int(self.mods.shape[1 + o]) for o in order]
        crop_ok = float(params.wl) >= 0.5 * float(params.ww)
        if crop_ok:
            crops = [self._crop16(*self._bbox[o], dims_perm[i])
                     for i, o in enumerate(order)]
        else:
            crops = [(0, n) for n in dims_perm]
        base_res = self.sweep_res or max(self.width, self.height)
        out_res, inplane_cropped = shearwarp.crop_out_res(base_res, crops,
                                                          dims_perm)
        return axis, order, dims_perm, crops, out_res, inplane_cropped

    def frame_stats(self, basis, params) -> dict:
        """Static per-frame geometry for accounting: sweep axis, planes
        crossed (= max march steps per ray), intermediate resolution, crop
        extents. Pure host math."""
        axis, _, _, crops, out_res, _ = self._geometry(basis, params)
        (k_lo, k_hi), (a_lo, a_hi), (b_lo, b_hi) = crops
        return {
            "axis": axis,
            "out_res": out_res,
            "planes": (k_hi - k_lo) * self.supersample + 1,
            "crop_k": (k_lo, k_hi),
            "crop_a": (a_lo, a_hi),
            "crop_b": (b_lo, b_hi),
            "Na": a_hi - a_lo,
            "Nb": b_hi - b_lo,
            "has_seg": self.seg is not None,
            "has_pred": self.pred is not None,
        }

    @staticmethod
    def _params_key(params) -> tuple:
        """Value-based cache key over the leaf bytes (params are tiny)."""
        return tuple(leaf.detach().cpu().numpy().tobytes() for leaf in params)

    def _device_params(self, params):
        """Device copy of params + host flags, cached per params VALUE, so
        an unchanged params tuple costs no per-frame transfer."""
        key = self._params_key(params)
        if self._p_cache[0] != key:
            profiling.count("sweep.param_uploads")
            self._p_cache = (key, params.to(self.device),
                             *shearwarp.static_flags(params))
        return self._p_cache[1:]

    def sweep_frame(self, basis: CameraBasis, params) -> "SweepFrame":
        """Everything ``shearwarp.render_prepared`` needs for this frame
        besides the screen size and compositor: the cached prepared
        (cropped) volumes, device params, sweep axis and crop contract."""
        with profiling.span("sweep_frame"):
            p_dev, use_gamma, use_clip = self._device_params(params)
            axis, _, dims_perm, crops, out_res, inplane_cropped = \
                self._geometry(basis, params)
            nk, na_g, nb_g = dims_perm
            (k_lo, k_hi), (a_lo, _), (b_lo, _) = crops
            # Blended+permuted volumes are camera-independent: cache per
            # (axis, crop, blend weights); invalidated by set_prediction.
            blend_key = (axis, tuple(crops),
                         params.vol_enabled.cpu().numpy().tobytes(),
                         params.vol_weight.cpu().numpy().tobytes())
            vols = self._prep_cache.get(blend_key)
            if vols is None:
                profiling.count("sweep.prep_misses")
                with profiling.span("prepare"):
                    vols = self._prepare(p_dev, axis, crops, dims_perm)
                self._prep_cache[blend_key] = vols
            mixed_s, seg_s, pred_s, extra_s = vols
            slab = (k_lo, k_hi) != (0, nk)
            return SweepFrame(
                mixed_s, seg_s, pred_s, basis.to(self.device), p_dev, axis,
                out_res, use_gamma, use_clip, z_offset=k_lo if slab else None,
                nk_global=nk if slab else None,
                ab_offset=(a_lo, b_lo) if inplane_cropped else None,
                inplane_global=(na_g, nb_g) if inplane_cropped else None,
                extra_s=extra_s)

    def _prepare(self, p_dev, axis: int, crops, dims_perm) -> tuple:
        """The blended, permuted and cropped volumes of one sweep axis
        (and the ``extra`` volumes alike)."""
        extra_s = None if self.extra is None else torch.stack(
            [shearwarp._perm_volume(v, axis) for v in self.extra])
        vols = (*shearwarp.prepare_sweep_volumes(
            self.mods, self.seg, self.pred, p_dev, axis), extra_s)
        for dim, (lo, hi) in enumerate(crops):
            if (lo, hi) != (0, dims_perm[dim]):
                # The crop applies to each volume's last three dims.
                vols = tuple(None if v is None
                             else v.narrow(v.dim() - 3 + dim, lo, hi - lo)
                             for v in vols)
        return tuple(None if v is None else v.contiguous() for v in vols)

    def _render_sweep(self, basis: CameraBasis, params, echo=None
                      ) -> torch.Tensor:
        frame = self.sweep_frame(basis, params)._asdict()
        del frame["extra_s"]
        return shearwarp.render_prepared(
            width=self.width, height=self.height,
            supersample=self.supersample,
            composite="fused" if self.backend == "sweep_cuda" else "scan",
            echo=echo, **frame)

    def warmup(self, params: BratsRenderParams) -> None:
        """One frame per sweep axis, at the three poses of the JAX
        package's ``shearwarp.warmup_window_variants`` (face-x, face-y,
        top; ``shearwarp.py:1042-1046``): builds the kernels and fills the
        prepared-volume cache of every axis before the first interactive
        frame, so an orbit never stalls when the dominant axis flips. The
        port's warp has no window ladder to walk."""
        for theta, phi in _WARMUP_POSES:
            cam = OrbitalCamera(radius=2.0, theta=theta, phi=phi)
            out = self.render(cam.basis(), params)
        profiling.sync(out)

    def set_prediction(self, pred) -> None:
        """Upload an INR prediction volume (reference 'Load INR & Predict')."""
        self.pred = None if pred is None else \
            torch.as_tensor(pred, device=self.device).to(torch.int32)
        self._prep_cache.clear()  # prepared volumes embed pred
        self._refresh_bbox()  # pred content may extend the crop box

    def render(self, basis: CameraBasis, params: BratsRenderParams,
               _echo=None) -> torch.Tensor:
        """(H, W, 3) float32 frame on the renderer's device. ``basis`` on
        the CPU (``OrbitalCamera.basis()``) keeps the frame free of device
        syncs: the sweep axis is read from it on the host. ``_echo``:
        internal, the fused compositor's instrumentation channel (returns
        its payload instead of an image; see ``executed_planes``)."""
        with profiling.frame():
            if self.backend == "oracle":
                if _echo is not None:
                    raise ValueError("echo instrumentation requires the "
                                     "fused compositor")
                return raymarch.render_brats(self.mods, self.seg, self.pred,
                                             basis, params, self.width,
                                             self.height, self.max_steps,
                                             device=self.device)
            return self._render_sweep(basis, params, _echo)

    def executed_planes(self, basis: CameraBasis,
                        params: BratsRenderParams) -> np.ndarray:
        """Exact per-pixel executed-plane counts of this frame, (out_res,
        out_res) int32, from K1c (the fused compositor with its counter):
        the static plane budget (``frame_stats['planes']``) is an upper
        bound, since the content box, the gates and the T <= 0.01 exit skip
        planes, and this counts what ran. ``utils.arith.frame_flops`` uses
        it. Backend 'sweep_cuda' only (on CPU tensors its plain version)."""
        if self.backend != "sweep_cuda":
            raise RuntimeError("executed_planes requires the fused backend "
                               f"'sweep_cuda' (current: {self.backend})")
        return self.render(basis, params, _echo="planes").cpu().numpy()

    def render_numpy(self, basis: CameraBasis, params: BratsRenderParams
                     ) -> np.ndarray:
        with profiling.frame():
            return present(self.render(basis, params))


def present(img: torch.Tensor) -> np.ndarray:
    """A frame's pixels on the host: the device-to-host copy that ends
    every ``render_numpy``."""
    with profiling.span("present"):
        return img.cpu().numpy()


def orbit_frames(renderer: BratsRenderer, params: BratsRenderParams,
                 camera: OrbitalCamera, n_frames: int = 36,
                 d_theta: float = 0.1745) -> np.ndarray:
    """(N, H, W, 3) turntable orbit — the offline stand-in for the
    reference's 60 Hz window loop."""
    frames = []
    for _ in range(n_frames):
        camera.orbit(d_theta, 0.0)
        frames.append(renderer.render_numpy(camera.basis(), params))
    return np.stack(frames)
