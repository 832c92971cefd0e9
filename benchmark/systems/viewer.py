"""The BraTS viewer: the system the ``brats_*`` configurations run.

The timed call is the viewer's own entry point, ``render_numpy(basis,
params)``: ``BratsRenderer`` (backend ``sweep_cuda``: stage 1, kernel K1
with the label rows, kernel K2) for the ground-truth overlay, and
``NeuralBratsRenderer`` (backend ``fused``: the INR's strided field, stage
1, K1 with the field, K2) for the live INR (mode 2). Each call returns the
frame's float32 pixels on the host, as ``render/widgets.OrbitViewer.frame``
and the viewer CLI take them.

The case comes from ``benchmark/case.py`` and the INR's weights from the
same seed, both drawn on the device; the reference (``benchmark/reference``)
makes both again from the seed, after the program is gone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import case as case_mod
from benchmark import counts, orbit
from benchmark.reference import field as ref_field
from benchmark.reference import frame as ref_frame
from benchmark.reference import geometry as ref_geom

# (theta, phi) of the warm-up frames, one per sweep axis (face-x, face-y,
# top), the poses of ``render/brats.BratsRenderer.warmup``.
WARMUP_POSES = ((0.0, math.pi / 2), (math.pi / 2, math.pi / 2), (0.0, 0.05))


def geometry_params(cfg: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """(voxel, vol_min) of the box, float32 (``make_params``' rule)."""
    dims = np.asarray(cfg["shape"], np.float32)
    zooms = np.asarray(cfg["render"]["voxel_mm"], np.float32)
    voxel = (zooms * (cfg["render"]["world_extent"] / float(dims.max()))) \
        .astype(np.float32)
    return voxel, (-0.5 * voxel * dims).astype(np.float32)


def camera_radius(cfg: Dict) -> float:
    voxel, _ = geometry_params(cfg)
    return orbit.camera_radius(voxel, cfg["shape"])


def inr_weights(cfg: Dict, seed: int, device) -> List[Tuple[torch.Tensor,
                                                             torch.Tensor]]:
    """The INR's dense layers [(W (in, out), b (out,))] at the published
    widths, Glorot-uniform W and zero b (``models/mlp.init_mlp``'s
    scheme), drawn from the seed on the device in one call."""
    widths = counts.inr_widths(cfg["model"], len(cfg["modalities"]))
    shapes = list(zip(widths[:-1], widths[1:]))
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + 0x1F2E3D) % (1 << 63))
    u = torch.rand(sum(a * b for a, b in shapes), generator=gen,
                   device=device)
    layers, at = [], 0
    for a, b in shapes:
        limit = math.sqrt(6.0 / (a + b))
        W = (u[at:at + a * b].reshape(a, b) * 2.0 - 1.0) * limit
        layers.append((W.contiguous(), torch.zeros(b, device=device)))
        at += a * b
    return layers


def cam_tensors(cam, device):
    eye, right, up, fwd, fov = cam
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return t(eye), t(right), t(up), t(fwd), t(fov)


class Viewer:
    """The program under test: one renderer, one orbit, one client."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from mri_raytracer_tpu_torch.render import params as rp

        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)
        self.width, self.height = traffic["width"], traffic["height"]
        self.radius = camera_radius(cfg)
        inputs = case_mod.make_case(cfg["shape"], seed, self.device,
                                    len(cfg["modalities"]))
        r = cfg["render"]
        self.params = rp.default_render_params(
            cfg["shape"], voxel_zooms=r["voxel_mm"],
            world_extent=r["world_extent"], step_size=r["step_size"],
            show_seg=r["show_seg"], show_pred=r["show_pred"],
            vol_enabled=r["vol_enabled"], vol_weight=r["vol_weight"],
            ww=r["ww"], wl=r["wl"], intensity_alpha=r["intensity_alpha"],
            gamma=r["gamma"], near=r["near"], far=r["far"],
            bg_color=r["bg_color"], lut=np.asarray(r["lut"], np.float32))
        self.renderer = self._renderer(inputs, seed)
        del inputs

    def _renderer(self, inputs, seed):
        cfg = self.cfg
        if cfg["overlay"] == "seg":
            from mri_raytracer_tpu_torch.render.brats import BratsRenderer

            return BratsRenderer(inputs["mods_disp"], inputs["seg"], None,
                                 width=self.width, height=self.height,
                                 backend=cfg["backend"],
                                 sweep_res=cfg.get("sweep_res"),
                                 device=self.device)
        from mri_raytracer_tpu_torch.config import ModelConfig
        from mri_raytracer_tpu_torch.models.api import build_model
        from mri_raytracer_tpu_torch.models.mlp import MLP, Dense
        from mri_raytracer_tpu_torch.ops.neural_march import \
            NeuralBratsRenderer

        m = cfg["model"]
        model = build_model(ModelConfig(
            kind="mlp", hidden_dims=tuple(m["hidden_dims"]),
            num_classes=m["num_classes"], fourier_freqs=m["fourier_freqs"]),
            len(cfg["modalities"]))
        params = MLP(Dense(W, b) for W, b in
                     inr_weights(cfg, seed, self.device))
        return NeuralBratsRenderer(
            inputs["mods_disp"], inputs["mods_z"], inputs["seg"], model,
            params, width=self.width, height=self.height,
            pred_stride=m["pred_stride"], backend=cfg["backend"],
            sweep_res=cfg.get("sweep_res"), device=self.device)

    def basis(self, cam):
        from mri_raytracer_tpu_torch.render.camera import CameraBasis

        return CameraBasis(*cam_tensors(cam, "cpu"))

    def request(self, i: int):
        """Frame ``i``'s arguments, made before its call is timed."""
        return self.basis(orbit.frame_basis(self.traffic["orbit"], i,
                                            self.radius))

    def serve(self, basis) -> np.ndarray:
        """The timed call: the frame's pixels on the host."""
        return self.renderer.render_numpy(basis, self.params)

    def warmup(self) -> None:
        fov = math.radians(self.traffic["orbit"]["fov_deg"])
        for theta, phi in WARMUP_POSES:
            self.serve(self.basis(orbit.basis(theta, phi, self.radius, fov)))

    def close(self) -> None:
        del self.renderer


class Reference:
    """The plain reference's frames of a cell, from the seed alone."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)
        self.width, self.height = traffic["width"], traffic["height"]
        self.radius = camera_radius(cfg)
        inputs = case_mod.make_case(cfg["shape"], seed, self.device,
                                    len(cfg["modalities"]))
        self.p = ref_geom.make_params(cfg["shape"], cfg["render"],
                                      self.device)
        self.mods = inputs["mods_disp"]
        self.seg = inputs["seg"]
        self.inr = cfg["overlay"] == "inr"
        self.modsz = inputs["mods_z"] if self.inr else None
        self.layers = inr_weights(cfg, seed, self.device) if self.inr \
            else None
        self.box = ref_geom.content_box(self.mods, self.seg)
        self.use_gamma = abs(float(self.p.gamma) - 1.0) > 1e-12
        self.use_clip = float(self.p.near) > 0.0 or float(self.p.far) > 0.0
        self._vols = {}

    def cam(self, i: int):
        """The camera of the orbit's frame ``i``."""
        return orbit.frame_basis(self.traffic["orbit"], i, self.radius)

    def volumes(self, fr: ref_geom.Frame):
        """(mixed, seg, z-scored) volumes permuted to the frame's axis and
        cropped, made once per axis."""
        if fr.axis not in self._vols:
            mixed = ref_geom.blend(self.mods, self.p.vol_enabled,
                                   self.p.vol_weight)
            vols = [ref_geom.crop_volume(ref_geom.perm_volume(mixed, fr.axis),
                                         fr.crops),
                    ref_geom.crop_volume(ref_geom.perm_volume(self.seg,
                                                              fr.axis),
                                         fr.crops)]
            vols.append(None if self.modsz is None else ref_geom.crop_volume(
                ref_geom.perm_volume(self.modsz, fr.axis), fr.crops))
            self._vols[fr.axis] = tuple(vols)
        return self._vols[fr.axis]

    @torch.no_grad()
    def frame(self, cam, prec=ref_frame.STATED) -> Tuple[torch.Tensor, Dict]:
        """The (H, W, 3) float32 frame at camera ``cam`` and the counts of
        its K1 and K2 work (``counts.k1_cost``, ``counts.k2_cost``)."""
        base_res = int(self.cfg.get("sweep_res") or max(self.width,
                                                         self.height))
        fr = ref_geom.frame_sweep(cam[3], self.cfg["shape"], self.box, self.p,
                                  base_res)
        mixed_s, seg_s, modsz_s = self.volumes(fr)
        camt = cam_tensors(cam, self.device)
        geom = ref_geom.content_geometry(camt, self.p, fr, self.width,
                                         self.height)
        s1 = ref_frame.stage1(mixed_s, seg_s, geom, self.p, fr, prec)
        fld, stride = None, 1
        if self.inr:
            stride = self.cfg["model"]["pred_stride"]
            fld = ref_field.field(self.layers, self.cfg["model"]
                                  ["fourier_freqs"], modsz_s, geom, self.p,
                                  fr, stride, prec)
        comp = ref_frame.composite(s1, self.use_gamma, self.use_clip, prec,
                                   fld, stride, 1)
        img = ref_frame.warp(comp.C, camt, geom, fr.axis, self.width,
                             self.height, self.p.bg_color, prec)
        K, Na, O = s1.t1b.shape
        i_map, j_map, valid = ref_frame.screen_maps(
            camt, geom, fr.axis, O, self.width, self.height)
        i0 = torch.clamp(torch.floor(i_map[valid]).long(), 0, O - 2)
        j0 = torch.clamp(torch.floor(j_map[valid]).long(), 0, O - 2)
        touched = torch.zeros((O + 1) * (O + 1), dtype=torch.bool,
                              device=self.device)
        for d in (0, 1, O + 1, O + 2):
            touched[i0 * (O + 1) + j0 + d] = True
        info = dict(K=K, Na=Na, O=O, axis=fr.axis, row_overlays=1,
                    field_numel=0 if fld is None else fld.numel(),
                    n_active=int(comp.planes.sum()),
                    n_labeled=int(comp.n_labeled.sum()),
                    n_touched=int(touched.sum()))
        if fld is not None:
            info["field_classes"] = torch.bincount(
                fld.reshape(-1).long(), minlength=4).tolist()
        return img, info

    def work(self, cam) -> counts.FrameWork:
        """The frame's nominal work (``counts.frame_work``)."""
        voxel, vol_min = geometry_params(self.cfg)
        samples = counts.frame_samples(cam, self.width, self.height, vol_min,
                                       voxel, self.box, self.device)
        crop_voxels = math.prod(hi - lo for lo, hi in self.box)
        m = self.cfg.get("model")
        return counts.frame_work(
            samples, self.width, self.height, crop_voxels,
            overlays=2 if self.inr else 1,
            field_stride=m["pred_stride"] if self.inr else None,
            model=m if self.inr else None,
            n_modalities=len(self.cfg["modalities"]))

    def close(self) -> None:
        self._vols.clear()


class Control:
    """The reference in a lower precision, put in the program's place."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device,
                 variant: str):
        self.ref = Reference(cfg, traffic, seed, device)
        self.prec = ref_frame.CONTROLS[variant]
        self.traffic = traffic

    def request(self, i: int):
        return self.ref.cam(i)

    def serve(self, cam) -> np.ndarray:
        return self.ref.frame(cam, self.prec)[0].cpu().numpy()

    def warmup(self) -> None:
        pass

    def close(self) -> None:
        self.ref.close()


def build(cfg, traffic, seed, device) -> Viewer:
    return Viewer(cfg, traffic, seed, device)


def reference(cfg, traffic, seed, device) -> Reference:
    return Reference(cfg, traffic, seed, device)


def control(cfg, traffic, seed, device, variant) -> Control:
    return Control(cfg, traffic, seed, device, variant)


def controls(cfg) -> List[str]:
    """The control variants that apply to a configuration."""
    names = ["resample_fp8", "composite_bf16"]
    return names + (["mlp_fp8"] if cfg["overlay"] == "inr" else [])

