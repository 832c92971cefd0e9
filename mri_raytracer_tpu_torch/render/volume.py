"""u8 grid volume renderer front-end (port of ``render/volume.py``; reference
H2, ``scripts/volumeRendering/app.py`` + ``volume_render.slang``).

Exact oracle semantics (``ops/raymarch.render_grid_u8``): fixed step count
between the near/far planes, webgpu-sample opacity accumulation
``a += (1-a) * s * 4/steps`` inside the [-1,1]^3 cube, plus the MIP and
Phong iso-surface modes.

Volume sources mirror the reference app: raw u8 (.gz), BC4 blocks, or NIfTI
in 'occupancy' / 'labels' modes. The volume lives on the renderer's device
as uint8 (``cuda`` unless the caller asks for another).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mri_raytracer_tpu_torch.data import brats, codecs
from mri_raytracer_tpu_torch.env import resolve_device
from mri_raytracer_tpu_torch.ops import raymarch
from mri_raytracer_tpu_torch.render.camera import CameraBasis


def load_volume(path, fmt: str = "r8", dims: Optional[Tuple[int, int, int]] = None,
                mode: str = "occupancy") -> np.ndarray:
    """Volume source multiplexer (reference ``app.py`` format ComboBox):
    r8 / bc4 raw volumes (dims required) or a NIfTI file."""
    path = str(path)
    if path.endswith((".nii", ".nii.gz")):
        vol, _, _ = brats.load_display_volume(path)
        if mode == "labels":
            seg = brats.load_seg_volume(path)
            return (np.clip(seg, 0, 3) * 85).astype(np.uint8)
        return (vol * 255).astype(np.uint8)
    if dims is None:
        raise ValueError("raw volume formats need --dims X,Y,Z")
    if fmt == "r8":
        return codecs.load_u8_volume(path, dims)
    if fmt == "bc4":
        return codecs.load_bc4_volume(path, dims)
    raise ValueError(f"unsupported format {fmt!r} (astc is not supported, "
                     "matching the reference)")


class GridVolumeRenderer:
    def __init__(self, vol_u8: np.ndarray, width: int = 512, height: int = 512,
                 device=None):
        self.device = resolve_device(device)
        self.vol = torch.as_tensor(np.ascontiguousarray(vol_u8),
                                   device=self.device)
        self.width, self.height = width, height

    def render(self, basis: CameraBasis, step_count: float = 64.0,
               near: float = 1.0, far: float = 7.0, mode: str = "composite",
               iso: float = 0.25) -> torch.Tensor:
        """``mode``: 'composite' (reference volume_render.slang
        accumulation), 'mip' (maximum-intensity projection), or 'iso'
        (first-crossing iso-surface at ``iso`` with gradient Phong
        shading)."""
        p = raymarch.GridRenderParams(
            step_count=np.float32(step_count), near=np.float32(near),
            far=np.float32(far))
        kw = dict(max_steps=int(step_count), device=self.device)
        if mode == "mip":
            return raymarch.render_grid_mip(self.vol, basis, p, self.width,
                                            self.height, **kw)
        if mode == "iso":
            return raymarch.render_grid_iso(self.vol, basis, p, self.width,
                                            self.height, iso=iso, **kw)
        return raymarch.render_grid_u8(self.vol, basis, p, self.width,
                                       self.height, **kw)

    def render_numpy(self, basis, **kw) -> np.ndarray:
        return self.render(basis, **kw).cpu().numpy()
