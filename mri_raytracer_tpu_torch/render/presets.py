"""Named transfer-function presets for the BraTS renderer (port of
``render/presets.py``).

A preset is a dict of ``BratsRenderParams`` field overrides on top of the
reference viewer's window/level/alpha/gamma sliders and per-modality
enable/weight toggles (``inr/viewer/brats_viewer.py:126-144``). Every leaf
stays a float32 tensor, so switching presets mid-orbit is new values through
the same renderer. Modality order everywhere: (t1n, t1c, t2w, t2f).
"""

from __future__ import annotations

from typing import Dict

import torch

from mri_raytracer_tpu_torch.render.params import BratsRenderParams

# name -> field overrides (floats / 4-tuples; cast on apply)
PRESETS: Dict[str, Dict] = {
    # The reference viewer's slider defaults.
    "default": dict(ww=1.0, wl=0.5, intensity_alpha=0.4, gamma=1.0,
                    vol_enabled=(1, 1, 1, 1), vol_weight=(1, 1, 1, 1)),
    # Anatomy on T1: tight window around mid-gray, mild opacity.
    "t1-anatomy": dict(ww=0.7, wl=0.55, intensity_alpha=0.45, gamma=1.0,
                       vol_enabled=(1, 0, 0, 0), vol_weight=(1, 0, 0, 0)),
    # Contrast-enhancing tissue on T1c: upper-intensity window, punchy
    # gamma so enhancement pops over parenchyma.
    "t1c-enhancing": dict(ww=0.5, wl=0.7, intensity_alpha=0.6, gamma=1.4,
                          vol_enabled=(0, 1, 0, 0), vol_weight=(0, 1, 0, 0)),
    # Fluid/CSF on T2: wide window, softer opacity.
    "t2-fluid": dict(ww=1.2, wl=0.55, intensity_alpha=0.35, gamma=0.9,
                     vol_enabled=(0, 0, 1, 0), vol_weight=(0, 0, 1, 0)),
    # Edema on FLAIR: upper window + raised opacity.
    "flair-lesion": dict(ww=0.6, wl=0.65, intensity_alpha=0.55, gamma=1.2,
                         vol_enabled=(0, 0, 0, 1), vol_weight=(0, 0, 0, 1)),
    # All modalities, low alpha, sub-unit gamma: translucent "x-ray" look.
    "xray": dict(ww=1.0, wl=0.5, intensity_alpha=0.12, gamma=0.7,
                 vol_enabled=(1, 1, 1, 1), vol_weight=(1, 1, 1, 1)),
    # Dense tissue only: high level crops faint voxels (also enables the
    # shear-warp content crop, wl >= ww/2).
    "dense": dict(ww=0.8, wl=0.75, intensity_alpha=0.7, gamma=1.1,
                  vol_enabled=(1, 1, 1, 1), vol_weight=(1, 1, 1, 1)),
}


def preset_names():
    return sorted(PRESETS)


def apply_preset(params: BratsRenderParams, name: str) -> BratsRenderParams:
    """Return ``params`` with the named preset's transfer-function fields
    replaced, on the params' device (camera/box/LUT/overlay fields
    untouched)."""
    try:
        over = PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; have {preset_names()}")
    dev = params.ww.device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    return params._replace(**{k: f32(v) for k, v in over.items()})
