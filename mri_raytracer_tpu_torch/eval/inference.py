"""Full-volume INR inference (port of ``eval/inference.py:21-79``).

``_predict_labels`` is the generic float32 path: every voxel's normalized
coordinates and intensities through ``model.apply`` in chunks.
``predict_volume`` takes the separable bf16 bake (``ops.neural_march.
bake_labels``) for models that allow it, the generic path otherwise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mri_raytracer_tpu_torch.env import resolve_device
from mri_raytracer_tpu_torch.models.api import ModelBundle


def _norm_grid(shape: Tuple[int, int, int], device=None) -> torch.Tensor:
    """(N, 3) normalized [-1,1] coordinates of every voxel (x-major order,
    matching the reference meshgrid(indexing='ij') flatten)."""
    H, W, D = shape
    axes = [torch.linspace(-1.0, 1.0, n, device=device) for n in (H, W, D)]
    g = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    return g.reshape(-1, 3).to(torch.float32)


@torch.no_grad()
def _predict_labels(model: ModelBundle, params, mods: torch.Tensor,
                    chunk: int = 131072) -> torch.Tensor:
    """(M, X, Y, Z) modalities -> (X, Y, Z) int16 argmax labels."""
    M = mods.shape[0]
    shape = tuple(mods.shape[1:])
    coords = _norm_grid(shape, mods.device)
    intens = mods.permute(1, 2, 3, 0).reshape(-1, M)
    preds = [torch.argmax(model.apply(params, coords[s:s + chunk],
                                      intens[s:s + chunk]), dim=-1)
             for s in range(0, coords.shape[0], chunk)]
    return torch.cat(preds).to(torch.int16).reshape(shape)


def predict_volume(model: ModelBundle, params, case_data, chunk: int = 131072,
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(pred_vol, seg_true) like the reference ``predict_volume``. Runs on
    ``device`` (``cuda`` unless given), where ``params`` must already
    lie."""
    dev = resolve_device(device)
    mods = np.asarray(case_data["mods"], np.float32)
    seg_true = np.asarray(case_data["seg"])
    from mri_raytracer_tpu_torch.ops.neural_march import (bake_labels,
                                                          model_is_separable)

    mods_t = torch.as_tensor(mods, device=dev)
    if model_is_separable(model):
        pred = bake_labels(model, params, mods_t)
    else:
        pred = _predict_labels(model, params, mods_t, chunk=chunk)
    return pred.cpu().numpy(), seg_true
