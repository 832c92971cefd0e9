"""Full-volume / slice INR inference and evaluation (port of
``eval/inference.py``, reference E1, E2, E6).

``_predict_labels`` is the generic float32 path: every voxel's normalized
coordinates and intensities through ``model.apply`` in chunks.
``predict_volume`` takes the separable bf16 bake (``ops.neural_march.
bake_labels``) for models that allow it unless ``exact=True``, the generic
path otherwise.
``evaluate_cases`` fans the cases out over threads, so the host-side
metrics (Hausdorff KD-trees) overlap the device inference.
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
                   gaussian_sigma: float = 0.0, exact: bool = False,
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(pred_vol, seg_true) like the reference ``predict_volume``; optional
    Gaussian pre-filter of the modalities on the host (SciPy's
    ``gaussian_filter``, reference E8, ``scripts/jax_inr_brats.py:
    266-270``). Runs on ``device`` (``cuda`` unless given), where ``params``
    must already lie.

    ``exact=True`` forces the float32 chunked predictor even for separable
    models: the bf16 separable bake can flip ~0.5% of near-boundary
    labels, which shifts parity metrics; reference-matching evaluations
    opt into the exact path."""
    dev = resolve_device(device)
    mods = np.asarray(case_data["mods"], np.float32)
    seg_true = np.asarray(case_data["seg"])
    if gaussian_sigma > 0.0:
        from scipy.ndimage import gaussian_filter

        mods = np.stack([gaussian_filter(m, sigma=gaussian_sigma)
                         for m in mods])
    from mri_raytracer_tpu_torch.ops.neural_march import (bake_labels,
                                                          model_is_separable)

    mods_t = torch.as_tensor(mods, device=dev)
    if model_is_separable(model) and not exact:
        pred = bake_labels(model, params, mods_t)
    else:
        pred = _predict_labels(model, params, mods_t, chunk=chunk)
    return pred.cpu().numpy(), seg_true


@torch.no_grad()
def predict_slice(model: ModelBundle, params, mods: torch.Tensor, z: int
                  ) -> np.ndarray:
    """Single axial plane prediction (reference E2): (M, H, W, D) z-scored
    modalities on the params' device -> (H, W) labels."""
    M, H, W, D = mods.shape
    dev = mods.device
    xs = torch.linspace(-1.0, 1.0, H, device=dev)
    ys = torch.linspace(-1.0, 1.0, W, device=dev)
    zval = (z / max(D - 1, 1)) * 2.0 - 1.0
    X, Y = torch.meshgrid(xs, ys, indexing="ij")
    coords = torch.stack([X.reshape(-1), Y.reshape(-1),
                          torch.full((H * W,), zval, device=dev)],
                         dim=-1).to(torch.float32)
    intens = mods[:, :, :, z].permute(1, 2, 0).reshape(-1, M)
    logits = model.apply(params, coords, intens)
    return torch.argmax(logits, -1).reshape(H, W).cpu().numpy()


def evaluate_single_case(model: ModelBundle, params, case_data,
                         num_classes: int = 4, chunk: int = 131072,
                         spacing=(1.0, 1.0, 1.0), device=None):
    """Per-case eval worker (reference E6): all metrics + volumes."""
    from mri_raytracer_tpu_torch.eval import metrics

    pred_vol, true_vol = predict_volume(model, params, case_data,
                                        chunk=chunk, device=device)
    scores = metrics.dice_score(pred_vol, true_vol, num_classes)
    hd = metrics.hausdorff_distance(pred_vol, true_vol, spacing, num_classes)
    cov = metrics.coverage_dice(pred_vol, true_vol)
    valid = [s for s in scores.values() if not np.isnan(s)]
    return {
        "pred_vol": pred_vol,
        "true_vol": true_vol,
        "class_scores": scores,
        "coverage_dice": cov,
        "mean_dice": float(np.mean(valid)) if valid else 0.0,
        "hausdorff_scores": hd,
    }


def evaluate_cases(model: ModelBundle, params, cases, num_classes: int = 4,
                   chunk: int = 131072, max_workers: int = 4, device=None):
    """Thread fan-out over cases + per-class mean/std aggregation
    (reference ``evaluate_inr``, ``inr/inr/train.py:274-336``)."""
    from concurrent.futures import ThreadPoolExecutor

    dev = resolve_device(device)
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        results = list(ex.map(
            lambda cd: evaluate_single_case(model, params, cd, num_classes,
                                            chunk, device=dev),
            cases))

    agg = {}
    for c in range(num_classes):
        vals = [r["class_scores"][c] for r in results
                if not np.isnan(r["class_scores"][c])]
        agg[f"dice_class_{c}"] = (float(np.mean(vals)) if vals
                                  else float("nan"),
                                  float(np.std(vals)) if vals
                                  else float("nan"))
        hvals = [r["hausdorff_scores"][c] for r in results
                 if not np.isnan(r["hausdorff_scores"][c])]
        agg[f"hd_class_{c}"] = (float(np.mean(hvals)) if hvals
                                else float("nan"),
                                float(np.std(hvals)) if hvals
                                else float("nan"))
    cov = [r["coverage_dice"] for r in results]
    agg["coverage_dice"] = (float(np.mean(cov)), float(np.std(cov)))
    md = [r["mean_dice"] for r in results]
    agg["mean_dice"] = (float(np.mean(md)), float(np.std(md)))
    return results, agg
