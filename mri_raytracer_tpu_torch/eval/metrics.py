"""Evaluation metrics (port of ``eval/metrics.py``, reference E3-E5, E7).

Hard Dice / coverage Dice / Hausdorff keep the reference's exact semantics,
including NaN-for-empty-class (``inr/inr/model.py:144-195``). The numpy
functions are own copies of the JAX package's (same results bit for bit);
``dice_score_device`` and ``ssim_torch`` are the torch counterparts of its
device functions (``dice_score_device``, ``ssim_jax``). Hausdorff stays
host-side scipy (eval-only).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def dice_score(pred: np.ndarray, true: np.ndarray, num_classes: int = 4,
               eps: float = 1e-6) -> Dict[int, float]:
    scores: Dict[int, float] = {}
    for c in range(num_classes):
        p = pred == c
        t = true == c
        denom = int(p.sum()) + int(t.sum())
        if denom > 0:
            scores[c] = float((2 * np.logical_and(p, t).sum() + eps) / (denom + eps))
        else:
            scores[c] = float("nan")
    return scores


def coverage_dice(pred: np.ndarray, true: np.ndarray, eps: float = 1e-6) -> float:
    """Any-tumor vs any-tumor binary Dice."""
    p = pred > 0
    t = true > 0
    denom = int(p.sum()) + int(t.sum())
    if denom == 0:
        return 0.0
    return float((2 * np.logical_and(p, t).sum() + eps) / (denom + eps))


def dice_score_device(pred: torch.Tensor, true: torch.Tensor,
                      num_classes: int = 4, eps: float = 1e-6
                      ) -> torch.Tensor:
    """(C,) hard Dice on the tensors' device; empty classes produce NaN
    like the host path."""
    classes = torch.arange(num_classes, device=pred.device)
    p = pred[None] == classes[:, None, None, None]
    t = true[None] == classes[:, None, None, None]
    inter = torch.sum(p & t, dim=(1, 2, 3)).to(torch.float32)
    denom = (torch.sum(p, dim=(1, 2, 3))
             + torch.sum(t, dim=(1, 2, 3))).to(torch.float32)
    dice = (2 * inter + eps) / (denom + eps)
    return torch.where(denom > 0, dice, torch.full_like(dice, float("nan")))


def hausdorff_distance(pred: np.ndarray, true: np.ndarray,
                       spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                       num_classes: int = 4) -> Dict[int, float]:
    """Symmetric per-class Hausdorff (max of directed maxes) via KD-trees,
    voxel-spacing aware (reference ``inr/inr/model.py:164-195``)."""
    from scipy.spatial import cKDTree

    sp = np.asarray(spacing, np.float32)
    out: Dict[int, float] = {}
    for c in range(num_classes):
        pm = np.argwhere(pred == c).astype(np.float32) * sp
        tm = np.argwhere(true == c).astype(np.float32) * sp
        if len(pm) == 0 or len(tm) == 0:
            out[c] = float("nan")
            continue
        d_pt = cKDTree(tm).query(pm, k=1)[0]
        d_tp = cKDTree(pm).query(tm, k=1)[0]
        out[c] = float(max(d_pt.max(), d_tp.max()))
    return out


def psnr(pred: np.ndarray, true: np.ndarray, data_range: float = 1.0) -> float:
    """PSNR in dB (render-quality metric; also reference E7's slice PSNR)
    of two images: tensors on any device, or arrays."""
    mse = float(np.mean((_np64(pred) - _np64(true)) ** 2))
    if mse <= 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def psnr_per_slice(pred_vol: np.ndarray, true_vol: np.ndarray,
                   data_range: float = 1.0) -> np.ndarray:
    """(Z,) per-axial-slice PSNR (reference ``_psnr_slice``)."""
    Z = pred_vol.shape[-1]
    return np.array([psnr(pred_vol[..., z], true_vol[..., z], data_range)
                     for z in range(Z)])


def ssim(pred: np.ndarray, true: np.ndarray, data_range: float = 1.0,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> float:
    """Structural similarity (Wang et al. 2004: Gaussian window sigma=1.5,
    C1=(K1·L)^2, C2=(K2·L)^2). Multichannel inputs average SSIM over
    channels. Reference protocol: the showcase plan reports "PSNR/SSIM vs
    fine reference" for the ROI renderer
    (``docs/Methodology-ROI-Neural-Volumetric-Rendering.md:58``,
    ``docs/showcase-plan.md:45``)."""
    from scipy.ndimage import gaussian_filter

    pred = np.asarray(pred, np.float64)
    true = np.asarray(true, np.float64)
    if pred.ndim == 3:  # (H, W, C): average over channels
        return float(np.mean([ssim(pred[..., c], true[..., c], data_range,
                                   sigma, k1, k2)
                              for c in range(pred.shape[-1])]))
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_p = gaussian_filter(pred, sigma)
    mu_t = gaussian_filter(true, sigma)
    mu_pp = gaussian_filter(pred * pred, sigma)
    mu_tt = gaussian_filter(true * true, sigma)
    mu_pt = gaussian_filter(pred * true, sigma)
    var_p = np.maximum(mu_pp - mu_p * mu_p, 0.0)
    var_t = np.maximum(mu_tt - mu_t * mu_t, 0.0)
    cov = mu_pt - mu_p * mu_t
    num = (2 * mu_p * mu_t + c1) * (2 * cov + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2)
    return float(np.mean(num / den))


def _gauss_blur2d_torch(x: torch.Tensor, sigma: float = 1.5,
                        truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur matching ``scipy.ndimage.gaussian_filter``
    (radius int(truncate*sigma + 0.5), 'reflect' boundary = numpy's
    symmetric padding), as shifted-slice sums on the tensor's device."""
    r = int(truncate * sigma + 0.5)
    t = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k /= k.sum()
    for axis in (0, 1):
        n = x.shape[axis]
        # Symmetric padding by index: period 2n, mirrored halves.
        i = torch.arange(-r, n + r, device=x.device) % (2 * n)
        xp = x.index_select(axis, torch.where(i >= n, 2 * n - 1 - i, i))
        acc = None
        for j in range(2 * r + 1):
            term = float(k[j]) * xp.narrow(axis, j, n)
            acc = term if acc is None else acc + term
        x = acc
    return x


def ssim_torch(pred: torch.Tensor, true: torch.Tensor,
               data_range: float = 1.0, sigma: float = 1.5,
               k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Device-side SSIM for 2D images — same formula and window as
    ``ssim``; returns a scalar tensor so evaluations never ship frames to
    the host."""
    pred = pred.to(torch.float32)
    true = true.to(torch.float32)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_p = _gauss_blur2d_torch(pred, sigma)
    mu_t = _gauss_blur2d_torch(true, sigma)
    mu_pp = _gauss_blur2d_torch(pred * pred, sigma)
    mu_tt = _gauss_blur2d_torch(true * true, sigma)
    mu_pt = _gauss_blur2d_torch(pred * true, sigma)
    var_p = torch.clamp(mu_pp - mu_p * mu_p, min=0.0)
    var_t = torch.clamp(mu_tt - mu_t * mu_t, min=0.0)
    cov = mu_pt - mu_p * mu_t
    num = (2 * mu_p * mu_t + c1) * (2 * cov + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2)
    return torch.mean(num / den)


def macro_slice_dice(pred_slice: np.ndarray, true_slice: np.ndarray,
                     num_classes: int = 4) -> float:
    """Mean of per-class hard Dice on a 2D slice, NaN classes excluded
    (reference ``_dice_macro_slice``)."""
    vals = []
    for c in range(num_classes):
        p = pred_slice == c
        t = true_slice == c
        denom = int(p.sum()) + int(t.sum())
        if denom > 0:
            vals.append(2 * np.logical_and(p, t).sum() / denom)
    return float(np.mean(vals)) if vals else float("nan")
