"""Segmentation loss zoo (port of ``losses.py``, reference L1-L8).

All functions operate on flat voxel batches: ``logits (B, C)``,
``labels (B,) int``. ``segmentation_loss`` composes them per ``LossConfig``
and returns ``(total, aux)``; the training step differentiates ``total``
with ``backward()``. Each function computes what its JAX counterpart
computes, in the same order of operations
(``tests/test_torch_port_losses.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mri_raytracer_tpu_torch.config import LossConfig
from mri_raytracer_tpu_torch.env import device_floats


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).to(torch.float32)


def soft_dice_per_class(probs: torch.Tensor, onehot: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """(C,) soft Dice over the batch (reference ``soft_dice_per_class``)."""
    inter = torch.sum(probs * onehot, dim=0)
    sums = torch.sum(probs, dim=0) + torch.sum(onehot, dim=0)
    return (2 * inter + eps) / (sums + eps)


def soft_dice_loss(probs: torch.Tensor, onehot: torch.Tensor,
                   eps: float = 1e-6, per_class: bool = False
                   ) -> torch.Tensor:
    """1 - Dice; either class-mean or prevalence-weighted
    (reference ``scripts/jax_inr_brats.py:179-190``)."""
    dice = soft_dice_per_class(probs, onehot, eps)
    if per_class:
        return 1.0 - torch.mean(dice)
    w = torch.sum(onehot, dim=0)
    w = w / (torch.sum(w) + eps)
    return 1.0 - torch.sum(dice * w)


def weighted_ce(logits: torch.Tensor, onehot: torch.Tensor,
                sample_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,) CE, optionally weighted per sample."""
    ce = -torch.sum(onehot * F.log_softmax(logits, dim=-1), dim=-1)
    if sample_w is not None:
        ce = ce * sample_w
    return ce


def focal_ce(logits: torch.Tensor, onehot: torch.Tensor, gamma: float,
             alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically-stable focal CE (reference ``focal_ce_loss``)."""
    logp = F.log_softmax(logits, dim=-1)
    ce = -torch.sum(onehot * logp, dim=-1)
    pt = torch.sum(onehot * torch.exp(logp), dim=-1)
    mod = torch.pow(1.0 - pt, gamma)
    if alpha is not None:
        mod = mod * torch.sum(onehot * alpha[None, :], dim=-1)
    return mod * ce


def label_smooth(onehot: torch.Tensor, eps: float) -> torch.Tensor:
    C = onehot.shape[-1]
    return onehot * (1.0 - eps) + eps / C


def tversky_index(p: torch.Tensor, gt: torch.Tensor, alpha: float,
                  beta: float, eps: float = 1e-6) -> torch.Tensor:
    """Binary Tversky index; alpha penalizes FP, beta FN."""
    tp = torch.sum(p * gt)
    fp = torch.sum(p * (1.0 - gt))
    fn = torch.sum((1.0 - p) * gt)
    return tp / (tp + alpha * fp + beta * fn + eps)


def unified_focal_loss(logits: torch.Tensor, onehot: torch.Tensor,
                       lam: float = 0.5, gamma: float = 0.5,
                       delta: float = 0.6, eps: float = 1e-7
                       ) -> torch.Tensor:
    """Unified Focal Loss = lam * mFTL + (1-lam) * mFL (reference
    ``improved.ipynb §8``), with probability clipping for stability."""
    probs = torch.clamp(F.softmax(logits, dim=-1), eps, 1.0 - eps)
    # Modified focal Tversky (per class, asymmetry delta, focal gamma)
    tp = torch.sum(probs * onehot, dim=0)
    fp = torch.sum(probs * (1.0 - onehot), dim=0)
    fn = torch.sum((1.0 - probs) * onehot, dim=0)
    ti = (tp + eps) / (tp + delta * fn + (1.0 - delta) * fp + eps)
    mftl = torch.mean(torch.pow(torch.clamp(1.0 - ti, 0.0, 1.0), gamma))
    # Modified focal CE with asymmetric delta weighting on foreground
    logp = torch.log(probs)
    ce = -torch.sum(onehot * logp, dim=-1)
    pt = torch.sum(onehot * probs, dim=-1)
    is_fg = torch.argmax(onehot, dim=-1) > 0
    w = torch.where(is_fg, delta, 1.0 - delta)
    mfl = torch.mean(w * torch.pow(1.0 - pt, 1.0 - gamma) * ce)
    return lam * mftl + (1.0 - lam) * mfl


def tv_loss_slice(prob_slice: torch.Tensor) -> torch.Tensor:
    """Total-variation spatial-coherence loss over a (H, W, C) probability
    slice (reference ``improved.ipynb §8``)."""
    dx = torch.abs(prob_slice[1:, :, :] - prob_slice[:-1, :, :]).mean()
    dy = torch.abs(prob_slice[:, 1:, :] - prob_slice[:, :-1, :]).mean()
    return dx + dy


def freq_dropout_mask(generator: torch.Generator, x: torch.Tensor,
                      coord_dim: int, ff_dim: int, rate: float
                      ) -> torch.Tensor:
    """Randomly zero Fourier-feature columns of the built input
    (reference ``scripts/jax_inr_brats.py:212-221``); the draw comes from
    ``generator``."""
    if rate <= 0.0 or ff_dim <= 0:
        return x
    u = torch.rand((ff_dim,), generator=generator, dtype=x.dtype,
                   device=generator.device).to(x.device)
    mask = (u > rate).to(x.dtype)
    return torch.cat([x[:, :coord_dim],
                      x[:, coord_dim:coord_dim + ff_dim] * mask[None, :],
                      x[:, coord_dim + ff_dim:]], dim=-1)


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor,
                      cfg: LossConfig, num_classes: int,
                      sample_weights: Optional[torch.Tensor] = None,
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Composite loss per LossConfig; returns (scalar, aux metrics).

    Baseline combo matches reference L1: ``(1-dw)*CE_w + dw*(1-meanDice)``
    with per-class CE/Dice aux (``inr/inr/model.py:57-90``); every optional
    term reproduces one of L2-L8.
    """
    y = one_hot(labels, num_classes)
    y_t = label_smooth(y, cfg.label_smoothing) if cfg.label_smoothing > 0 \
        else y

    if cfg.focal_gamma > 0.0:
        alpha = (device_floats(cfg.focal_alpha, logits.device)
                 if cfg.focal_alpha else None)
        ce_vec = focal_ce(logits, y_t, cfg.focal_gamma, alpha)
    else:
        ce_vec = weighted_ce(logits, y_t)
    w = device_floats(cfg.class_weights, logits.device)[labels.long()]
    if sample_weights is not None:
        if cfg.boundary_weight > 0.0:
            # sample_weights carry the raw boundary map 1/(1+EDT) in (0, 1];
            # blend so far-from-boundary voxels keep weight ~1 and boundary
            # voxels are boosted up to (1 + boundary_weight) (reference L8).
            w = w * (1.0 + cfg.boundary_weight * sample_weights)
        else:
            w = w * sample_weights
    ce_scalar = torch.mean(ce_vec * w)

    probs = F.softmax(logits, dim=-1)
    dice_k = soft_dice_per_class(probs, y)
    if cfg.dice_weight > 0.0:
        dl = soft_dice_loss(probs, y, per_class=cfg.per_class_dice)
        total = (1.0 - cfg.dice_weight) * ce_scalar + cfg.dice_weight * dl
    else:
        total = ce_scalar

    if cfg.unified_focal_weight > 0.0:
        total = total + cfg.unified_focal_weight * unified_focal_loss(
            logits, y, cfg.unified_focal_lambda, cfg.unified_focal_gamma,
            cfg.unified_focal_delta)

    # Edema (class 2) specific regularizers (reference L6).
    if cfg.edema_fp_weight > 0.0:
        gt2 = (labels == 2).to(probs.dtype)
        total = total + cfg.edema_fp_weight * torch.mean(
            probs[:, 2] * (1.0 - gt2))
    if cfg.tversky_weight > 0.0:
        gt2 = (labels == 2).to(probs.dtype)
        tv = tversky_index(probs[:, 2], gt2, cfg.tversky_alpha,
                           cfg.tversky_beta)
        total = total + cfg.tversky_weight * (1.0 - tv)
    if cfg.edema_logit_reg > 0.0:
        gt2 = (labels == 2).to(probs.dtype)
        total = total + cfg.edema_logit_reg * torch.mean(
            F.softplus(logits[:, 2]) * (1.0 - gt2))

    counts = torch.sum(y, dim=0)
    ce_mean_k = torch.sum(ce_vec[:, None] * y, dim=0) / torch.clamp(
        counts, min=1.0)
    aux = {"ce_per_class": ce_mean_k, "dice_per_class": dice_k,
           "ce": ce_scalar}
    return total, aux
