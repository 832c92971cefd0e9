"""U-Net epoch trainer (port of ``train/unet_trainer.py``, reference T9,
``Final-1.ipynb §6``) + distillation into an implicit MLP (reference
M8/T distillation, ``Final-1.ipynb §11-12``).

Loss parity (L9): combo = CE + class-weighted soft Dice. Per-epoch train
loss and validation hard Dice for classes {1,2,3} (the reference's "Dice
gates"), best-checkpoint save on val mean Dice. Slices come from
``data/slices.slice_batches`` through ``prefetch`` to the device as NHWC;
the step permutes them once to NCHW, the U-Net's layout.

The optimizer is optax's ``adamw(lr)``: b1 0.9, b2 0.999, eps 1e-8 and
weight decay 1e-4 on every parameter, BatchNorm scale and bias included
(``torch.optim.AdamW`` defaults to 1e-2; here it gets optax's 1e-4).

Convolution precision: full float32. cuDNN may run float32 convolutions
as TF32 (``torch.backends.cudnn.allow_tf32``, PyTorch's default); the
trainer and ``predict_slices`` switch that off while they run
(``fp32_convs``), so the card computes what the CPU computes to float32
rounding, and ``chip_smoke.py``'s card-vs-CPU bar on the trained
weights' logits holds.
"""

from __future__ import annotations

import contextlib
import pathlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mri_raytracer_tpu_torch import convert, losses
from mri_raytracer_tpu_torch.data import slices as slices_mod
from mri_raytracer_tpu_torch.env import device_floats, resolve_device
from mri_raytracer_tpu_torch.io import checkpoint as ckpt
from mri_raytracer_tpu_torch.models import unet as unet_mod

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


@contextlib.contextmanager
def fp32_convs():
    """While open, cuDNN runs float32 convolutions in float32, not TF32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def combo_loss(logits: torch.Tensor, labels: torch.Tensor,
               num_classes: int = 4, class_weights=(1.0, 2.0, 2.0, 2.0),
               dice_w: float = 0.5) -> torch.Tensor:
    """CE + class-weighted soft Dice over flattened pixels (reference L9);
    ``logits`` (..., C) with classes last, as in the JAX package."""
    C = num_classes
    lf = logits.reshape(-1, C)
    yf = labels.reshape(-1).long()
    y1 = losses.one_hot(yf, C)
    cw = device_floats(class_weights, logits.device)
    ce = torch.mean(losses.weighted_ce(lf, y1) * cw[yf])
    probs = torch.softmax(lf, -1)
    dice = losses.soft_dice_per_class(probs, y1)
    return (1 - dice_w) * ce + dice_w * (1.0 - torch.sum(dice * cw)
                                         / torch.sum(cw))


def hard_dice_classes(pred, true, classes=(1, 2, 3)) -> Dict[int, float]:
    out = {}
    for c in classes:
        p = pred == c
        t = true == c
        denom = int(p.sum()) + int(t.sum())
        out[c] = float((2 * np.logical_and(p, t).sum() + 1e-6) / (denom + 1e-6)) \
            if denom > 0 else float("nan")
    return out


def build_adamw(model: torch.nn.Module, lr: float) -> torch.optim.AdamW:
    """optax.adamw(lr) over every parameter of ``model``."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=ADAMW_WEIGHT_DECAY)


def make_train_step(model: unet_mod.UNet2D, optimizer: torch.optim.Optimizer,
                    num_classes: int = 4
                    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``step(imgs (N,H,W,M), labels (N,H,W)) -> loss``: one training-mode
    forward (batch statistics, running averages updated), the combo loss,
    backward and one optimizer update, all on the batch's device; the loss
    is returned as a device tensor (no host sync)."""

    def step(imgs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        x = imgs.permute(0, 3, 1, 2).contiguous()
        logits = model(x).permute(0, 2, 3, 1)
        loss = combo_loss(logits, labels, num_classes)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


@torch.no_grad()
def predict_slices(model: unet_mod.UNet2D, imgs: torch.Tensor
                   ) -> torch.Tensor:
    """(N, H, W) argmax labels of NHWC images with the running averages."""
    model.eval()
    with fp32_convs():
        logits = model(imgs.permute(0, 3, 1, 2).contiguous())
    return torch.argmax(logits, 1)


def val_dice(model: unet_mod.UNet2D, cache, index, batch_size: int,
             device) -> float:
    """The validation score of ``train_unet``: over the batches of
    ``slice_batches(cache, index, batch_size, seed=0)``, the mean of each
    batch's class-mean hard Dice for classes 1-3 (NaN-skipping)."""
    dices = []
    for imgs, labels in slices_mod.slice_batches(cache, index, batch_size,
                                                 seed=0, epochs=1):
        pred = predict_slices(model, torch.as_tensor(imgs, device=device))
        d = hard_dice_classes(pred.cpu().numpy(), labels)
        dices.append(np.nanmean(list(d.values())))
    return float(np.nanmean(dices)) if dices else float("nan")


def train_unet(train_cache, val_cache=None, epochs: int = 3,
               batch_size: int = 8, lr: float = 1e-3, base: int = 16,
               num_classes: int = 4, seed: int = 0,
               out_dir: Optional[str] = None, verbose: bool = True,
               device=None) -> Dict[str, Any]:
    """Epoch loop over axial slices on ``device`` (``cuda`` unless given);
    returns dict with the model (a ``UNet2D`` on the device), history and
    the best epoch. ``unet_best.npz`` holds the best epoch's weights in
    the JAX package's flax layout (``convert.unet_to_flax``), so JAX's
    ``load_params`` + ``UNet2D.apply`` reproduce the logits."""
    dev = resolve_device(device)
    probe = train_cache.get(0)["mods"]
    in_ch = probe.shape[0]
    H, W = probe.shape[1], probe.shape[2]
    H8, W8 = H + (-H) % 8, W + (-W) % 8
    model = unet_mod.create_unet(torch.Generator().manual_seed(seed), in_ch,
                                 num_classes, base, (H8, W8)).to(dev)
    train_step = make_train_step(model, build_adamw(model, lr), num_classes)

    idx = slices_mod.build_slice_index(train_cache, seed=seed)
    val_idx = (slices_mod.build_slice_index(val_cache, seed=seed)
               if val_cache is not None else [])
    history: List[Dict[str, Any]] = []
    best = {"val_dice": -1.0, "epoch": -1}
    out_path = pathlib.Path(out_dir) if out_dir else None

    with fp32_convs():
        for epoch in range(epochs):
            gen = slices_mod.slice_batches(train_cache, idx, batch_size,
                                           seed=seed + epoch, epochs=1)
            step_losses = [train_step(imgs, labels) for imgs, labels
                           in slices_mod.prefetch(gen, device=dev)]
            # One host read an epoch; summed in order in float64, as the
            # JAX loop adds float(l) step by step.
            host = (torch.stack(step_losses).tolist() if step_losses
                    else [])
            ep_loss = 0.0
            for v in host:
                ep_loss += v
            rec = {"epoch": epoch, "loss": ep_loss / max(len(host), 1)}

            if val_idx:
                rec["val_dice"] = val_dice(model, val_cache, val_idx,
                                           batch_size, dev)
                if rec["val_dice"] > best["val_dice"]:
                    best = {"val_dice": rec["val_dice"], "epoch": epoch}
                    if out_path:
                        ckpt.save_object(
                            convert.unet_to_flax(model),
                            out_path / "unet_best.npz",
                            info={"epoch": epoch, "val_dice": rec["val_dice"],
                                  "base": base, "num_classes": num_classes})
            history.append(rec)
            if verbose:
                print(f"[unet] epoch {epoch}: {rec}")

    return {"model": model, "history": history, "best": best}


# ------------------------------------------------------------- distillation
def collect_voxels(teacher_vol: np.ndarray, n_samples: int, seed: int = 0,
                   fg_bias: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """(coords in [-1,1], labels) sampled from a teacher label volume,
    foreground-biased (reference ``collect_voxels``, Final-1.ipynb §11)."""
    rng = np.random.default_rng(seed)
    H, W, D = teacher_vol.shape
    n_fg = int(n_samples * fg_bias)
    fg = np.argwhere(teacher_vol > 0)
    parts = []
    if len(fg) > 0 and n_fg > 0:
        sel = fg[rng.integers(0, len(fg), n_fg)]
        parts.append(sel)
    n_uni = n_samples - sum(len(p) for p in parts)
    uni = np.stack([rng.integers(0, H, n_uni), rng.integers(0, W, n_uni),
                    rng.integers(0, D, n_uni)], -1)
    parts.append(uni)
    idx = np.concatenate(parts)
    labels = teacher_vol[idx[:, 0], idx[:, 1], idx[:, 2]].astype(np.int32)
    coords = (idx / np.array([H - 1, W - 1, D - 1])) * 2.0 - 1.0
    return coords.astype(np.float32), labels


def make_distill_step(model, params: torch.nn.Module,
                      optimizer: torch.optim.Optimizer, coords: torch.Tensor,
                      labels: torch.Tensor, num_classes: int = 4):
    """``step(sel) -> loss``: the mean CE of the coords-only MLP on the
    voxels ``sel`` (indices into ``coords`` / ``labels``), backward and one
    optimizer update; the loss is a device tensor."""

    def step(sel: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        logits = model.apply(params, coords[sel], None)
        y = losses.one_hot(labels[sel], num_classes)
        loss = torch.mean(losses.weighted_ce(logits, y))
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def distill_to_implicit(teacher_vol: np.ndarray, hidden=(64, 64, 64),
                        steps: int = 500, batch: int = 4096, lr: float = 1e-3,
                        num_classes: int = 4, seed: int = 0, device=None):
    """Train a coords-only implicit MLP (x,y,z) -> class logits on teacher
    labels (reference M8: distilled implicit representation) on ``device``
    (``cuda`` unless given). The batches are drawn on the device from a
    ``torch.Generator`` seeded ``seed``; the optimizer is optax's
    ``adam(lr)``."""
    from mri_raytracer_tpu_torch.config import ModelConfig
    from mri_raytracer_tpu_torch.models.api import build_model

    dev = resolve_device(device)
    cfg = ModelConfig(kind="mlp", hidden_dims=tuple(hidden), fourier_freqs=4,
                      num_classes=num_classes, use_modalities=False)
    model = build_model(cfg, num_modalities=0)
    params = model.init(torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(params.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    coords, labels = collect_voxels(teacher_vol, steps * batch // 4, seed)
    coords_t = torch.as_tensor(coords, device=dev)
    labels_t = torch.as_tensor(labels, device=dev)
    step = make_distill_step(model, params, opt, coords_t, labels_t,
                             num_classes)
    g = torch.Generator(device=dev).manual_seed(seed)
    hist = []
    for i in range(steps):
        sel = torch.randint(0, coords_t.shape[0], (batch,), generator=g,
                            device=dev)
        l = step(sel)
        if i % 50 == 0:
            hist.append(float(l))
    return {"model": model, "params": params, "loss_history": hist}
