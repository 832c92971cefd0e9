"""2-D U-Net segmentation baseline (port of ``models/unet.py``, reference
M7, ``Final-1.ipynb §4``).

Architecture parity: 4-level encoder/decoder, DoubleConv =
(conv3x3 -> BN -> ReLU) x2, maxpool downs, transposed-conv ups with skip
concats, 1x1 head; in_ch=4 modalities -> 4 classes, base width 32.

The modules keep the reference's torch layout (``d1 d2 d3 b u3 c3 u2 c2 u1
c1 out``, ``DoubleConv.net`` = Sequential(Conv, BN, ReLU, Conv, BN, ReLU),
pinned by ``tests/test_torch_interop.py``), so a reference ``.pth`` loads
with ``load_state_dict`` as it is. Inside, the net is NCHW; ``unet_apply``
takes and returns the JAX package's NHWC. ``convert.unet_from_flax`` /
``unet_to_flax`` carry weights across.

BatchNorm follows flax's ``nn.BatchNorm`` (``FlaxBatchNorm2d``): running
averages with flax's momentum 0.99 (torch's convention: ``momentum=0.01``)
over the **biased** batch variance, ``E[x^2] - E[x]^2`` as flax computes
it (``nn.BatchNorm2d`` folds in the unbiased one), eps 1e-5.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal: a normal truncated to [-2, 2] whose std is 1 after
# truncation (std / this constant), scaled by sqrt(1 / fan_in).
_TRUNC_STD = 0.87962566103423978


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters and buffers, so a reference
    state dict loads) whose training step updates the running averages as
    flax's ``BatchNorm(momentum=0.99)`` does: ``0.99 * r + 0.01 * s`` with
    the biased batch variance. Normalization in training uses the batch
    statistics, in evaluation the running ones, as in both libraries."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            mean = x.mean((0, 2, 3))
            var = torch.clamp(torch.square(x).mean((0, 2, 3))
                              - torch.square(mean), min=0.0)
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class DoubleConv(nn.Module):
    """(conv3x3 -> BN -> ReLU) x 2 under ``net``, the reference's layout."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(c_in, c_out, 3, padding=1), FlaxBatchNorm2d(c_out),
            nn.ReLU(),
            nn.Conv2d(c_out, c_out, 3, padding=1), FlaxBatchNorm2d(c_out),
            nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class UNet2D(nn.Module):
    """NCHW in, NCHW logits out; H and W divisible by 8 (3 poolings)."""

    def __init__(self, in_ch: int = 4, n_classes: int = 4, base: int = 32):
        super().__init__()
        b = base
        self.n_classes, self.base = n_classes, base
        self.d1 = DoubleConv(in_ch, b)
        self.d2 = DoubleConv(b, b * 2)
        self.d3 = DoubleConv(b * 2, b * 4)
        self.b = DoubleConv(b * 4, b * 8)
        self.u3 = nn.ConvTranspose2d(b * 8, b * 4, 2, stride=2)
        self.c3 = DoubleConv(b * 8, b * 4)
        self.u2 = nn.ConvTranspose2d(b * 4, b * 2, 2, stride=2)
        self.c2 = DoubleConv(b * 4, b * 2)
        self.u1 = nn.ConvTranspose2d(b * 2, b, 2, stride=2)
        self.c1 = DoubleConv(b * 2, b)
        self.out = nn.Conv2d(b, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.d1(x)
        x2 = self.d2(F.max_pool2d(x1, 2))
        x3 = self.d3(F.max_pool2d(x2, 2))
        xb = self.b(F.max_pool2d(x3, 2))
        y = self.c3(torch.cat([self.u3(xb), x3], 1))
        y = self.c2(torch.cat([self.u2(y), x2], 1))
        y = self.c1(torch.cat([self.u1(y), x1], 1))
        return self.out(y)


@torch.no_grad()
def create_unet(generator: torch.Generator, in_ch: int = 4,
                n_classes: int = 4, base: int = 32,
                image_size: Tuple[int, int] = (64, 64)) -> UNet2D:
    """A ``UNet2D`` on the CPU (move it with ``.to(device)``) with flax's
    initializers, drawn from ``generator``: every convolution kernel
    lecun_normal (fan_in = input channels x kernel area, transposed ones
    too), biases 0, BatchNorm scale 1 and bias 0, running mean 0 and
    variance 1. The values cannot equal ``jax.random``'s. ``image_size``
    (each side divisible by 8) is checked, as the JAX package initializes
    on such an input."""
    if any(s % 8 for s in image_size):
        raise ValueError(f"image_size {image_size}: each side must be "
                         "divisible by 8 (3 poolings)")
    model = UNet2D(in_ch, n_classes, base)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            c_in = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) \
                else w.shape[1]
            std = (1.0 / (c_in * w.shape[2] * w.shape[3])) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            w.mul_(std)
            mod.bias.zero_()
    return model


def unet_apply(model: UNet2D, x: torch.Tensor, train: bool = False
               ) -> torch.Tensor:
    """Logits (N, H, W, C) of NHWC images ``x``. ``train=True`` normalizes
    with the batch statistics and updates the running averages in place
    (the JAX package returns them as ``batch_stats``); ``train=False``
    uses the running averages and builds no graph."""
    model.train(train)
    with torch.set_grad_enabled(train and torch.is_grad_enabled()):
        out = model(x.permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1)
