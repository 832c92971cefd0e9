"""2-D simplex-noise demo frame (port of ``ops/noise2d.py``; reference R5,
``scripts/slang_test/draw.slang:1-126``) — the SlangPy harness's smoke
test as one image function of PyTorch ops.

The reference pipeline per pixel (``draw.slang:104-125``): uv from pixel
coordinates (x-normalized), advected by ``time * 0.1``, warped by two
independent simplex-noise reads, folded into a 0.2-period tile, shaded by
an SDF circle through ``smoothstep(0.2, -0.2, d)``, plus a red
mouse-proximity highlight. The simplex noise is the Ashima/McEwan 2-D
variant (``draw.slang:41-88``): permutation polynomial
``mod289((34 x + 1) x)`` over a 289-ring, diamond-mapped gradients,
quartic falloff, ``130 *`` amplitude normalization.

Every operation is an IEEE float32 add, multiply, floor, compare or
square root, so the card and the CPU compute the same bits; every
divisor (the width, the tile period, the smoothstep span, the pointer
radius) is a tensor on the frame's device: CUDA divides by a host scalar
as a product with its reciprocal, which can move a floor.
"""

from __future__ import annotations

import numpy as np
import torch

from mri_raytracer_tpu_torch.env import device_floats, resolve_device

_CX, _CY = 0.211324865405187, 0.366025403784439
_CZ, _CW = -0.577350269189626, 0.024390243902439


def _mod289(x):
    return x - torch.floor(x * (1.0 / 289.0)) * 289.0


def _permute(x):
    return _mod289((x * 34.0 + 1.0) * x)


def snoise(v: torch.Tensor) -> torch.Tensor:
    """Ashima 2-D simplex noise in [-1, 1]; ``v`` (..., 2) -> (...)."""
    i = torch.floor(v + v.sum(-1, keepdim=True) * _CY)
    x0 = v - i + i.sum(-1, keepdim=True) * _CX

    i1x = (x0[..., 0] >= x0[..., 1]).to(torch.float32)
    i1 = torch.stack([i1x, 1.0 - i1x], dim=-1)
    x1 = x0 + _CX - i1
    x2 = x0 + _CZ

    i = _mod289(i)
    zero, one = torch.zeros_like(i1x), torch.ones_like(i1x)
    base = torch.stack([zero, i1[..., 1], one], dim=-1)
    basex = torch.stack([zero, i1[..., 0], one], dim=-1)
    p = _permute(_permute(i[..., 1:2] + base) + i[..., 0:1] + basex)

    d0 = (x0 * x0).sum(-1)
    d1 = (x1 * x1).sum(-1)
    d2 = (x2 * x2).sum(-1)
    m = torch.clamp(0.5 - torch.stack([d0, d1, d2], dim=-1), min=0.0)
    m = m * m
    m = m * m

    x = 2.0 * (p * _CW - torch.floor(p * _CW)) - 1.0
    h = torch.abs(x) - 0.5
    ox = torch.floor(x + 0.5)
    a0 = x - ox
    m = m * (1.79284291400159 - 0.85373472095314 * (a0 * a0 + h * h))

    g = torch.stack([a0[..., 0] * x0[..., 0] + h[..., 0] * x0[..., 1],
                     a0[..., 1] * x1[..., 0] + h[..., 1] * x1[..., 1],
                     a0[..., 2] * x2[..., 0] + h[..., 2] * x2[..., 1]],
                    dim=-1)
    return 130.0 * (m * g).sum(-1)


def snoise01(v: torch.Tensor) -> torch.Tensor:
    """Noise remapped to [0, 1] (``draw.slang:90-93``)."""
    return snoise(v) * 0.5 + 0.5


def _repeat(p, size):
    return (p / size + 0.5) - torch.floor(p / size + 0.5) - 0.5


def render_noise_demo(width: int, height: int, time,
                      mouse_pos=None, mouse_radius=64.0,
                      noise_scale=4.0, noise_amount=0.08,
                      device=None) -> torch.Tensor:
    """One frame of the animated demo -> (H, W, 3) float32 in [0, ~1] on
    ``device`` (``cuda`` unless given).

    Matches ``draw.slang:104-125``: uv = pixel / width (x-normalized),
    advected by ``time * 0.1``; uv.x warped by simplex noise, then uv.y
    warped by a second read at the x-warped uv plus a (13, 17) offset;
    0.2-period tiled SDF circles of radius 0.25 shaded by
    smoothstep(0.2, -0.2, d); a red highlight of ``mouse_radius`` pixels
    around ``mouse_pos`` (the pointer-interaction analog — None for no
    pointer)."""
    dev = resolve_device(device)
    t = float(np.float32(time))
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    pxb, pyb = px.expand(height, width), py.expand(height, width)
    uv = torch.stack([pxb, pyb], dim=-1) / device_floats([width], dev)[0]
    uv = uv + float(np.float32(t) * np.float32(0.1))
    # Sequential warp, matching draw.slang:117-118: uv.x shifts first and
    # the y-warp noise is read at the already-x-warped position.
    wx = snoise(uv * noise_scale) * noise_amount
    uv = torch.stack([uv[..., 0] + wx, uv[..., 1]], dim=-1)
    off = device_floats([13.0, 17.0], dev)
    wy = snoise((uv + off) * noise_scale) * noise_amount
    uv = torch.stack([uv[..., 0], uv[..., 1] + wy], dim=-1)
    period, span = device_floats([0.2, -0.2 - 0.2], dev)
    p = _repeat(uv, period)
    d = torch.sqrt((p * p).sum(-1)) - 0.25
    s = torch.clamp((d - 0.2) / span, 0.0, 1.0)
    val = s * s * (3.0 - 2.0 * s)  # smoothstep(0.2, -0.2, d)
    color = val[..., None].repeat(1, 1, 3)
    if mouse_pos is not None:
        mx, my = (float(np.float32(float(v))) for v in mouse_pos)
        dist = torch.sqrt((pxb - mx) ** 2 + (pyb - my) ** 2)
        r = device_floats([max(float(np.float32(mouse_radius)), 1e-6)],
                          dev)[0]
        sm = torch.clamp(dist / r, 0.0, 1.0)
        glow = 1.0 - sm * sm * (3.0 - 2.0 * sm)  # smoothstep(r, 0, dist)
        red = device_floats([1.0, 0.0, 0.0], dev)
        color = color + glow[..., None] * red
    return color
