"""Analytic SDF sphere tracer (port of ``ops/sdf.py``; reference R4,
``scripts/raymarch/raymarch.slang``).

All pixels trace in lockstep with per-ray convergence masks over a fixed
trip count — the analog of the shader's divergent ``[loop]``, with no
device sync. Scene SDFs are plain Python callables of a (..., 3) tensor;
the default scene matches the reference (sphere radius 0.6 at the origin)
as does the shading: spherical-UV color on hit, vertical sky gradient on
miss.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from mri_raytracer_tpu_torch.env import device_floats, resolve_device
from mri_raytracer_tpu_torch.render.camera import CameraBasis, camera_rays


def _length(p: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(p, axis=-1)``. Both accumulate the squares with
    fused multiply-adds on the CPU (a plain ``sqrt(sum(p * p))`` rounds
    differently, and the normal estimate's differences amplify that)."""
    return torch.linalg.vector_norm(p, dim=-1)


def sd_sphere(p: torch.Tensor, r: float = 0.6) -> torch.Tensor:
    return _length(p) - r


def sd_plane(p: torch.Tensor, n, h: float) -> torch.Tensor:
    n = torch.as_tensor(n, dtype=p.dtype, device=p.device)
    return p @ (n / _length(n)) + h


def sd_box(p: torch.Tensor, b) -> torch.Tensor:
    q = torch.abs(p) - torch.as_tensor(b, dtype=p.dtype, device=p.device)
    return (_length(torch.clamp(q, min=0.0))
            + torch.clamp(torch.amax(q, dim=-1), max=0.0))


def sd_union(*ds):
    return functools.reduce(torch.minimum, ds)


def default_scene(p: torch.Tensor) -> torch.Tensor:
    """Reference scene: a single sphere of radius 0.6 (raymarch.slang:27-30)."""
    return sd_sphere(p, 0.6)


class SdfParams(NamedTuple):
    max_steps: object  # () int32
    max_distance: object  # ()
    hit_threshold: object  # ()
    normal_eps: object  # ()


def default_sdf_params(max_steps: int = 96, max_distance: float = 20.0,
                       hit_threshold: float = 1e-3,
                       normal_eps: float = 1e-3) -> SdfParams:
    return SdfParams(np.int32(max_steps), np.float32(max_distance),
                     np.float32(hit_threshold), np.float32(normal_eps))


_TETRA = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
          (1.0, 1.0, 1.0))


def estimate_normal(sdf: Callable, p: torch.Tensor, eps) -> torch.Tensor:
    """Tetrahedral finite differences (raymarch.slang:33-41)."""
    k = torch.tensor(_TETRA, dtype=torch.float32, device=p.device)
    d = torch.stack([sdf(p + eps * k[i]) for i in range(4)], dim=-1)
    n = (d[..., 0:1] * k[0] + d[..., 1:2] * k[1]
         + d[..., 2:3] * k[2] + d[..., 3:4] * k[3])
    return n / torch.clamp(_length(n)[..., None], min=1e-12)


def render_sdf(basis: CameraBasis, params: SdfParams, width: int = 512,
               height: int = 512, sdf: Callable = default_scene,
               max_steps: int = 256, device=None) -> torch.Tensor:
    """Sphere-trace all pixels -> (H, W, 3) on ``device`` (``cuda`` unless
    given). Step is clamped to [0.01, 0.25] exactly like the reference
    (raymarch.slang:79). Both step counts apply, as in JAX: steps at or
    past ``params.max_steps`` change nothing, so the loop stops at the
    smaller of the two."""
    dev = resolve_device(device)
    ro, rd = camera_rays(basis.to(dev), width, height)
    thr = float(np.float32(params.hit_threshold))
    max_dist = float(np.float32(params.max_distance))

    t = torch.zeros((height, width), dtype=torch.float32, device=dev)
    hit = torch.zeros((height, width), dtype=torch.bool, device=dev)
    for _ in range(min(int(max_steps), int(params.max_steps))):
        d = sdf(ro + t[..., None] * rd)
        hit = hit | (d < thr)
        advance = (~hit) & (t <= max_dist)
        t = torch.where(advance, t + torch.clamp(d, 0.01, 0.25), t)

    p = ro + t[..., None] * rd
    # Hit: spherical-UV coloring on the unit normal (raymarch.slang:85-90).
    n = p / torch.clamp(_length(p)[..., None], min=1e-12)
    u = torch.atan2(n[..., 2], n[..., 0]) / (2.0 * math.pi) + 0.5
    v = n[..., 1] * 0.5 + 0.5
    hit_color = torch.stack([u, v, 1.0 - u], dim=-1)
    # Miss: vertical sky gradient (raymarch.slang:93-95).
    tbg = 0.5 * (rd[..., 1] + 1.0)
    sky = ((1.0 - tbg[..., None]) * device_floats([0.05, 0.06, 0.08], dev)
           + tbg[..., None] * device_floats([0.2, 0.25, 0.3], dev))
    return torch.where(hit[..., None], hit_color, sky)
