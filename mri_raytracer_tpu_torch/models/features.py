"""Coordinate encodings (port of ``models/features.py``).

  * deterministic harmonics sin/cos(pi*k*x), k=1..K per axis
    (reference ``inr/inr/model.py:11-18``)
  * random Fourier features sin/cos(2*pi*x@B), B ~ N(0, sigma^2)
    (reference ``scripts/jax_inr_brats.py:105-128``)
  * anisotropic *learnable* features, B ~ N(0, sigma^2)/voxel_spacing,
    trained with the rest of the params (reference ``improved.ipynb §6``)

Random draws take a ``torch.Generator``; they cannot equal ``jax.random``'s
from the same seed, so weights cross from the JAX package through
``convert.inr_params_from_numpy``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def fourier_features(coords: torch.Tensor, k: int) -> torch.Tensor:
    """(B, dim) -> (B, dim*2k) deterministic harmonics, per axis the block
    [sin k=1..K | cos k=1..K] (the separable first layer of
    ``ops/neural_march.py`` slices W1 on that column order)."""
    B, dim = coords.shape
    freqs = torch.arange(1, k + 1, dtype=coords.dtype, device=coords.device)
    ang = coords[..., None] * freqs[None, None, :] * math.pi  # (B, dim, k)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1) \
        .reshape(B, dim * 2 * k)


def init_rff(generator: torch.Generator, in_dim: int, rff_dim: int,
             sigma: float) -> torch.Tensor:
    """Fixed (non-trainable) Gaussian projection matrix (3, F)."""
    return torch.randn((in_dim, rff_dim), generator=generator) * sigma


def rff_features(coords: torch.Tensor, rff_B: torch.Tensor) -> torch.Tensor:
    ang = 2.0 * math.pi * (coords @ rff_B)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_anisotropic_features(generator: torch.Generator, in_dim: int,
                              num_features: int, sigma: float,
                              voxel_spacing: Sequence[float]) -> torch.Tensor:
    """Trainable projection scaled inversely by per-axis voxel spacing."""
    spacing = torch.as_tensor(voxel_spacing, dtype=torch.float32)
    B = torch.randn((in_dim, num_features), generator=generator) * sigma
    return B / spacing[:, None]


def apply_anisotropic_features(coords: torch.Tensor,
                               B: torch.Tensor) -> torch.Tensor:
    ang = 2.0 * math.pi * (coords @ B)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def feature_dim(coord_dim: int, fourier_freqs: int, rff_dim: int) -> int:
    if rff_dim > 0:
        return 2 * rff_dim
    return coord_dim * 2 * fourier_freqs


def build_input(coords: torch.Tensor, intensities: Optional[torch.Tensor],
                fourier_freqs: int = 0,
                rff_B: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[coords | features(coords) | intensities] concat (reference
    ``build_input``). ``rff_B`` (fixed or trainable) overrides harmonics."""
    parts = [coords]
    if rff_B is not None:
        parts.append(rff_features(coords, rff_B))
    elif fourier_freqs > 0:
        parts.append(fourier_features(coords, fourier_freqs))
    if intensities is not None:
        parts.append(intensities)
    return torch.cat(parts, dim=-1)
