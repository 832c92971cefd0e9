"""Unified model front-end: config -> (init, apply) pair (port of
``models/api.py``).

``init(generator) -> params`` builds the model's ``nn.Module`` (on the
CPU; move it with ``.to``); ``apply(params, coords, intensities, rng=None,
train=False) -> logits``. The training engine, the evaluator and the neural
march drive every kind through this one interface, as in the JAX package.

The fixed RFF projection ``rff_B`` is drawn by ``jax.random`` in the JAX
package, which torch cannot reproduce, so ``build_model`` takes it as an
argument (``convert.inr_params_from_numpy`` carries it across); without
one it draws its own from a ``torch.Generator`` seeded ``rff_seed``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from mri_raytracer_tpu_torch.config import ModelConfig
from mri_raytracer_tpu_torch.models import features, mlp


class AnisoMLP(nn.Module):
    """Plain MLP behind learnable anisotropic features: the JAX
    ``{"B": (3, F), "layers": [...]}`` params."""

    def __init__(self, B: torch.Tensor, layers: mlp.MLP):
        super().__init__()
        self.B = nn.Parameter(B)
        self.layers = layers


@dataclass(eq=False)
class ModelBundle:
    cfg: ModelConfig
    num_modalities: int
    input_dim: int
    init: Callable[[torch.Generator], nn.Module]
    apply: Callable[..., torch.Tensor]
    # Fixed (non-trainable) RFF projection, if configured.
    rff_B: Optional[torch.Tensor] = None


def build_model(cfg: ModelConfig, num_modalities: int, coord_dim: int = 3,
                rff_seed: int = 0,
                rff_B: Optional[Any] = None) -> ModelBundle:
    mod_dim = num_modalities if cfg.use_modalities else 0
    fixed_B = None
    if cfg.rff_dim > 0 and not cfg.aniso_features:
        if rff_B is None:
            fixed_B = features.init_rff(
                torch.Generator().manual_seed(rff_seed), coord_dim,
                cfg.rff_dim, cfg.rff_sigma)
        else:
            fixed_B = torch.as_tensor(np.array(rff_B, np.float32))
            if tuple(fixed_B.shape) != (coord_dim, cfg.rff_dim):
                raise ValueError(f"rff_B must be ({coord_dim}, {cfg.rff_dim})"
                                 f", got {tuple(fixed_B.shape)}")

    if cfg.aniso_features:
        feat_dim = 2 * cfg.rff_dim if cfg.rff_dim > 0 else 2 * 64
        n_feat = feat_dim // 2
    else:
        feat_dim = features.feature_dim(coord_dim, cfg.fourier_freqs,
                                        cfg.rff_dim)
    in_dim = coord_dim + feat_dim + mod_dim

    def fixed(coords):
        return None if fixed_B is None else fixed_B.to(coords.device)

    kind = cfg.kind
    if kind == "mlp":
        if cfg.aniso_features:
            def init(generator):
                B = features.init_anisotropic_features(
                    generator, coord_dim, n_feat, cfg.aniso_sigma,
                    cfg.voxel_spacing)
                return AnisoMLP(B, mlp.init_mlp(generator, in_dim,
                                                cfg.hidden_dims,
                                                cfg.num_classes))

            def apply(params, coords, intensities, rng=None, train=False,
                      **_kw):
                ff = features.apply_anisotropic_features(coords, params.B)
                parts = [coords, ff]
                if mod_dim:
                    parts.append(intensities)
                return params.layers(torch.cat(parts, dim=-1))
        else:
            def init(generator):
                return mlp.init_mlp(generator, in_dim, cfg.hidden_dims,
                                    cfg.num_classes)

            def apply(params, coords, intensities, rng=None, train=False,
                      freq_dropout: float = 0.0):
                x = features.build_input(coords,
                                         intensities if mod_dim else None,
                                         cfg.fourier_freqs, fixed(coords))
                if train and freq_dropout > 0.0 and rng is not None \
                        and feat_dim > 0:
                    # Fourier-frequency dropout (reference L5,
                    # scripts/jax_inr_brats.py:212-221): zero random FF
                    # columns.
                    u = torch.rand((feat_dim,), generator=rng,
                                   device=rng.device).to(x.device)
                    mask = (u > freq_dropout).to(x.dtype)
                    x = torch.cat([x[:, :coord_dim],
                                   x[:, coord_dim:coord_dim + feat_dim]
                                   * mask[None, :],
                                   x[:, coord_dim + feat_dim:]], dim=-1)
                return params(x)

    elif kind == "siren":
        def init(generator):
            return mlp.init_siren(generator, in_dim, cfg.hidden_dims,
                                  cfg.num_classes, w0=cfg.siren_w0)

        def apply(params, coords, intensities, rng=None, train=False, **_kw):
            x = features.build_input(coords, intensities if mod_dim else None,
                                     cfg.fourier_freqs, fixed(coords))
            return params(x)

    elif kind == "coord_injection":
        coord_feat_dim = coord_dim + feat_dim

        def init(generator):
            return mlp.init_coord_injection_mlp(generator, coord_feat_dim,
                                                mod_dim, cfg.hidden_dims,
                                                cfg.num_classes)

        def apply(params, coords, intensities, rng=None, train=False, **_kw):
            cf = features.build_input(coords, None, cfg.fourier_freqs,
                                      fixed(coords))
            m = intensities if mod_dim else \
                coords.new_zeros((coords.shape[0], 0))
            return params(cf, m, dropout=cfg.dropout, rng=rng, train=train)
    else:
        raise ValueError(f"unknown model kind {kind!r}")

    return ModelBundle(cfg=cfg, num_modalities=num_modalities,
                       input_dim=in_dim, init=init, apply=apply,
                       rff_B=fixed_B)
