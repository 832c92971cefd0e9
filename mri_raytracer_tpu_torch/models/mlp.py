"""INR model family (port of ``models/mlp.py``).

Each model is an ``nn.Module`` whose weights keep the JAX package's layout,
so checkpoints and converted params map one to one:

  * ``MLP``   — plain ReLU MLP, a list of ``Dense`` layers (the JAX list of
    ``{'W', 'b'}``), Glorot-uniform (reference ``inr/inr/model.py:26-51``)
  * ``Siren`` — sine activations, layers ``l0 .. l{n-1}`` (the JAX
    ``l{i}`` dicts), w0 first-layer scale (``neumors_inr_jax.ipynb §14``)
  * ``CoordInjectionMLP`` — re-injects coords at hidden layers {1,2,3} and
    modality intensities at {2}, with inverted dropout
    (reference ``improved.ipynb §7``)
  * ``RffField`` — trainable RFF projection ``B`` + ``MLP``, the fields of
    ``train/fit_views.py``

``Dense.W`` is (in, out) and a layer computes ``x @ W + b``, as in JAX.
Init draws from an explicit ``torch.Generator`` with the JAX package's
distributions; the values cannot equal ``jax.random``'s.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from mri_raytracer_tpu_torch.models.features import rff_features


class Dense(nn.Module):
    """``x @ W + b`` with ``W`` (in, out)."""

    def __init__(self, W: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.W = nn.Parameter(W)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.W + self.b


def glorot(generator: torch.Generator, shape, dtype=torch.float32
           ) -> torch.Tensor:
    fan_in, fan_out = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=dtype).uniform_(-limit, limit,
                                                   generator=generator)


# ------------------------------------------------------------------ plain MLP
class MLP(nn.ModuleList):
    """Plain ReLU MLP: a list of ``Dense`` layers, ReLU after all but the
    last."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *hidden, last = self
        h = x
        for layer in hidden:
            h = torch.relu(layer(h))
        return last(h)


def init_mlp(generator: torch.Generator, in_dim: int,
             hidden_dims: Sequence[int], out_dim: int,
             dtype=torch.float32) -> MLP:
    dims = [in_dim] + list(hidden_dims) + [out_dim]
    return MLP(Dense(glorot(generator, (dims[i], dims[i + 1]), dtype),
                     torch.zeros((dims[i + 1],), dtype=dtype))
               for i in range(len(dims) - 1))


# --------------------------------------------------------------------- SIREN
class Siren(nn.Module):
    """Sine MLP with layers ``l0 .. l{n-1}``: sin(w0 * (x W0 + b0)) first,
    sin(h W + b) after, linear head."""

    def __init__(self, layers: Sequence[Dense], w0: float = 30.0):
        super().__init__()
        self.w0 = float(w0)
        self.n_layers = len(layers)
        for i, layer in enumerate(layers):
            self.add_module(f"l{i}", layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n_layers
        h = x
        for i in range(n - 1):
            scale = self.w0 if i == 0 else 1.0
            h = torch.sin(scale * getattr(self, f"l{i}")(h))
        return getattr(self, f"l{n - 1}")(h)


def init_siren(generator: torch.Generator, in_dim: int,
               hidden_dims: Sequence[int], out_dim: int,
               w0: float = 30.0) -> Siren:
    """SIREN init: U(-1/n, 1/n) first layer, U(-sqrt(6/n)/w0, ...) after."""
    dims = [in_dim] + list(hidden_dims) + [out_dim]
    layers = []
    for i in range(len(dims) - 1):
        n = dims[i]
        lim = 1.0 / n if i == 0 else math.sqrt(6.0 / n) / w0
        W = torch.empty((dims[i], dims[i + 1])).uniform_(-lim, lim,
                                                        generator=generator)
        layers.append(Dense(W, torch.zeros((dims[i + 1],))))
    return Siren(layers, w0)


# ------------------------------------------------- coordinate-injection MLP
class CoordInjectionMLP(nn.ModuleList):
    """Hidden layer i > 0 re-receives the coordinate features when i is in
    ``inject_coords_at`` and the modalities when i is in
    ``inject_mods_at``, widening its fan-in."""

    def __init__(self, layers: Sequence[Dense],
                 inject_coords_at: Sequence[int] = (1, 2, 3),
                 inject_mods_at: Sequence[int] = (2,)):
        super().__init__(layers)
        self.inject_coords_at = tuple(inject_coords_at)
        self.inject_mods_at = tuple(inject_mods_at)

    def forward(self, coord_feats: torch.Tensor, modalities: torch.Tensor,
                dropout: float = 0.0,
                rng: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
        """Inverted dropout on hidden activations when training."""
        h = torch.cat([coord_feats, modalities], dim=-1)
        *hidden, last = self
        for i, layer in enumerate(hidden):
            extra = []
            if i in self.inject_coords_at and i > 0:
                extra.append(coord_feats)
            if i in self.inject_mods_at and i > 0:
                extra.append(modalities)
            if extra:
                h = torch.cat([h] + extra, dim=-1)
            h = torch.relu(layer(h))
            if train and dropout > 0.0 and rng is not None:
                keep = 1.0 - dropout
                u = torch.rand(h.shape, generator=rng, device=rng.device)
                h = torch.where(u.to(h.device) < keep, h / keep, 0.0)
        return last(h)


def init_coord_injection_mlp(generator: torch.Generator, coord_feat_dim: int,
                             modality_dim: int, hidden_dims: Sequence[int],
                             out_dim: int,
                             inject_coords_at: Sequence[int] = (1, 2, 3),
                             inject_mods_at: Sequence[int] = (2,)
                             ) -> CoordInjectionMLP:
    dims_in = []
    prev = coord_feat_dim + modality_dim
    for i, h in enumerate(hidden_dims):
        extra = (coord_feat_dim if i in inject_coords_at else 0) + \
                (modality_dim if i in inject_mods_at else 0)
        dims_in.append(prev + extra)
        prev = h
    dims_in.append(prev)  # output layer fan-in
    dims_out = list(hidden_dims) + [out_dim]
    return CoordInjectionMLP(
        [Dense(glorot(generator, (di, do)), torch.zeros((do,)))
         for di, do in zip(dims_in, dims_out)],
        inject_coords_at, inject_mods_at)


# ------------------------------------------------ RFF field (fit-from-views)
class RffField(nn.Module):
    """The fit-from-views field's params ``{'B': (3, F), 'mlp': [...]}``
    (``train/fit_views.py:97-103,227-233``): random Fourier features of
    the coordinates through a plain MLP. ``B`` is trained with the MLP, as
    the JAX fits differentiate the whole tree."""

    def __init__(self, B: torch.Tensor, mlp: MLP):
        super().__init__()
        self.B = nn.Parameter(B)
        self.mlp = mlp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(rff_features(x, self.B))


def count_params(params: nn.Module) -> int:
    return sum(int(t.numel()) for t in params.parameters())
