"""Carry state across from the JAX package.

Volumes and labels cross as numpy arrays. What else crosses is the render
parameters and the camera, whose JAX forms are a ``BratsRenderParams`` of
arrays and a packed 13-float camera vector, and the INR's weights, a
pytree of dicts and lists of arrays (also what ``io.checkpoint`` loads),
the fit-from-views field's ``{'B', 'mlp'}`` tree, and the ROI policy's
``{'W1', 'b1', 'W2', 'b2'}`` dict.
This module turns their numpy values into the port's tensors and modules
without importing anything of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from mri_raytracer_tpu_torch.config import ModelConfig
from mri_raytracer_tpu_torch.models import features
from mri_raytracer_tpu_torch.models.api import ModelBundle, build_model
from mri_raytracer_tpu_torch.models.mlp import MLP, Dense, RffField
from mri_raytracer_tpu_torch.render.camera import CameraBasis, unpack_basis
from mri_raytracer_tpu_torch.render.params import BratsRenderParams


def render_params_from_numpy(
        leaves: Union[Mapping[str, np.ndarray], Sequence[np.ndarray]],
        device: Union[str, torch.device] = "cpu") -> BratsRenderParams:
    """The port's params from the leaves of a JAX ``BratsRenderParams``:
    either ``{field: array}`` (``p._asdict()``) or the leaves in field
    order (``tuple(p)``), as numpy arrays or anything ``np.asarray`` takes."""
    fields = BratsRenderParams._fields
    if isinstance(leaves, Mapping):
        missing = set(fields) - set(leaves)
        if missing:
            raise ValueError(f"missing params fields: {sorted(missing)}")
        values = [leaves[f] for f in fields]
    else:
        values = list(leaves)
        if len(values) != len(fields):
            raise ValueError(f"expected {len(fields)} params leaves, "
                             f"got {len(values)}")
    return BratsRenderParams(*(
        torch.as_tensor(np.asarray(v, np.float32), device=device)
        for v in values))


def camera_from_packed(vec, device: Union[str, torch.device] = "cpu"
                       ) -> CameraBasis:
    """The port's ``CameraBasis`` from a packed (13,) camera
    (``CameraBasis.pack()`` of either package)."""
    vec = np.asarray(vec, np.float32).reshape(-1)
    if vec.shape != (13,):
        raise ValueError(f"packed camera must have 13 floats, got {vec.shape}")
    return unpack_basis(torch.as_tensor(vec, device=device))


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'a.0.W': leaf} state-dict keys of a pytree of dicts and lists."""
    if isinstance(tree, Mapping):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: np.asarray(tree, np.float32)}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}."))
    return out


def inr_params_from_numpy(tree: Any, cfg: Union[ModelConfig, Mapping],
                          rff_B=None,
                          device: Union[str, torch.device] = "cpu"
                          ) -> Tuple[ModelBundle, nn.Module]:
    """The port's ``(model, params)`` from a JAX INR params pytree with
    numpy leaves (``jax.tree_util.tree_map(np.asarray, params)``, or what
    ``io.checkpoint.load_params`` returns): a list of ``{'W', 'b'}`` (mlp,
    coord_injection), ``{'l0': ..}`` (siren) or ``{'B', 'layers'}`` (mlp
    with anisotropic features). ``cfg`` is a ``ModelConfig`` or its fields
    as a mapping (``dataclasses.asdict`` of the JAX config). ``rff_B`` is
    the JAX bundle's fixed RFF projection, needed when ``cfg.rff_dim > 0``
    (torch cannot redraw it). The modality count is read off the first
    layer's fan-in. Raises if a key or a shape does not fit the config."""
    if not isinstance(cfg, ModelConfig):
        names = {f.name for f in dataclasses.fields(ModelConfig)}
        cfg = ModelConfig(**{k: v for k, v in cfg.items() if k in names})
    if cfg.rff_dim > 0 and not cfg.aniso_features and rff_B is None:
        raise ValueError("cfg.rff_dim > 0: pass the JAX bundle's rff_B")
    state = flatten_tree(tree)
    first = state.get("layers.0.W", state.get("0.W", state.get("l0.W")))
    if first is None:
        raise KeyError(f"no first-layer weight among {sorted(state)}")
    if cfg.aniso_features:
        feat_dim = 2 * cfg.rff_dim if cfg.rff_dim > 0 else 2 * 64
    else:
        feat_dim = features.feature_dim(3, cfg.fourier_freqs, cfg.rff_dim)
    mod_dim = first.shape[0] - 3 - feat_dim
    if mod_dim < 0 or (mod_dim and not cfg.use_modalities):
        raise ValueError(f"first layer fan-in {first.shape[0]} does not fit "
                         f"the config (coords + features = {3 + feat_dim})")
    model = build_model(cfg, num_modalities=mod_dim, rff_B=rff_B)
    params = model.init(torch.Generator().manual_seed(0))
    try:
        params.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    except RuntimeError as e:  # missing or unexpected keys, wrong shapes
        raise ValueError(f"params do not fit the config: {e}") from None
    return model, params.to(device)


def fit_params_from_numpy(tree: Mapping[str, Any],
                          device: Union[str, torch.device] = "cpu"
                          ) -> RffField:
    """The port's ``RffField`` from a JAX fit-from-views params tree
    ``{'B': (3, F), 'mlp': [{'W', 'b'}, ...]}`` (``train/fit_views.py``'s
    ``init_inr_field`` / ``init_modality_inr``) with numpy leaves. The
    layer widths are read off the arrays."""
    state = flatten_tree(tree)
    n_layers = len({k.split(".")[1] for k in state if k.startswith("mlp.")})
    try:
        mlp = MLP(Dense(torch.tensor(state[f"mlp.{i}.W"]),
                        torch.tensor(state[f"mlp.{i}.b"]))
                  for i in range(n_layers))
        field = RffField(torch.tensor(state["B"]), mlp)
    except KeyError as e:
        raise ValueError(f"not a fit params tree: missing {e}") from None
    extra = set(state) - set(field.state_dict())
    if extra:
        raise ValueError(f"not a fit params tree: unexpected {sorted(extra)}")
    return field.to(device)


def fit_params_to_numpy(field: RffField) -> Dict[str, Any]:
    """Inverse of ``fit_params_from_numpy``: the JAX tree with numpy
    leaves."""
    cpu = lambda t: t.detach().cpu().numpy()
    return {"B": cpu(field.B),
            "mlp": [{"W": cpu(layer.W), "b": cpu(layer.b)}
                    for layer in field.mlp]}


ROI_POLICY_KEYS = ("W1", "b1", "W2", "b2")


def roi_policy_from_numpy(tree: Mapping[str, Any],
                          device: Union[str, torch.device] = "cpu"
                          ) -> Dict[str, torch.Tensor]:
    """The port's ROI policy (``ops/roi_policy``: a dict of float32
    tensors) from the JAX package's policy dict with numpy leaves
    (``{k: np.asarray(v)}`` of ``init_policy`` / ``train_policy`` /
    ``load_policy``). Raises on missing or unexpected keys."""
    if set(tree) != set(ROI_POLICY_KEYS):
        raise ValueError(f"not a ROI policy: keys {sorted(tree)}, want "
                         f"{sorted(ROI_POLICY_KEYS)}")
    return {k: torch.as_tensor(np.asarray(tree[k], np.float32),
                               device=device) for k in ROI_POLICY_KEYS}


def roi_policy_to_numpy(policy: Mapping[str, torch.Tensor]
                        ) -> Dict[str, np.ndarray]:
    """Inverse of ``roi_policy_from_numpy``: float32 numpy leaves."""
    return {k: policy[k].detach().cpu().numpy().astype(np.float32)
            for k in ROI_POLICY_KEYS}
