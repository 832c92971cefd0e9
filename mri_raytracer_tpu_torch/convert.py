"""Carry state across from the JAX package.

Volumes and labels cross as numpy arrays. What else crosses is the render
parameters and the camera, whose JAX forms are a ``BratsRenderParams`` of
arrays and a packed 13-float camera vector, and the INR's weights, a
pytree of dicts and lists of arrays (also what ``io.checkpoint`` loads),
the fit-from-views field's ``{'B', 'mlp'}`` tree, the ROI policy's
``{'W1', 'b1', 'W2', 'b2'}`` dict, and the U-Net's flax ``{'params',
'batch_stats'}`` variables (both ways).
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
from mri_raytracer_tpu_torch.models.unet import UNet2D
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


# The reference's torch module prefix -> the flax.linen auto-name in the JAX
# package's models.unet.UNet2D (call order fixes the indices).
UNET_BLOCKS = {
    "d1": "DoubleConv_0", "d2": "DoubleConv_1", "d3": "DoubleConv_2",
    "b": "DoubleConv_3", "c3": "DoubleConv_4", "c2": "DoubleConv_5",
    "c1": "DoubleConv_6",
    "u3": "ConvTranspose_0", "u2": "ConvTranspose_1", "u1": "ConvTranspose_2",
    "out": "Conv_0",
}
# Inside a DoubleConv's Sequential: 0 = Conv, 1 = BN, 3 = Conv, 4 = BN.
_DC_INNER = {"0": "Conv_0", "1": "BatchNorm_0", "3": "Conv_1",
             "4": "BatchNorm_1"}


def _unet_pairs(keys):
    """(torch key, flax collection, flax path, kind) of each U-Net state
    key; kind is 'conv', 'convT' (a transposed kernel), or 'copy'."""
    for k in keys:
        parts = k.split(".")
        block = UNET_BLOCKS.get(parts[0])
        if block is None:
            raise KeyError(f"unexpected UNet2D key {k!r}")
        if block.startswith("DoubleConv"):  # d1.net.0.weight
            inner, leaf = _DC_INNER[parts[2]], parts[3]
            if inner.startswith("Conv"):
                yield (k, "params", (block, inner,
                                     "kernel" if leaf == "weight" else "bias"),
                       "conv" if leaf == "weight" else "copy")
            elif leaf in ("weight", "bias"):
                yield (k, "params", (block, inner,
                                     "scale" if leaf == "weight" else "bias"),
                       "copy")
            elif leaf in ("running_mean", "running_var"):
                yield (k, "batch_stats",
                       (block, inner, leaf.split("_")[1]), "copy")
            # num_batches_tracked: flax keeps no count
        else:
            kind = ("convT" if block.startswith("ConvTranspose") else "conv"
                    ) if parts[1] == "weight" else "copy"
            yield (k, "params", (block, "kernel" if parts[1] == "weight"
                                 else "bias"), kind)


def unet_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A state dict for the port's ``models.unet.UNet2D`` (the reference's
    torch layout) from the JAX package's flax ``variables``
    (``{'params', 'batch_stats'}``, numpy or JAX leaves): Conv kernels
    ``(kh, kw, in, out)`` -> ``(out, in, kh, kw)``; ConvTranspose kernels
    ``(kh, kw, in, out)`` -> ``(in, out, kh, kw)`` with the spatial flip of
    ``io/checkpoint.py``'s loader (flax's transposed convolution
    correlates, torch's scatters the kernel as stored); BatchNorm scale and
    bias -> weight and bias, ``batch_stats`` mean / var -> running
    buffers. ``num_batches_tracked`` is 0 (flax keeps no count)."""
    params, stats = variables["params"], variables["batch_stats"]
    base = np.asarray(params["DoubleConv_0"]["Conv_0"]["kernel"]).shape[-1]
    keys = UNet2D(1, 1, base).state_dict().keys()
    out = {}
    for k, coll, path, kind in _unet_pairs(keys):
        node = params if coll == "params" else stats
        for p in path:
            node = node[p]
        v = np.asarray(node, np.float32)
        if kind == "conv":
            v = v.transpose(3, 2, 0, 1)
        elif kind == "convT":
            v = v[::-1, ::-1].transpose(2, 3, 0, 1)
        out[k] = torch.tensor(np.ascontiguousarray(v))
    for k in keys:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.tensor(0)
    return out


def unet_to_flax(model: nn.Module) -> Dict[str, Any]:
    """Inverse of ``unet_from_flax``: the JAX package's ``{'params',
    'batch_stats'}`` tree with numpy leaves from the port's ``UNet2D`` (or
    its state dict), as ``UNet2D.apply`` takes them."""
    state = model.state_dict() if isinstance(model, nn.Module) else model
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for k, coll, path, kind in _unet_pairs(state.keys()):
        v = state[k].detach().cpu().numpy().astype(np.float32)
        if kind == "conv":
            v = v.transpose(2, 3, 1, 0)
        elif kind == "convT":
            v = v.transpose(2, 3, 0, 1)[::-1, ::-1]
        node = tree[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(v)
    return tree
