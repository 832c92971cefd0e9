"""Checkpoint writers and loaders (port of ``io/checkpoint.py:27-98``).

The JAX package's two on-disk formats are plain numpy, so they are read and
written here without JAX, and a file written by either package loads in the
other:
  * flat:   ``np.savez_compressed(W_0, b_0, W_1, ...)`` (``save_flat``)
  * object: a 0-d object array under key ``params`` holding the params
            pytree of dicts and lists of numpy arrays (``save_object``),
            with a ``{stem}_info.json`` sidecar carrying the config

``load_params`` returns that numpy pytree; ``convert.inr_params_from_numpy``
turns it into the port's model. The writers take either such a pytree or
the port's model (an ``nn.Module`` whose state-dict keys spell the JAX
layout, ``models/mlp.py``). The object format is a pickle: load only
checkpoints this project wrote.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def params_to_numpy(params: Any) -> Any:
    """The JAX params pytree (dicts and lists of numpy arrays) of the port's
    model, rebuilt from its state-dict keys ('0.W' -> [{'W'}], 'l0.W' ->
    {'l0': {'W'}}, 'layers.0.W' -> {'layers': [...]}); a pytree is returned
    as it is."""
    if not hasattr(params, "state_dict"):
        return params
    tree: Dict[str, Any] = {}
    for key, value in params.state_dict().items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def save_flat(params: Any, path) -> None:
    """Flat {W_i, b_i} npz (list-of-layer-dicts models only)."""
    flat = {}
    for i, layer in enumerate(params_to_numpy(params)):
        flat[f"W_{i}"] = np.asarray(layer["W"])
        flat[f"b_{i}"] = np.asarray(layer["b"])
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)


def save_object(params: Any, path,
                info: Optional[Dict[str, Any]] = None) -> None:
    """Object-array npz + ``{stem}_info.json`` sidecar."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.empty((), dtype=object)
    arr[()] = params_to_numpy(params)
    np.savez_compressed(path, params=arr)
    if info is not None:
        side = path.with_name(f"{path.stem}_info.json")
        side.write_text(json.dumps(info, indent=2, default=str))


def _flat_to_layers(npz) -> List[Dict[str, np.ndarray]]:
    n = 0
    while f"W_{n}" in npz.files:
        n += 1
    if n == 0:
        raise KeyError(f"no W_i keys among {list(npz.files)}")
    return [{"W": npz[f"W_{i}"], "b": npz[f"b_{i}"]} for i in range(n)]


def load_params(npz_path) -> Any:
    """Format-sniffing parameter loader -> the params pytree as numpy."""
    npz_path = pathlib.Path(npz_path)
    npz = np.load(str(npz_path), allow_pickle=True)
    if "params" in npz.files:
        arr = npz["params"]
        if arr.dtype == object:
            if arr.ndim == 0 or arr.size == 1:
                return arr.item() if arr.ndim == 0 else arr.reshape(-1)[0]
            raise ValueError(f"'params' in {npz_path} is object array "
                             f"{arr.shape}; expected a single serialized "
                             "pytree")
        return arr
    if any(k.startswith("W_") for k in npz.files):
        return _flat_to_layers(npz)
    if len(npz.files) == 1:
        arr = npz[npz.files[0]]
        if arr.dtype == object and (arr.ndim == 0 or arr.size == 1):
            return arr.item() if arr.ndim == 0 else arr.reshape(-1)[0]
        return arr
    raise KeyError(f"cannot interpret checkpoint {npz_path}: keys "
                   f"{list(npz.files)}")


def model_load(npz_path, require_sidecar: bool = True
               ) -> Tuple[Any, Dict[str, Any]]:
    """(params pytree, config dict) from checkpoint + ``{stem}_info.json``
    sidecar (the reference's ``model_load`` contract,
    ``inr/inr/model.py:217-301``). ``ModelConfig.from_info`` builds the
    model config from the dict."""
    npz_path = pathlib.Path(npz_path).expanduser().resolve()
    if not npz_path.is_file():
        raise FileNotFoundError(f"NPZ file not found: {npz_path}")
    params = load_params(npz_path)
    cfg_path = npz_path.with_name(f"{npz_path.stem}_info.json")
    if cfg_path.is_file():
        config = json.loads(cfg_path.read_text())
    elif require_sidecar:
        raise FileNotFoundError(f"Config JSON not found next to NPZ: "
                                f"{cfg_path}")
    else:
        config = {}
    return params, config
