"""Checkpoint loaders, read side (port of ``io/checkpoint.py:50-98``).

The JAX package's two on-disk formats are plain numpy, so they load here
without JAX:
  * flat:   ``np.savez_compressed(W_0, b_0, W_1, ...)`` (``save_flat``)
  * object: a 0-d object array under key ``params`` holding the params
            pytree of dicts and lists of numpy arrays (``save_object``),
            with a ``{stem}_info.json`` sidecar carrying the config

``load_params`` returns that numpy pytree; ``convert.inr_params_from_numpy``
turns it into the port's model. The object format is a pickle: load only
checkpoints this project wrote.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, List, Tuple

import numpy as np


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
