"""Checkpoint writers and loaders (port of ``io/checkpoint.py``).

The JAX package's two on-disk formats are plain numpy, so they are read and
written here without JAX, and a file written by either package loads in the
other:
  * flat:   ``np.savez_compressed(W_0, b_0, W_1, ...)`` (``save_flat``)
  * object: a 0-d object array under key ``params`` holding the params
            pytree of dicts and lists of numpy arrays (``save_object``),
            with a ``{stem}_info.json`` sidecar carrying the config

``load_params`` returns that numpy pytree; ``convert.inr_params_from_numpy``
turns it into the port's model. ``save_train_state`` / ``load_train_state``
hold an exact-resume state: params, the optimizer's ``state_dict`` (tensors
as numpy), the ``torch.Generator``'s state and the step. The writers take either such a pytree or
the port's model (an ``nn.Module`` whose state-dict keys spell the JAX
layout, ``models/mlp.py``). The object format is a pickle: load only
checkpoints this project wrote.

The reference's torch ``.pth`` files (reference C6) load straight into the
port's modules: ``load_torch_state_dict`` reads the three containers,
``torch_mlp_to_pytree`` builds the port's ``MLP``, ``load_torch_unet`` the
port's ``UNet2D``. The JAX package's ``orbax_checkpointer`` (an orbax
async checkpointer of JAX arrays) has no counterpart: the port's states
are torch tensors, written by ``save_train_state``.
"""

from __future__ import annotations

import json
import pathlib
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


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


def _obj(x: Any) -> np.ndarray:
    arr = np.empty((), dtype=object)
    arr[()] = x
    return arr


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
    np.savez_compressed(path, params=_obj(params_to_numpy(params)))
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


def model_load(npz_path, config_override: Optional[Dict[str, Any]] = None,
               require_sidecar: bool = True) -> Tuple[Any, Dict[str, Any]]:
    """(params pytree, config dict) from checkpoint + ``{stem}_info.json``
    sidecar (the reference's ``model_load`` contract,
    ``inr/inr/model.py:217-301``); ``config_override``'s keys replace the
    sidecar's. ``ModelConfig.from_info`` builds the model config from the
    dict."""
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
    if config_override:
        config = {**config, **config_override}
    return params, config


def _leaves(tree: Any) -> List[Any]:
    """The leaves of a pytree of dicts and lists in JAX's order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def check_resume_shapes(params: Any, loaded: Any) -> None:
    """Validate a resume checkpoint (a numpy pytree) against the freshly
    initialized params (the port's model or a pytree; reference shape
    check, ``scripts/jax_inr_brats.py:390-396``)."""
    cur = _leaves(params_to_numpy(params))
    new = _leaves(loaded)
    if len(cur) != len(new):
        raise ValueError(f"resume mismatch: {len(new)} leaves vs expected "
                         f"{len(cur)}")
    for a, b in zip(cur, new):
        if tuple(np.shape(a)) != tuple(np.shape(b)):
            raise ValueError(f"resume shape mismatch: {np.shape(b)} vs "
                             f"{np.shape(a)}")


def inspect_npz(path, indent: int = 0) -> List[str]:
    """Human-readable npz tree dump (reference ``scripts/read_npz.py``)."""
    lines = []

    def walk(obj, name, depth):
        pad = "  " * depth
        if isinstance(obj, np.ndarray) and obj.dtype == object \
                and obj.ndim == 0:
            lines.append(f"{pad}{name}: <object>")
            walk(obj.item(), name + "()", depth + 1)
        elif isinstance(obj, np.ndarray):
            lines.append(f"{pad}{name}: shape={obj.shape} dtype={obj.dtype}")
        elif isinstance(obj, dict):
            lines.append(f"{pad}{name}: dict[{len(obj)}]")
            for k, v in obj.items():
                walk(v, str(k), depth + 1)
        elif isinstance(obj, (list, tuple)):
            lines.append(f"{pad}{name}: {type(obj).__name__}[{len(obj)}]")
            for i, v in enumerate(obj):
                walk(v, f"[{i}]", depth + 1)
        else:
            lines.append(f"{pad}{name}: {type(obj).__name__} = {obj!r}")

    npz = np.load(str(path), allow_pickle=True)
    for key in npz.files:
        walk(npz[key], key, indent)
    return lines


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """Load a torch ``.pth`` checkpoint into ``{name: np.ndarray}``.

    Accepts the three layouts the reference persists (C6): a raw
    ``state_dict`` (U-Net / distilled MLP, ``Final-1.ipynb §6,§12``), a dict
    wrapping one under ``state_dict``/``model_state_dict``, and nnU-Net's
    ``checkpoint_final.pth`` whose weights live under ``network_weights``
    (``scripts/nnunet_train_export.py:404-410``). A ``.pth`` is a pickle
    (``weights_only=False``, as the JAX package loads it): load only files
    you trust."""
    obj = torch.load(str(path), map_location="cpu", weights_only=False)
    for key in ("network_weights", "state_dict", "model_state_dict"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state_dict, got {type(obj)}")
    out = {}
    for k, v in obj.items():
        if hasattr(v, "detach"):
            out[str(k)] = v.detach().cpu().numpy()
    if not out:
        raise ValueError(f"{path}: no tensors in checkpoint "
                         f"(keys: {list(obj)[:8]})")
    return out


def torch_mlp_to_pytree(state_dict: Dict[str, np.ndarray]):
    """torch ``nn.Linear`` stack -> the port's ``models.mlp.MLP``.

    Imports the reference's distilled implicit MLP teacher
    (``Final-1.ipynb §12``: ``net.{0,2,4}.weight/bias``). torch Linear
    weights are ``(out, in)``, the port's ``Dense.W`` is ``(in, out)`` as
    in JAX, so each W transposes; ``params_to_numpy`` of the result is the
    JAX package's list-of-``{'W','b'}`` pytree."""
    from mri_raytracer_tpu_torch.models.mlp import MLP, Dense

    layers: Dict[int, Dict[str, np.ndarray]] = {}
    for k, v in state_dict.items():
        m = re.match(r"(?:.*\.)?(\d+)\.(weight|bias)$", k)
        if not m:
            continue
        v = np.asarray(v)
        want = 2 if m.group(2) == "weight" else 1
        if v.ndim != want:
            continue
        layers.setdefault(int(m.group(1)), {})[m.group(2)] = v
    idxs = sorted(i for i, d in layers.items() if "weight" in d)
    if not idxs:
        raise ValueError(f"no Linear layers among {list(state_dict)[:8]}")
    out = []
    for i in idxs:
        w = layers[i]["weight"]
        b = layers[i].get("bias", np.zeros(w.shape[0], w.dtype))
        out.append(Dense(torch.tensor(np.ascontiguousarray(w.T)),
                         torch.tensor(b)))
    return MLP(out)


def load_torch_unet(state_dict: Dict[str, np.ndarray]):
    """The port's ``models.unet.UNet2D`` from a reference U-Net state dict
    (``load_torch_state_dict`` of its ``.pth``): the port keeps the
    reference's layout, so the weights load as they are. Input channels,
    classes and base width are read off the weights; the module is on the
    CPU in eval mode."""
    from mri_raytracer_tpu_torch.models.unet import UNet2D

    state = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}
    first, head = state["d1.net.0.weight"], state["out.weight"]
    net = UNet2D(first.shape[1], head.shape[0], first.shape[0])
    net.load_state_dict(state)
    return net.eval()


def _to_numpy(obj: Any) -> Any:
    """Tensors of a nested state dict as numpy arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _to_torch(obj: Any) -> Any:
    """``_to_numpy``'s inverse (tensors on the CPU; a torch optimizer's
    ``load_state_dict`` moves its state to its params' device)."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.copy())
    if isinstance(obj, dict):
        return {k: _to_torch(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_torch(v) for v in obj)
    return obj


def save_train_state(path, params: Any, optimizer: Any,
                     generator: torch.Generator, step: int,
                     info: Optional[Dict[str, Any]] = None) -> None:
    """Exact-resume checkpoint: params + optimizer state + the generator's
    state + step (``train.optimizers.ClippedOptimizer`` or any object with
    a ``state_dict``).

    The reference resumes params only (``inr/inr/train.py:162-183``), which
    resets Adam moments and the sampling stream; this format makes resume
    bit-exact. Object-array npz like ``save_object`` (loadable by
    ``load_params`` too, and by the JAX package's: the 'params' key is
    present and first)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path, params=_obj(params_to_numpy(params)),
        opt_state=_obj(_to_numpy(optimizer.state_dict())),
        rng_state=generator.get_state().numpy(), step=np.int64(step))
    if info is not None:
        path.with_name(f"{path.stem}_info.json").write_text(
            json.dumps(info, indent=2, default=str))


def load_train_state(path) -> Dict[str, Any]:
    """Load an exact-resume checkpoint -> dict(params (numpy pytree),
    opt_state (a state dict of tensors), rng_state (uint8 tensor), step).
    Raises KeyError for a params-only checkpoint and for a JAX-written
    train state, which holds a JAX key, not a generator state."""
    with np.load(path, allow_pickle=True) as z:
        if "opt_state" not in z.files or "rng_state" not in z.files:
            raise KeyError(f"{path} is not a train-state checkpoint of the "
                           f"port (keys: {z.files})")
        return {"params": z["params"][()],
                "opt_state": _to_torch(z["opt_state"][()]),
                "rng_state": torch.from_numpy(z["rng_state"].copy()),
                "step": int(z["step"])}
