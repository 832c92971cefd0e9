"""INR model configuration.

Own copy of ``mri_raytracer_tpu/config.py::ModelConfig`` (the only part of
that file the port needs), plus ``from_info``: the config a checkpoint's
``{stem}_info.json`` sidecar describes.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Mapping, Optional, Tuple


@dataclass
class ModelConfig:
    """INR model knobs (reference M1-M6)."""

    kind: str = "mlp"  # 'mlp' | 'siren' | 'coord_injection'
    hidden_dims: Tuple[int, ...] = (64, 64, 64, 64)
    num_classes: int = 4
    # Deterministic Fourier features: harmonics 1..k per axis
    # (reference inr/inr/model.py:11-18)
    fourier_freqs: int = 6
    # Random Fourier features (reference scripts/jax_inr_brats.py:105-128)
    rff_dim: int = 0
    rff_sigma: float = 5.0
    # Anisotropic learnable features (reference improved.ipynb §6)
    aniso_features: bool = False
    aniso_sigma: float = 5.0
    voxel_spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    use_modalities: bool = True
    siren_w0: float = 30.0
    dropout: float = 0.0  # coord-injection MLP dropout (improved.ipynb §7)
    param_dtype: str = "float32"

    @classmethod
    def from_info(cls, info: Optional[Mapping[str, Any]]) -> "ModelConfig":
        """The config of a checkpoint sidecar, read as the JAX package's
        apps read it (``apps/brats_app.py:91-99``): a ``model`` dict of
        fields (the training engine's ``config.to_dict()``), else the
        reference's ``FOURIER_FREQS`` / ``NUM_CLASSES`` / ``HIDDEN_DIMS``
        keys, else the defaults. Unknown keys are ignored."""
        mc = cls()
        info = info or {}
        names = {f.name for f in fields(cls)}
        if isinstance(info.get("model"), Mapping):
            for k, v in info["model"].items():
                if k in names:
                    setattr(mc, k, tuple(v) if isinstance(v, list) else v)
        elif "FOURIER_FREQS" in info:
            mc.fourier_freqs = info["FOURIER_FREQS"]
            mc.num_classes = info.get("NUM_CLASSES", 4)
            mc.hidden_dims = tuple(info.get("HIDDEN_DIMS", [64] * 4))
        return mc
