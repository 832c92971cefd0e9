"""Normalization of BraTS volumes (numpy).

Own copies of ``mri_raytracer_tpu/data/brats.py::percentile_normalize``
(display) and ``zscore_nonzero`` (the INR's training normalization); each
must stay bit-identical to its original (``tests/test_torch_port_basics.py``,
``tests/test_torch_port_models.py``).
"""

from __future__ import annotations

import numpy as np


def zscore_nonzero(arr: np.ndarray) -> np.ndarray:
    """Z-score over the nonzero (brain) mask; zeros stay zero-mean-shifted."""
    mask = arr != 0
    if mask.any():
        mu = arr[mask].mean()
        sigma = arr[mask].std() + 1e-6
        arr = (arr - mu) / sigma
    return arr


def percentile_normalize(arr: np.ndarray, lo: float = 1.0, hi: float = 99.5) -> np.ndarray:
    """Viewer normalization: clip to [p_lo, p_hi] then scale to [0, 1]."""
    a, b = np.percentile(arr, [lo, hi])
    if b <= a:
        b = a + 1e-6
    return np.clip((arr - a) / (b - a), 0.0, 1.0).astype(np.float32)
