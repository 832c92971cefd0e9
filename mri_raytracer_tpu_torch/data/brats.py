"""BraTS case discovery, loading and normalization (numpy).

Own copy of ``mri_raytracer_tpu/data/brats.py``; each function must stay
bit-identical to its original (``tests/test_torch_port_basics.py``,
``tests/test_torch_port_models.py``, ``tests/test_torch_port_apps.py``).

Two normalization modes coexist in the reference and must stay distinct:
  * training: per-volume z-score over the nonzero mask
    (``inr/inr/dataloader.py:30-35``)
  * display: percentile [1, 99.5] -> [0, 1]
    (``inr/viewer/brats_viewer.py:46-58``)
"""

from __future__ import annotations

import pathlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

from mri_raytracer_tpu_torch.data import nifti

MODALITY_SUFFIXES = ["t1n", "t1c", "t2w", "t2f"]
SEG_SUFFIX = "seg"


def find_cases(root: pathlib.Path,
               modalities: Sequence[str] = MODALITY_SUFFIXES
               ) -> List[pathlib.Path]:
    """Case dirs containing at least one `{case}-{modality}.nii.gz`.
    A missing root yields an empty list (not an error)."""
    root = pathlib.Path(root)
    if not root.is_dir():
        return []
    cases = []
    for p in sorted(root.iterdir()):
        if p.is_dir() and any((p / f"{p.name}-{m}.nii.gz").exists()
                              for m in modalities):
            cases.append(p)
    return cases


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


def remap_labels(seg: np.ndarray) -> np.ndarray:
    """BraTS raw label 4 (enhancing) -> contiguous class 3."""
    seg = seg.copy()
    seg[seg == 4] = 3
    return seg


def load_case(case_dir: pathlib.Path,
              modalities: Sequence[str] = MODALITY_SUFFIXES,
              seg_suffix: str = SEG_SUFFIX,
              normalization: str = "zscore_nonzero",
              remap: bool = True,
              percentiles: Tuple[float, float] = (1.0, 99.5),
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Load one case -> ((M,H,W,D) float32 modalities, (H,W,D) int16 seg)."""
    case_dir = pathlib.Path(case_dir)
    base = case_dir.name
    mods = []
    for suf in modalities:
        img = nifti.load(case_dir / f"{base}-{suf}.nii.gz")
        arr = img.data.astype(np.float32)
        if normalization == "zscore_nonzero":
            arr = zscore_nonzero(arr)
        elif normalization == "percentile":
            arr = percentile_normalize(arr, *percentiles)
        elif normalization != "none":
            raise ValueError(f"unknown normalization {normalization!r}")
        mods.append(arr)
    seg = nifti.load(case_dir / f"{base}-{seg_suffix}.nii.gz").data \
        .astype(np.int16)
    if remap:
        seg = remap_labels(seg)
    return np.stack(mods, axis=0), seg


def load_case_dict(case_dir: pathlib.Path, **kw) -> Dict[str, np.ndarray]:
    mods, seg = load_case(case_dir, **kw)
    return {"mods": mods, "seg": seg, "name": pathlib.Path(case_dir).name}


def load_display_volume(path: pathlib.Path, lo: float = 1.0, hi: float = 99.5,
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Viewer-path loader (reference ``load_nifti_float``): percentile
    normalize to [0,1]; returns (volume(H,W,D) f32, affine, spacing)."""
    img = nifti.load(path)
    vol = percentile_normalize(img.data.astype(np.float32), lo, hi)
    return vol, img.affine, np.asarray(img.pixdim, np.float32)


def load_seg_volume(path: pathlib.Path, remap: bool = True) -> np.ndarray:
    """Viewer-path label loader (reference ``load_seg_uint``)."""
    seg = nifti.load(path).data.astype(np.int32)
    if remap:
        seg = remap_labels(seg)
    return seg.astype(np.uint32)
