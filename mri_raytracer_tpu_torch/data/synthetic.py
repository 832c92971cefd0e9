"""Synthetic multi-modal brain-like volumes (numpy).

Own copy of ``mri_raytracer_tpu/data/synthetic.py``; each function must
stay bit-identical to its original (``tests/test_torch_port_basics.py``,
``tests/test_torch_port_apps.py``):
  * ``synthetic_case``: (M, H, W, D) float32 modalities + (H, W, D) int16
    seg with BraTS-like labels 0..3 (background / NCR-NET / edema /
    enhancing)
  * ``write_synthetic_dataset``: a BraTS-2023-layout tree of ``.nii.gz``
    files (``{case}/{case}-{t1n,t1c,t2w,t2f,seg}.nii.gz``) for the same
    ``find_cases``/``load_case`` path as real data
"""

from __future__ import annotations

import pathlib
from typing import Tuple

import numpy as np

from mri_raytracer_tpu_torch.data import nifti


def _coords(shape: Tuple[int, int, int]) -> np.ndarray:
    """Normalized [-1,1] coordinate grid, shape (H, W, D, 3)."""
    axes = [np.linspace(-1.0, 1.0, s, dtype=np.float32) for s in shape]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return g


def synthetic_case(shape: Tuple[int, int, int] = (64, 64, 48), seed: int = 0,
                   num_modalities: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic case: (M,H,W,D) modalities (raw intensities) + seg."""
    rng = np.random.default_rng(seed)
    g = _coords(shape)

    # "Brain": big ellipsoid with smooth internal texture.
    ell = ((g[..., 0] / 0.85) ** 2 + (g[..., 1] / 0.8) ** 2 + (g[..., 2] / 0.75) ** 2)
    brain = (ell < 1.0).astype(np.float32)
    # Low-frequency texture: sum of random cosine waves (cheap, smooth).
    tex = np.zeros(shape, np.float32)
    for _ in range(6):
        k = rng.normal(0, 2.0, size=3).astype(np.float32)
        ph = rng.uniform(0, 2 * np.pi)
        tex += np.cos(g @ k * np.pi + ph).astype(np.float32)
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-6)

    # Tumor: three concentric shells around a random off-center point.
    center = rng.uniform(-0.25, 0.25, size=3).astype(np.float32)
    d2 = ((g - center) ** 2).sum(-1)
    seg = np.zeros(shape, np.int16)
    seg[d2 < 0.45 ** 2] = 2   # edema (outer)
    seg[d2 < 0.32 ** 2] = 3   # enhancing
    seg[d2 < 0.20 ** 2] = 1   # necrotic core
    seg[brain == 0] = 0

    mods = []
    for m in range(num_modalities):
        base = brain * (400.0 + 600.0 * tex) * (0.7 + 0.3 * np.cos(m * 1.3))
        # Modality-dependent tumor contrast.
        contrast = np.array([[0, 0, 0, 0],
                             [-200, 150, -100, 250],
                             [100, -150, 350, 220],
                             [300, 400, -50, 150]], np.float32)
        vol = base.copy()
        for c in range(1, 4):
            vol[seg == c] += contrast[c % 4, m % 4]
        vol += rng.normal(0, 8.0, size=shape).astype(np.float32) * brain
        vol = np.clip(vol, 0, None)
        mods.append(vol.astype(np.float32))
    return np.stack(mods, axis=0), seg


def synthetic_u8_volume(shape: Tuple[int, int, int] = (64, 64, 64), seed: int = 0) -> np.ndarray:
    """u8 density volume (analog of t1_icbm demo volume, reference H2)."""
    mods, _ = synthetic_case(shape, seed=seed, num_modalities=1)
    v = mods[0]
    v = v / (v.max() + 1e-6)
    return (v * 255.0).astype(np.uint8)


def write_synthetic_dataset(root: pathlib.Path, num_cases: int = 3,
                            shape: Tuple[int, int, int] = (32, 32, 24),
                            seed: int = 0) -> pathlib.Path:
    """BraTS-2023-layout synthetic dataset (uses label 4 on disk for the
    'enhancing' class so the 4->3 remap path is exercised, matching the raw
    BraTS convention the reference remaps at scripts/jax_inr_brats.py:81-82)."""
    root = pathlib.Path(root)
    suffixes = ["t1n", "t1c", "t2w", "t2f"]
    for i in range(num_cases):
        name = f"BraTS-SYN-{i:05d}-000"
        cdir = root / name
        cdir.mkdir(parents=True, exist_ok=True)
        mods, seg = synthetic_case(shape, seed=seed + i)
        seg_disk = seg.copy()
        seg_disk[seg_disk == 3] = 4  # raw BraTS uses label 4 for enhancing
        for m, suf in enumerate(suffixes):
            nifti.save(cdir / f"{name}-{suf}.nii.gz", mods[m])
        nifti.save(cdir / f"{name}-seg.nii.gz", seg_disk.astype(np.int16))
    return root
