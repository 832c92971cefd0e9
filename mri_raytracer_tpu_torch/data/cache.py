"""Host-side case caches (own copy of ``data/cache.py``, reference D4-D6,
D9, D10; numpy, so each function returns the JAX package's arrays bit for
bit: ``tests/test_torch_port_data.py``; ``RAMCache``'s native path goes
through the port's ``io/native`` binding of the same C++ library).

Unlike the reference's per-voxel Python loop
(``inr/inr/dataloader.py:86-96``, the CPU hotspot flagged in SURVEY §3.1),
every cache here stacks same-shaped cases into contiguous arrays and gathers
with one vectorized fancy-index — and the training engine normally bypasses
the host entirely via the device pool (``data/pool.py``).
"""

from __future__ import annotations

import collections
import pathlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

from mri_raytracer_tpu_torch.data import brats


class RAMCache:
    """Eagerly loads all cases into RAM (reference ``StreamingBraTSCache``)."""

    def __init__(self, case_paths: Sequence[pathlib.Path], name: str = "cache",
                 verbose: bool = True, use_native: bool = True, **load_kw):
        self.case_paths = list(case_paths)
        self.name = name
        self.n_cases = len(self.case_paths)
        self.cache: List[Dict[str, np.ndarray]] = []
        native_ok = use_native and self._try_native_load(load_kw)
        if not native_ok:
            for i, cp in enumerate(self.case_paths):
                if verbose and i % 20 == 0 and i > 0:
                    print(f"  [{name}] loaded {i}/{self.n_cases}")
                self.cache.append(brats.load_case_dict(cp, **load_kw))
        if not self.cache:
            raise ValueError(f"{name}: no cases")
        self._finalize()

    def _try_native_load(self, load_kw) -> bool:
        """GIL-free threaded loading via the C++ runtime (io/native) for the
        default training normalization; any mismatch falls back to Python."""
        from mri_raytracer_tpu_torch.io import native

        if not native.available():
            return False
        if load_kw.get("normalization", "zscore_nonzero") != "zscore_nonzero":
            return False
        modalities = load_kw.get("modalities", brats.MODALITY_SUFFIXES)
        seg_suffix = load_kw.get("seg_suffix", brats.SEG_SUFFIX)
        remap = load_kw.get("remap", True)
        mod_paths, seg_paths, metas = [], [], []
        for cp in self.case_paths:
            base = pathlib.Path(cp).name
            mods = [pathlib.Path(cp) / f"{base}-{m}.nii.gz" for m in modalities]
            seg = pathlib.Path(cp) / f"{base}-{seg_suffix}.nii.gz"
            if not all(m.exists() for m in mods) or not seg.exists():
                return False
            mod_paths.extend(mods)
            seg_paths.append(seg)
            metas.append((base, len(mods)))
        # Modalities z-scored; seg volumes loaded raw in their own batch
        # (never normalized, never loaded twice).
        results = native.load_nifti_batch(mod_paths, zscore=True,
                                          max_voxels=300 ** 3, n_threads=8)
        seg_results = native.load_nifti_batch(seg_paths, zscore=False,
                                              max_voxels=300 ** 3, n_threads=8)
        k = 0
        for ci, (base, n_mods) in enumerate(metas):
            vols = []
            for _ in range(n_mods):
                item = results[k]
                k += 1
                if item is None:
                    return False
                vols.append(item[0])
            seg_item = seg_results[ci]
            if seg_item is None:
                return False
            seg_arr = seg_item[0].astype(np.int16)
            if remap:
                seg_arr[seg_arr == 4] = 3
            self.cache.append({"mods": np.stack(vols), "seg": seg_arr,
                               "name": base})
        return True

    def _finalize(self) -> None:
        self.vol_shape = self.cache[0]["mods"].shape[1:]
        self.n_modalities = self.cache[0]["mods"].shape[0]
        same = all(c["mods"].shape == self.cache[0]["mods"].shape for c in self.cache)
        # Stacked views enable one-shot vectorized gather.
        self._mods_stack = (np.stack([c["mods"] for c in self.cache]) if same else None)
        self._segs_stack = (np.stack([c["seg"] for c in self.cache]) if same else None)

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        return self.cache[idx]

    def sample_voxels(self, case_indices, h, w, d) -> Tuple[np.ndarray, np.ndarray]:
        """Gather (N, M) intensities + (N,) labels. Vectorized."""
        ci = np.asarray(case_indices)
        h, w, d = np.asarray(h), np.asarray(w), np.asarray(d)
        if self._mods_stack is not None:
            mods = self._mods_stack[ci, :, h, w, d]  # (N, M)
            segs = self._segs_stack[ci, h, w, d]
            return mods.astype(np.float32), segs.astype(np.int16)
        N, M = len(ci), self.n_modalities
        mods = np.zeros((N, M), np.float32)
        segs = np.zeros(N, np.int16)
        for i in range(N):
            c = self.cache[ci[i]]
            mods[i] = c["mods"][:, h[i], w[i], d[i]]
            segs[i] = c["seg"][h[i], w[i], d[i]]
        return mods, segs

    def stacked(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._mods_stack is None:
            raise ValueError("cases have heterogeneous shapes; cannot stack")
        return self._mods_stack, self._segs_stack


class CaseLRU:
    """Bounded per-case LRU for datasets larger than RAM (reference D5,
    ``scripts/jax_inr_brats.py:87-102``)."""

    def __init__(self, case_paths: Sequence[pathlib.Path], capacity: int = 16, **load_kw):
        self.case_paths = list(case_paths)
        self.capacity = int(capacity)
        self._load_kw = load_kw
        self._cache: "collections.OrderedDict[int, Dict[str, np.ndarray]]" = collections.OrderedDict()

    @property
    def n_cases(self) -> int:
        return len(self.case_paths)

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        if idx in self._cache:
            self._cache.move_to_end(idx)
            return self._cache[idx]
        if len(self._cache) >= self.capacity:
            self._cache.popitem(last=False)
        self._cache[idx] = brats.load_case_dict(self.case_paths[idx], **self._load_kw)
        return self._cache[idx]


class ChunkedCache:
    """Rotating chunk of cases + per-case boundary maps ``1/(1+EDT)`` for the
    boundary-weighted loss (reference D6, ``improved.ipynb §5``)."""

    def __init__(self, case_paths: Sequence[pathlib.Path], chunk_cases: int = 128,
                 boundary_maps: bool = True, seed: int = 0, **load_kw):
        self.case_paths = list(case_paths)
        self.chunk_cases = min(int(chunk_cases), len(self.case_paths))
        self.boundary_maps = boundary_maps
        self._rng = np.random.default_rng(seed)
        self._load_kw = load_kw
        self.cache: List[Dict[str, np.ndarray]] = []
        self.next_chunk()

    @staticmethod
    def boundary_map(seg: np.ndarray) -> np.ndarray:
        """Weight = 1/(1+EDT to the tumor boundary); 1 on the boundary itself."""
        from scipy import ndimage

        tumor = seg > 0
        if not tumor.any() or tumor.all():
            return np.ones_like(seg, np.float32)
        # Boundary distance: distance to the nearest voxel of the other region.
        d_out = ndimage.distance_transform_edt(~tumor)
        d_in = ndimage.distance_transform_edt(tumor)
        dist = np.where(tumor, d_in, d_out).astype(np.float32)
        return (1.0 / (1.0 + dist)).astype(np.float32)

    def next_chunk(self) -> None:
        idxs = self._rng.choice(len(self.case_paths), size=self.chunk_cases, replace=False)
        self.cache = []
        for i in idxs:
            c = brats.load_case_dict(self.case_paths[int(i)], **self._load_kw)
            if self.boundary_maps:
                c["boundary"] = self.boundary_map(c["seg"])
            self.cache.append(c)
        self.n_cases = len(self.cache)
        self.vol_shape = self.cache[0]["mods"].shape[1:]
        self.n_modalities = self.cache[0]["mods"].shape[0]

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        return self.cache[idx]


def kfold_split(cases: Sequence[pathlib.Path], num_folds: int, fold_index: int,
                seed: int) -> Tuple[List[pathlib.Path], List[pathlib.Path]]:
    """Deterministic shuffle -> K folds; fold_index is validation
    (reference D9, ``inr/inr/dataloader.py:99-130``)."""
    rng = np.random.default_rng(seed)
    shuffled = list(cases)
    rng.shuffle(shuffled)
    folds = np.array_split(np.asarray(shuffled, dtype=object), num_folds)
    if not 0 <= fold_index < len(folds):
        raise ValueError(f"fold_index {fold_index} out of range [0, {len(folds)})")
    val = list(folds[fold_index])
    train = [c for i, f in enumerate(folds) if i != fold_index for c in f]
    return train, val


def save_splits(out_dir: pathlib.Path, train: Sequence[pathlib.Path],
                val: Sequence[pathlib.Path]) -> None:
    """Persist splits as text lists (reference D10, ``improved.ipynb §3``)."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "train.txt").write_text("\n".join(str(p) for p in train) + "\n")
    (out_dir / "val.txt").write_text("\n".join(str(p) for p in val) + "\n")


def load_splits(out_dir: pathlib.Path) -> Tuple[List[pathlib.Path], List[pathlib.Path]]:
    out_dir = pathlib.Path(out_dir)
    train = [pathlib.Path(l) for l in (out_dir / "train.txt").read_text().splitlines() if l]
    val = [pathlib.Path(l) for l in (out_dir / "val.txt").read_text().splitlines() if l]
    return train, val


def build_train_val_caches(data_root: pathlib.Path, case_limit: int, num_folds: int,
                           fold_index: int, seed: int, cache_kind: str = "ram",
                           **kw):
    """Discovery -> split -> caches (reference ``build_train_val_caches``)."""
    all_cases = brats.find_cases(pathlib.Path(data_root))
    subset = all_cases[:case_limit]
    train_cases, val_cases = kfold_split(subset, num_folds, fold_index, seed)
    maker = {"ram": RAMCache, "lru": CaseLRU, "chunked": ChunkedCache}[cache_kind]
    train_cache = maker(train_cases, **kw)
    val_cache = maker(val_cases, **kw) if val_cases else None
    info = {"all_cases": all_cases, "train_cases": train_cases, "val_cases": val_cases}
    return train_cache, val_cache, info
