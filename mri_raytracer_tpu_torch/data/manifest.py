"""Dataset manifest tooling (own copy of ``data/manifest.py``, reference
D8: ``build_brats_manifest`` / ``load_mu_glioma_manifest``).

Manifests are CSVs with per-case file paths; they decouple case discovery
from directory layout and support the MU-Glioma-Post dataset whose cases
live under timepoint subdirectories.
"""

from __future__ import annotations

import csv
import pathlib
from typing import Dict, List, Sequence

from mri_raytracer_tpu_torch.data.brats import MODALITY_SUFFIXES

COLUMNS = ["case_id", "t1", "t1ce", "t2", "flair", "mask"]
_SUFFIX_TO_COL = {"t1n": "t1", "t1c": "t1ce", "t2w": "t2", "t2f": "flair",
                  "seg": "mask"}


def build_brats_manifest(data_root, out_csv=None) -> List[Dict[str, str]]:
    """Scan a BraTS-layout tree -> manifest rows (paths relative to root)."""
    root = pathlib.Path(data_root)
    rows = []
    for case in sorted(p for p in root.iterdir() if p.is_dir()):
        row = {"case_id": case.name}
        ok = False
        for suf in MODALITY_SUFFIXES + ["seg"]:
            f = case / f"{case.name}-{suf}.nii.gz"
            if f.exists():
                row[_SUFFIX_TO_COL[suf]] = str(f.relative_to(root))
                ok = ok or suf != "seg"
            else:
                row[_SUFFIX_TO_COL[suf]] = ""
        if ok:
            rows.append(row)
    if out_csv:
        write_manifest(rows, out_csv)
    return rows


def write_manifest(rows: Sequence[Dict[str, str]], out_csv) -> None:
    out_csv = pathlib.Path(out_csv)
    out_csv.parent.mkdir(parents=True, exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=COLUMNS)
        w.writeheader()
        for r in rows:
            w.writerow({c: r.get(c, "") for c in COLUMNS})


def load_manifest(csv_path) -> List[Dict[str, str]]:
    with open(csv_path, newline="") as f:
        return list(csv.DictReader(f))


def load_mu_glioma_manifest(csv_path):
    """pandas DataFrame view for notebook parity (reference
    ``load_mu_glioma_manifest``); pandas is imported here, so the rest of
    the module runs without it."""
    import pandas as pd

    return pd.read_csv(csv_path)


def manifest_case_paths(rows: Sequence[Dict[str, str]], root) -> List[pathlib.Path]:
    """Case directories referenced by a manifest (for the cache loaders)."""
    root = pathlib.Path(root)
    out = []
    for r in rows:
        for col in ("t1", "t1ce", "t2", "flair"):
            if r.get(col):
                out.append((root / r[col]).parent)
                break
    return out
