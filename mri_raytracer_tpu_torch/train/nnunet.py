"""nnU-Net v2 pipeline adapter (own copy of ``train/nnunet.py``, reference
T10, ``scripts/nnunet_train_export.py``).

nnU-Net itself is an external torch dependency (it stays external in the
reference too); this module implements the framework-owned parts natively —
environment setup, BraTS->nnU-Net dataset conversion (modality-indexed
filenames, 4->3 label remap), dataset.json generation, result/checkpoint
discovery — and gates the nnunetv2 API calls behind availability so the
pipeline degrades to a clear error rather than an import crash.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mri_raytracer_tpu_torch.data import nifti

MODALITY_ORDER = ["t1n", "t1c", "t2w", "t2f"]  # -> _0000.._0003


def has_nnunet() -> bool:
    try:
        import nnunetv2  # noqa: F401

        return True
    except ImportError:
        return False


def setup_nnunet_env(base_dir) -> Dict[str, str]:
    """Create + export the nnUNet_raw/preprocessed/results tree
    (reference :39-41)."""
    base = pathlib.Path(base_dir)
    env = {}
    for name in ("nnUNet_raw", "nnUNet_preprocessed", "nnUNet_results"):
        d = base / name
        d.mkdir(parents=True, exist_ok=True)
        os.environ[name] = str(d)
        env[name] = str(d)
    return env


def prepare_brats_dataset(case_dirs: Sequence[pathlib.Path], raw_dir,
                          dataset_id: int = 501,
                          dataset_name: str = "BraTS2023",
                          use_symlinks: bool = True) -> pathlib.Path:
    """BraTS cases -> nnU-Net raw layout (reference :235-297):
    imagesTr/{case}_{0000..0003}.nii.gz (symlinked), labelsTr/{case}.nii.gz
    with labels remapped 4->3, plus dataset.json."""
    ds_dir = pathlib.Path(raw_dir) / f"Dataset{dataset_id:03d}_{dataset_name}"
    images = ds_dir / "imagesTr"
    labels = ds_dir / "labelsTr"
    images.mkdir(parents=True, exist_ok=True)
    labels.mkdir(parents=True, exist_ok=True)

    n = 0
    for case_dir in case_dirs:
        case_dir = pathlib.Path(case_dir)
        base = case_dir.name
        mods = [case_dir / f"{base}-{m}.nii.gz" for m in MODALITY_ORDER]
        seg = case_dir / f"{base}-seg.nii.gz"
        if not all(m.exists() for m in mods) or not seg.exists():
            continue
        for i, m in enumerate(mods):
            dst = images / f"{base}_{i:04d}.nii.gz"
            if dst.exists() or dst.is_symlink():
                dst.unlink()
            if use_symlinks:
                dst.symlink_to(m.resolve())
            else:
                shutil.copy(m, dst)
        img = nifti.load(seg)
        arr = img.data.astype(np.int16)
        arr[arr == 4] = 3  # remap (reference :262-output convention)
        nifti.save(labels / f"{base}.nii.gz", arr, affine=img.affine)
        n += 1

    (ds_dir / "dataset.json").write_text(json.dumps({
        "channel_names": {str(i): m.upper() for i, m in enumerate(MODALITY_ORDER)},
        "labels": {"background": 0, "NCR_NET": 1, "ED": 2, "ET": 3},
        "numTraining": n,
        "file_ending": ".nii.gz",
    }, indent=2))
    return ds_dir


def plan_and_preprocess(dataset_id: int, num_processes: int = 4,
                        configurations: Sequence[str] = ("3d_fullres",)
                        ) -> str:
    """fingerprint -> plan -> preprocess with the reference's exact
    arguments (reference :308-322): fingerprints with
    ``check_dataset_integrity=False, clean=True, verbose=True``; the plans
    identifier returned by ``plan_experiments`` is threaded into
    ``preprocess`` (and returned so training/export use the same plans)."""
    if not has_nnunet():
        raise RuntimeError("nnunetv2 is not installed in this image; "
                           "dataset conversion completed — run planning on a "
                           "GPU host with nnunetv2 available")
    from nnunetv2.experiment_planning.plan_and_preprocess_api import (
        extract_fingerprints, plan_experiments, preprocess)

    extract_fingerprints([dataset_id], check_dataset_integrity=False,
                         clean=True, verbose=True)
    plans_identifier = plan_experiments([dataset_id])
    preprocess([dataset_id], plans_identifier=plans_identifier,
               configurations=tuple(configurations),
               num_processes=(num_processes,), verbose=False)
    return plans_identifier


def select_device() -> str:
    """cuda > mps > cpu auto-select (reference :345-352)."""
    if torch.cuda.is_available():
        return "cuda"
    if hasattr(torch.backends, "mps") and torch.backends.mps.is_available():
        return "mps"
    return "cpu"


def run_training(dataset_name_or_id, configuration: str = "3d_fullres",
                 fold: int = 0, trainer: str = "nnUNetTrainer",
                 plans_identifier: str = "nnUNetPlans",
                 device: Optional[str] = None) -> None:
    """reference :333-368: string dataset identifier (avoids the
    get_trainer_from_args AttributeError the reference notes), full kwarg
    surface, device auto-select cuda/mps/cpu, passed as a torch.device."""
    if not has_nnunet():
        raise RuntimeError("nnunetv2 is not installed")
    from nnunetv2.run.run_training import run_training as _run

    dev = torch.device(device if device is not None else select_device())
    _run(str(dataset_name_or_id), configuration, fold,
         trainer_class_name=trainer, plans_identifier=plans_identifier,
         num_gpus=1, export_validation_probabilities=False,
         continue_training=False, only_run_validation=False,
         disable_checkpointing=False, val_with_best=False, device=dev)


def export_model(dataset_id: int, out_zip, configuration: str = "3d_fullres",
                 trainer: str = "nnUNetTrainer",
                 plans_identifier: str = "nnUNetPlans",
                 fold: int = 0) -> None:
    """reference :379-394: non-strict export of ``checkpoint_final.pth``
    for the trained fold, no cross-val predictions."""
    if not has_nnunet():
        raise RuntimeError("nnunetv2 is not installed")
    from nnunetv2.model_sharing.model_export import export_pretrained_model

    export_pretrained_model(dataset_id, str(out_zip),
                            configurations=(configuration,),
                            trainer=trainer,
                            plans_identifier=plans_identifier,
                            folds=(fold,), strict=False,
                            save_checkpoints=("checkpoint_final.pth",),
                            export_crossval_predictions=False)


def run_pipeline(case_dirs: Sequence[pathlib.Path], work_dir,
                 dataset_id: int = 501, dataset_name: str = "BraTS2023",
                 configuration: str = "3d_fullres", fold: int = 0,
                 trainer: str = "nnUNetTrainer", num_processes: int = 4,
                 device: Optional[str] = None) -> Optional[pathlib.Path]:
    """The full reference pipeline (T10, :39-410): env setup -> BraTS
    conversion -> fingerprint/plan/preprocess -> train one fold -> export
    zip -> locate ``checkpoint_final.pth`` (import it with
    ``io.checkpoint.load_torch_state_dict``). Returns the checkpoint path
    (None if nnU-Net didn't write one)."""
    env = setup_nnunet_env(work_dir)
    prepare_brats_dataset(case_dirs, env["nnUNet_raw"],
                          dataset_id=dataset_id, dataset_name=dataset_name)
    plans = plan_and_preprocess(dataset_id, num_processes=num_processes,
                                configurations=(configuration,))
    # nnunetv2's get_trainer_from_args accepts an int-string or a full
    # 'DatasetXXX_Name' — the bare suffix raises ValueError. The reference
    # passes the full name (nnunet_train_export.py:78,341).
    run_training(f"Dataset{dataset_id:03d}_{dataset_name}", configuration,
                 fold, trainer=trainer, plans_identifier=plans,
                 device=device)
    out_zip = (pathlib.Path(work_dir)
               / f"{dataset_name}_{configuration}_fold{fold}.zip")
    export_model(dataset_id, out_zip, configuration=configuration,
                 trainer=trainer, plans_identifier=plans, fold=fold)
    return find_checkpoint(env["nnUNet_results"], dataset_id,
                           configuration=configuration, fold=fold,
                           trainer=trainer, plans_identifier=plans)


def find_checkpoint(results_dir, dataset_id: int,
                    configuration: str = "3d_fullres", fold: int = 0,
                    trainer: str = "nnUNetTrainer",
                    plans_identifier: str = "nnUNetPlans"
                    ) -> Optional[pathlib.Path]:
    """Locate checkpoint_final.pth (reference :404-410) without importing
    nnunetv2 (plain path walk)."""
    root = pathlib.Path(results_dir)
    pattern = f"Dataset{dataset_id:03d}_*"
    for ds in root.glob(pattern):
        cand = ds / f"{trainer}__{plans_identifier}__{configuration}" \
            / f"fold_{fold}" / "checkpoint_final.pth"
        if cand.exists():
            return cand
    return None
