"""Unified configuration tree (own copy of ``mri_raytracer_tpu/config.py``).

The reference exposes three config surfaces: SHOUTY-key dicts consumed by
``train_inr`` (reference ``inr/inr/train.py:19-36``), an argparse CLI with ~35
flags (``scripts/jax_inr_brats.py:309-344``), and notebook module constants.
Here a single dataclass tree serves all three: ``TrainConfig.from_dict``
accepts both SHOUTY and pythonic keys, ``TrainConfig.to_cli_parser`` builds the
argparse surface, and ``to_dict`` round-trips for JSON sidecars / W&B config.
Fields and defaults are the JAX package's (``tests/test_torch_port_losses.py``
holds the two ``to_dict`` and CLI results equal). ``ModelConfig.from_info``
is the port's own: the config a checkpoint's ``{stem}_info.json`` sidecar
describes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple


def _asdict(obj) -> Dict[str, Any]:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _asdict(v)
        elif isinstance(v, pathlib.Path):
            v = str(v)
        elif isinstance(v, tuple):
            v = list(v)
        out[f.name] = v
    return out


@dataclass
class DataConfig:
    """Data-layer knobs (reference D1-D14)."""

    data_root: str = "data/BraTS-2023"
    case_limit: int = 625
    num_folds: int = 8
    fold_index: int = 0
    seed: int = 0
    # Normalization: 'zscore_nonzero' (training path, reference
    # inr/inr/dataloader.py:30-35) or 'percentile' (viewer path,
    # inr/viewer/brats_viewer.py:46-58).
    normalization: str = "zscore_nonzero"
    percentile_lo: float = 1.0
    percentile_hi: float = 99.5
    # BraTS label 4 -> 3 remap. The reference applies this inconsistently
    # (scripts/jax_inr_brats.py:81-82 remaps; inr/inr/dataloader.py:36-38 does
    # not); here it is explicit config, default on.
    remap_label_4_to_3: bool = True
    modalities: Tuple[str, ...] = ("t1n", "t1c", "t2w", "t2f")
    seg_suffix: str = "seg"
    cache: str = "ram"  # 'ram' | 'lru' | 'chunked'
    lru_capacity: int = 16
    chunk_cases: int = 128
    # Device-resident case pool (reference T4, scripts/jax_inr_brats.py:546-682)
    pool_size: int = 4
    pool_refresh: int = 200
    # Sampler: 'uniform' | 'tumor' | 'balanced' | 'hybrid'
    sampler: str = "uniform"
    tumor_ratio: float = 0.5
    min_subclass_samples: Optional[Tuple[int, int, int]] = None
    prefetch: int = 2


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


@dataclass
class LossConfig:
    """Loss zoo (reference L1-L8)."""

    class_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    dice_weight: float = 0.5
    per_class_dice: bool = False
    focal_gamma: float = 0.0
    focal_alpha: Optional[Tuple[float, ...]] = None
    label_smoothing: float = 0.0
    freq_dropout: float = 0.0
    edema_fp_weight: float = 0.0
    tversky_weight: float = 0.0
    tversky_alpha: float = 0.8
    tversky_beta: float = 0.2
    edema_logit_reg: float = 0.0
    # Unified focal loss (improved.ipynb §8)
    unified_focal_weight: float = 0.0
    unified_focal_lambda: float = 0.5
    unified_focal_gamma: float = 0.5
    unified_focal_delta: float = 0.6
    # Spatial-coherence TV loss + boundary weighting (improved.ipynb §8)
    tv_weight: float = 0.0
    boundary_weight: float = 0.0


@dataclass
class OptimConfig:
    """Optimizer / schedule zoo (reference T5, T6)."""

    optimizer: str = "adamw"  # adamw|adam|sgd|muon|prodigy|dadapt_adamw|schedule_free_adamw|sophia|momo_adam
    lr: float = 2e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    schedule: str = "warmup_cosine"  # 'warmup_cosine' | 'cosine' | 'constant' | 'two_stage'
    warmup_steps: int = 100
    end_lr_scale: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    # Stochastic coordinate preconditioning (improved.ipynb §12)
    coord_noise_sigma_start: float = 0.0
    coord_noise_sigma_end: float = 0.0


@dataclass
class TrainConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)

    train_steps: int = 2000
    global_batch: int = 16384
    micro_batch: int = 4096
    eval_every: int = 0  # 0 = only at end
    # Cases evaluated at each mid-training validation (full fold at the end).
    eval_cases: int = 8
    # Live matplotlib dashboard (reference O6): redraws loss/Dice curves and
    # GT-vs-pred slices at every eval to <out_dir>/dashboard.png.
    live_dashboard: bool = False
    checkpoint_every: int = 200
    out_dir: str = "runs/inr"
    run_name: str = "inr"
    resume_from: Optional[str] = None
    use_wandb: bool = False
    wandb_project: str = "mri-raytracer-tpu"
    log_every: int = 20
    # Parallelism: number of data-parallel shards (1 = single device).
    data_parallel: int = 1

    # ---------------------------------------------------------------- dict io
    def to_dict(self) -> Dict[str, Any]:
        return _asdict(self)

    def to_json(self, path) -> None:
        pathlib.Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    # Mapping from the reference's SHOUTY dict keys
    # (inr/interactive.ipynb §1 / inr/inr/train.py:19-36) to our tree.
    _SHOUTY = {
        "DATA_ROOT": ("data", "data_root"),
        "CASE_LIMIT": ("data", "case_limit"),
        "NUM_FOLDS": ("data", "num_folds"),
        "FOLD_INDEX": ("data", "fold_index"),
        "SEED": ("data", "seed"),
        "HIDDEN_DIMS": ("model", "hidden_dims"),
        "NUM_CLASSES": ("model", "num_classes"),
        "FOURIER_FREQS": ("model", "fourier_freqs"),
        "CLASS_WEIGHTS": ("loss", "class_weights"),
        "DICE_WEIGHT": ("loss", "dice_weight"),
        "LR": ("optim", "lr"),
        "WEIGHT_DECAY": ("optim", "weight_decay"),
        "WARMUP_STEPS": ("optim", "warmup_steps"),
        "TRAIN_STEPS": (None, "train_steps"),
        "GLOBAL_BATCH": (None, "global_batch"),
        "MICRO_BATCH": (None, "micro_batch"),
        "CHECKPOINT_EVERY_STEPS": (None, "checkpoint_every"),
        "OUT_DIR": (None, "out_dir"),
        "RUN_NAME": (None, "run_name"),
    }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        cfg = cls()
        cfg.update(d)
        return cfg

    def update(self, d: Dict[str, Any]) -> "TrainConfig":
        for k, v in d.items():
            if k in self._SHOUTY:
                section, name = self._SHOUTY[k]
                tgt = self if section is None else getattr(self, section)
                if isinstance(v, list):
                    v = tuple(v)
                setattr(tgt, name, v)
            elif isinstance(v, dict) and hasattr(self, k) and dataclasses.is_dataclass(getattr(self, k)):
                sub = getattr(self, k)
                for kk, vv in v.items():
                    if isinstance(vv, list):
                        vv = tuple(vv)
                    setattr(sub, kk, vv)
            elif hasattr(self, k):
                if isinstance(v, list):
                    v = tuple(v)
                setattr(self, k, v)
            else:
                # Search subsections for pythonic flat keys
                for section in (self.data, self.model, self.loss, self.optim):
                    if hasattr(section, k):
                        if isinstance(v, list):
                            v = tuple(v)
                        setattr(section, k, v)
                        break
        return self

    # ----------------------------------------------------------------- CLI io
    @classmethod
    def to_cli_parser(cls) -> argparse.ArgumentParser:
        """Argparse surface mirroring scripts/jax_inr_brats.py:309-344."""
        p = argparse.ArgumentParser(description="Fourier INR for BraTS")
        d = cls()
        p.add_argument("--data-root", default=d.data.data_root)
        p.add_argument("--case-limit", type=int, default=d.data.case_limit)
        p.add_argument("--num-folds", type=int, default=d.data.num_folds)
        p.add_argument("--fold-index", type=int, default=d.data.fold_index)
        p.add_argument("--seed", type=int, default=d.data.seed)
        p.add_argument("--sampler", default=d.data.sampler)
        p.add_argument("--tumor-ratio", type=float, default=d.data.tumor_ratio)
        p.add_argument("--min-subclass-samples", default=None,
                       help="comma list: NCR/NET,Edema,Enhancing")
        p.add_argument("--pool-size", type=int, default=d.data.pool_size)
        p.add_argument("--pool-refresh", type=int, default=d.data.pool_refresh)
        p.add_argument("--model", dest="kind", default=d.model.kind)
        p.add_argument("--hidden", default=",".join(map(str, d.model.hidden_dims)))
        p.add_argument("--fourier-freqs", type=int, default=d.model.fourier_freqs)
        p.add_argument("--rff-dim", type=int, default=d.model.rff_dim)
        p.add_argument("--rff-sigma", type=float, default=d.model.rff_sigma)
        p.add_argument("--num-classes", type=int, default=d.model.num_classes)
        p.add_argument("--dropout", type=float, default=d.model.dropout)
        p.add_argument("--optimizer", default=d.optim.optimizer)
        p.add_argument("--lr", type=float, default=d.optim.lr)
        p.add_argument("--weight-decay", type=float, default=d.optim.weight_decay)
        p.add_argument("--grad-clip", type=float, default=d.optim.grad_clip)
        p.add_argument("--schedule", default=d.optim.schedule)
        p.add_argument("--warmup-steps", type=int, default=d.optim.warmup_steps)
        p.add_argument("--dice-weight", type=float, default=d.loss.dice_weight)
        p.add_argument("--per-class-dice", action="store_true")
        p.add_argument("--focal-gamma", type=float, default=d.loss.focal_gamma)
        p.add_argument("--label-smoothing", type=float, default=d.loss.label_smoothing)
        p.add_argument("--freq-dropout", type=float, default=d.loss.freq_dropout)
        p.add_argument("--edema-fp-weight", type=float, default=d.loss.edema_fp_weight)
        p.add_argument("--tversky-edema-weight", type=float, default=d.loss.tversky_weight)
        p.add_argument("--tversky-edema-alpha", type=float, default=d.loss.tversky_alpha)
        p.add_argument("--tversky-edema-beta", type=float, default=d.loss.tversky_beta)
        p.add_argument("--edema-logit-reg", type=float, default=d.loss.edema_logit_reg)
        p.add_argument("--tv-weight", type=float, default=d.loss.tv_weight)
        p.add_argument("--steps", type=int, default=d.train_steps)
        p.add_argument("--global-batch", type=int, default=d.global_batch)
        p.add_argument("--micro-batch", type=int, default=d.micro_batch)
        p.add_argument("--checkpoint-every", type=int, default=d.checkpoint_every)
        p.add_argument("--out", default=d.out_dir)
        p.add_argument("--run-name", default=d.run_name)
        p.add_argument("--resume-from", default=None)
        p.add_argument("--wandb", action="store_true")
        p.add_argument("--data-parallel", type=int, default=d.data_parallel)
        return p

    @classmethod
    def from_cli(cls, argv: Optional[Sequence[str]] = None) -> "TrainConfig":
        return cls.from_args(cls.to_cli_parser().parse_args(argv))

    @classmethod
    def from_args(cls, a: argparse.Namespace) -> "TrainConfig":
        """The config of parsed ``to_cli_parser`` flags (an app may add
        flags of its own to the parser first)."""
        c = cls()
        c.data.data_root = a.data_root
        c.data.case_limit = a.case_limit
        c.data.num_folds = a.num_folds
        c.data.fold_index = a.fold_index
        c.data.seed = a.seed
        c.data.sampler = a.sampler
        c.data.tumor_ratio = a.tumor_ratio
        if a.min_subclass_samples:
            parts = tuple(int(x) for x in a.min_subclass_samples.split(","))
            if len(parts) != 3:
                raise ValueError("--min-subclass-samples needs 3 ints: NCR/NET,Edema,Enhancing")
            c.data.min_subclass_samples = parts
        c.data.pool_size = a.pool_size
        c.data.pool_refresh = a.pool_refresh
        c.model.kind = a.kind
        c.model.hidden_dims = tuple(int(x) for x in a.hidden.split(","))
        c.model.fourier_freqs = a.fourier_freqs
        c.model.rff_dim = a.rff_dim
        c.model.rff_sigma = a.rff_sigma
        c.model.num_classes = a.num_classes
        c.model.dropout = a.dropout
        c.optim.optimizer = a.optimizer
        c.optim.lr = a.lr
        c.optim.weight_decay = a.weight_decay
        c.optim.grad_clip = a.grad_clip
        c.optim.schedule = a.schedule
        c.optim.warmup_steps = a.warmup_steps
        c.loss.dice_weight = a.dice_weight
        c.loss.per_class_dice = a.per_class_dice
        c.loss.focal_gamma = a.focal_gamma
        c.loss.label_smoothing = a.label_smoothing
        c.loss.freq_dropout = a.freq_dropout
        c.loss.edema_fp_weight = a.edema_fp_weight
        c.loss.tversky_weight = a.tversky_edema_weight
        c.loss.tversky_alpha = a.tversky_edema_alpha
        c.loss.tversky_beta = a.tversky_edema_beta
        c.loss.edema_logit_reg = a.edema_logit_reg
        c.loss.tv_weight = a.tv_weight
        c.train_steps = a.steps
        c.global_batch = a.global_batch
        c.micro_batch = a.micro_batch
        c.checkpoint_every = a.checkpoint_every
        c.out_dir = a.out
        c.run_name = a.run_name
        c.resume_from = a.resume_from
        c.use_wandb = a.wandb
        c.data_parallel = a.data_parallel
        return c


@dataclass
class RenderConfig:
    """Static (compile-time) renderer configuration.

    Runtime-varying values (camera, WW/WL, weights ...) live in
    ``render.params.RenderParams`` — a pytree of arrays so interactive changes
    never retrigger XLA compilation (reference recompiles shaders instead;
    see SURVEY §7.3 'Interactivity').
    """

    width: int = 1024
    height: int = 1024
    max_steps: int = 1024  # reference brats_rt.slang:116 [MaxIters(1024)]
    num_modalities: int = 4
    show_seg: bool = True
    show_pred: bool = True
    early_stop_transmittance: float = 0.01  # reference brats_rt.slang:117
    backend: str = "auto"  # 'auto' | 'xla' | 'pallas'
    compute_dtype: str = "float32"
