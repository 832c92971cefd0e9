"""Training orchestrator (port of ``train/engine.py``, reference T1
``train_inr``).

Pipeline: config -> case discovery/split -> host cache -> device pool ->
model init -> optimizer/schedule -> step loop (sampling + gradient
accumulation + update, all on the device) -> periodic checkpoints ->
evaluation -> final object checkpoint + JSON sidecar + logging. Line for
line with the JAX package's ``train_inr``, with these differences:
  * it runs on ``device`` (``cuda`` unless given) and never falls back;
  * random numbers come from a ``torch.Generator`` on that device seeded
    ``DataConfig.seed`` (the init draws from a CPU generator with the same
    seed), and an exact resume restores the generator's state;
  * the host reads the step's metrics only at the log steps;
  * ``data_parallel > 1`` runs one process a device: every rank of an
    initialized process group of ``data_parallel`` ranks calls
    ``train_inr`` (``torchrun --nproc-per-node N``), the step is
    ``parallel.training.build_dp_train_step``, rank 0 alone writes files,
    and every rank returns the same state.
"""

from __future__ import annotations

import pathlib
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from mri_raytracer_tpu_torch import convert
from mri_raytracer_tpu_torch.config import TrainConfig
from mri_raytracer_tpu_torch.data import cache as cache_mod
from mri_raytracer_tpu_torch.data import pool as pool_mod
from mri_raytracer_tpu_torch.data import sampling
from mri_raytracer_tpu_torch.env import resolve_device
from mri_raytracer_tpu_torch.eval import inference
from mri_raytracer_tpu_torch.io import checkpoint as ckpt
from mri_raytracer_tpu_torch.io.logging import RunLogger
from mri_raytracer_tpu_torch.models.api import build_model
from mri_raytracer_tpu_torch.parallel import mesh as mesh_mod
from mri_raytracer_tpu_torch.parallel import training as ptrain
from mri_raytracer_tpu_torch.train import optimizers, steps


class _Silent:
    """The logger of a rank that writes nothing: every method a no-op."""

    def __getattr__(self, name):
        return lambda *a, **kw: None


def _dp_mesh(data_parallel: int) -> Optional[mesh_mod.Mesh]:
    """The data-parallel mesh, or None for one process. One process drives
    one device, so ``data_parallel`` must be the process group's size."""
    if data_parallel <= 1:
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != data_parallel:
        raise ValueError(
            f"data_parallel={data_parallel} needs an initialized process "
            f"group of {data_parallel} ranks, one a device; have {world} "
            "(launch with torchrun --nproc-per-node "
            f"{data_parallel})")
    return mesh_mod.make_mesh(data=data_parallel)


def train_inr(config: TrainConfig | Dict[str, Any],
              use_wandb: Optional[bool] = None,
              resume_from: Optional[str] = None,
              device=None) -> Dict[str, Any]:
    """Train an INR; returns a state dict with params, metrics and paths.

    Accepts a ``TrainConfig`` or a reference-style SHOUTY/pythonic dict.
    """
    dev = resolve_device(device)
    if isinstance(config, dict):
        config = TrainConfig.from_dict(config)
    if use_wandb is not None:
        config.use_wandb = use_wandb
    if resume_from is not None:
        config.resume_from = resume_from
    mesh = _dp_mesh(config.data_parallel)
    # Rank 0 of the data axis alone writes files.
    lead = mesh is None or mesh.axis("data").index == 0

    out_dir = pathlib.Path(config.out_dir)
    if lead:
        out_dir.mkdir(parents=True, exist_ok=True)

    # ---------------------------------------------------------------- data
    dc = config.data
    train_cache, val_cache, info = cache_mod.build_train_val_caches(
        dc.data_root, dc.case_limit, dc.num_folds, dc.fold_index, dc.seed,
        cache_kind="ram", verbose=False)
    if lead:
        cache_mod.save_splits(out_dir / "splits", info["train_cases"],
                              info["val_cases"])
    # Boundary-weighted loss (reference L8): precompute 1/(1+EDT) maps once
    # per case and carry them in the device pool; every sampler gathers them
    # into per-sample weights.
    use_boundary = config.loss.boundary_weight > 0.0
    if use_boundary:
        for i in range(train_cache.n_cases):
            c = train_cache.get(i)
            if "boundary" not in c:
                c["boundary"] = cache_mod.ChunkedCache.boundary_map(c["seg"])
    dev_pool = pool_mod.DevicePool(train_cache, dc.pool_size, seed=dc.seed,
                                   device=dev, with_boundary=use_boundary)

    # --------------------------------------------------------------- model
    model = build_model(config.model, train_cache.n_modalities,
                        rff_seed=dc.seed)
    # Data-parallel ranks share a CPU key that seeds each step's rank
    # generators (parallel/training.py).
    generator = torch.Generator(device=dev if mesh is None else "cpu") \
        .manual_seed(dc.seed)
    params = model.init(torch.Generator().manual_seed(dc.seed))

    start_step = 0
    resumed_state = None
    if config.resume_from:
        try:
            resumed_state = ckpt.load_train_state(config.resume_from)
            loaded = resumed_state["params"]
        except KeyError:
            loaded = ckpt.load_params(config.resume_from)
        ckpt.check_resume_shapes(params, loaded)
        params.load_state_dict({k: torch.tensor(v) for k, v in
                                convert.flatten_tree(loaded).items()})
        print(f"[train] resumed from {config.resume_from}"
              + (" (exact train state)" if resumed_state
                 else " (params only)"))
    params = params.to(dev)

    # ----------------------------------------------------------- optimizer
    optimizer = optimizers.build_optimizer(config.optim, config.train_steps,
                                           params)
    if resumed_state is not None:
        # Exact resume: optimizer moments + RNG stream + step counter.
        optimizer.load_state_dict(resumed_state["opt_state"])
        generator.set_state(resumed_state["rng_state"])
        start_step = resumed_state["step"]

    # global = micro * accum * dp: each data-parallel rank samples its own
    # micro-batches, so accumulation shrinks as the mesh grows.
    dp = max(1, config.data_parallel)
    accum_steps = max(1, -(-config.global_batch // (config.micro_batch * dp)))
    micro = config.micro_batch
    sampler = sampling.make_sampler(dc.sampler, micro, dc.tumor_ratio,
                                    dc.min_subclass_samples, model=model)
    coord_noise = steps.make_coord_noise_schedule(
        config.optim.coord_noise_sigma_start,
        config.optim.coord_noise_sigma_end, config.train_steps)
    if mesh is not None:
        step_fn = ptrain.build_dp_train_step(
            model, config.loss, optimizer, sampler, accum_steps, dp,
            coord_noise, mesh)
    else:
        step_fn = steps.build_train_step(model, config.loss, optimizer,
                                         sampler, accum_steps, coord_noise)

    # ------------------------------------------------------------- logging
    logger = RunLogger(out_dir, config.run_name, config.to_dict(),
                       use_wandb=config.use_wandb,
                       wandb_project=config.wandb_project) if lead \
        else _Silent()
    from mri_raytracer_tpu_torch.io.dashboard import TrainingDashboard

    dashboard = TrainingDashboard(out_dir, config.model.num_classes,
                                  enabled=config.live_dashboard and lead)

    # ------------------------------------------------------------ hot loop
    t_start = time.time()
    history = []
    best_val = {"mean_dice": -1.0, "step": -1}
    for step in range(start_step + 1, config.train_steps + 1):
        dev_pool.maybe_refresh(step, dc.pool_refresh)
        m = step_fn(params, optimizer, generator, dev_pool.mods,
                    dev_pool.segs, step, dev_pool.boundary)
        if step % config.log_every == 0 or step == 1:
            loss = float(m.loss)
            dpc = m.dice_per_class.cpu().numpy()
            cpc = m.ce_per_class.cpu().numpy()
            scal = {"train/loss": loss, "train/ce": float(m.ce),
                    "train/dice_mean": float(np.mean(dpc))}
            scal.update({f"train/dice_class_{i}": float(v)
                         for i, v in enumerate(dpc)})
            scal.update({f"train/ce_class_{i}": float(v)
                         for i, v in enumerate(cpc)})
            logger.log(scal, step)
            history.append({"step": step, "loss": loss})
        if lead and config.checkpoint_every > 0 \
                and step % config.checkpoint_every == 0:
            stem = out_dir / f"{config.run_name}_step{step:06d}.npz"
            if isinstance(ckpt.params_to_numpy(params), list):
                ckpt.save_flat(params, stem)  # reference flat format
            else:
                ckpt.save_object(params, stem)
            # Exact-resume state (latest only; overwritten each time).
            ckpt.save_train_state(
                out_dir / f"{config.run_name}_trainstate.npz", params,
                optimizer, generator, step, info={"step": step})
        # Periodic validation + slice viz + best-checkpoint tracking
        # (reference T1: predict_slice every N steps, best save after val).
        if (config.eval_every > 0 and step % config.eval_every == 0
                and val_cache is not None and val_cache.n_cases > 0):
            case0 = val_cache.get(0)
            mods_t = torch.as_tensor(case0["mods"], dtype=torch.float32,
                                     device=dev)
            z_mid = case0["seg"].shape[-1] // 2
            pred_slice = inference.predict_slice(model, params, mods_t, z_mid)
            from mri_raytracer_tpu_torch.eval import metrics as _metrics

            sl_dice = _metrics.macro_slice_dice(pred_slice,
                                                case0["seg"][:, :, z_mid])
            _, agg = inference.evaluate_cases(
                model, params,
                [val_cache.get(i)
                 for i in range(min(val_cache.n_cases, config.eval_cases))],
                num_classes=config.model.num_classes, device=dev)
            md = agg["mean_dice"][0]
            logger.log({"val/mean_dice": md, "val/slice_dice_mid": sl_dice},
                       step)
            # Rich observability (reference O3/O6): per-class Dice bar +
            # metric table + GT-vs-pred slice overlay + live dashboard.
            nc = config.model.num_classes
            dpc_val = [agg[f"dice_class_{c}"][0] for c in range(nc)]
            logger.log_bar("val/dice_per_class",
                           [f"class_{c}" for c in range(nc)], dpc_val, step)
            logger.log_table(
                "val/metrics", ["class", "dice", "hausdorff"],
                [[c, agg[f"dice_class_{c}"][0], agg[f"hd_class_{c}"][0]]
                 for c in range(nc)], step)
            from mri_raytracer_tpu_torch.data import brats as _brats
            from mri_raytracer_tpu_torch.io.dashboard import label_overlay

            base_img = _brats.percentile_normalize(
                np.asarray(case0["mods"][0, :, :, z_mid]))
            gt_slice = case0["seg"][:, :, z_mid]
            logger.log_image("val/slice_overlay",
                             np.concatenate([label_overlay(base_img, gt_slice),
                                             label_overlay(base_img,
                                                           pred_slice)], 1),
                             step, caption=f"GT | pred (z={z_mid})")
            dashboard.update(step, float(m.loss),
                             m.dice_per_class.cpu().numpy(), gt_slice,
                             pred_slice, base_img)
            if np.isfinite(md) and md > best_val["mean_dice"]:
                best_val = {"mean_dice": md, "step": step}
                if lead:
                    ckpt.save_object(
                        params, out_dir / f"{config.run_name}_best.npz",
                        info={"step": step, "val_mean_dice": md})
    train_time = time.time() - t_start

    # ---------------------------------------------------------- final save
    final_path = out_dir / f"{config.run_name}.npz"
    info_payload = {**config.to_dict(),
                    "FOURIER_FREQS": config.model.fourier_freqs,
                    "NUM_CLASSES": config.model.num_classes,
                    "HIDDEN_DIMS": list(config.model.hidden_dims),
                    "train_time_sec": train_time}
    if lead:
        ckpt.save_object(params, final_path, info=info_payload)
    if lead and isinstance(ckpt.params_to_numpy(params), list):
        ckpt.save_flat(params, out_dir / f"{config.run_name}_flat.npz")

    # ----------------------------------------------------------- evaluation
    eval_agg = None
    if val_cache is not None and val_cache.n_cases > 0:
        results, eval_agg = inference.evaluate_cases(
            model, params, [val_cache.get(i)
                            for i in range(val_cache.n_cases)],
            num_classes=config.model.num_classes, device=dev)
        logger.log_summary({"val": {k: list(v) for k, v in eval_agg.items()}})
        logger.save_best({"val": {k: list(v) for k, v in eval_agg.items()},
                          "checkpoint": str(final_path)})
        # Final rich logging (reference train.py:426-435).
        nc = config.model.num_classes
        logger.log_bar("final/dice_per_class",
                       [f"class_{c}" for c in range(nc)],
                       [eval_agg[f"dice_class_{c}"][0] for c in range(nc)],
                       config.train_steps)
        logger.log_table(
            "final/metrics", ["class", "dice_mean", "dice_std", "hd_mean"],
            [[c, *eval_agg[f"dice_class_{c}"], eval_agg[f"hd_class_{c}"][0]]
             for c in range(nc)], config.train_steps)
    logger.log_summary({"train_time_sec": train_time,
                        "final_checkpoint": str(final_path)})
    logger.log_artifact(final_path)
    # Separate best-model artifact (reference train.py:447-461).
    best_path = out_dir / f"{config.run_name}_best.npz"
    if best_path.exists():
        logger.log_artifact(best_path, kind="best-model")
    logger.finish()

    return {"params": params, "model": model, "config": config,
            "train_cache": train_cache, "val_cache": val_cache,
            "history": history, "eval": eval_agg,
            "checkpoint": str(final_path), "train_time_sec": train_time}
