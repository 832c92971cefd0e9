"""Data-parallel training over a rank mesh (port of
``parallel/training.py``).

Each rank of the mesh's ``data`` axis runs the same step on its own
micro-batches: parameters and optimizer state stay replicated (every rank
starts from the same ones and applies the same averaged update), each
rank samples from a generator decorrelated by its index on the axis, and
gradients and metrics are averaged over the axis before the update
(``train.steps.build_train_step(grad_psum_axis=)``).

Random numbers follow the JAX step's keys: the caller passes one
replicated generator (the key); each step draws one seed from it, folds in
the rank's index on ``data`` (``fold_in``, the counterpart of
``jax.random.fold_in(key, axis_index("data"))``) and seeds the rank's own
generator on the pool's device with the result. An exact resume then
needs only the key's state, which every rank holds.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mri_raytracer_tpu_torch.config import LossConfig
from mri_raytracer_tpu_torch.models.api import ModelBundle
from mri_raytracer_tpu_torch.parallel import mesh as mesh_mod
from mri_raytracer_tpu_torch.train import steps

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, index: int) -> int:
    """A 63-bit seed decorrelated from ``seed`` by ``index``: splitmix64's
    finalizer over seed + (index + 1) * the golden-ratio increment."""
    z = (seed + (index + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def shard_seed(generator: torch.Generator, index: int) -> int:
    """One step's seed for the rank at ``index`` on ``data``: a draw from
    the replicated ``generator`` with the index folded in. The draw is read
    on the host, so a CPU generator costs no device sync."""
    draw = torch.randint(0, 1 << 62, (1,), generator=generator,
                         device=generator.device)
    return fold_in(int(draw), index)


def build_dp_train_step(model: ModelBundle, loss_cfg: LossConfig, optimizer,
                        sampler: Callable, accum_steps: int,
                        data_parallel: int,
                        coord_noise: Optional[Callable] = None,
                        mesh: Optional[mesh_mod.Mesh] = None):
    """``step(params, optimizer, generator, mods_pool, segs_pool, step_idx,
    boundary_pool=None) -> StepMetrics`` of this rank, on a mesh whose
    ``data`` axis has ``data_parallel`` ranks (default
    ``make_mesh(data=data_parallel)``). ``generator`` is the replicated
    key (module docstring); the returned metrics are the axis means."""
    mesh = mesh or mesh_mod.make_mesh(data=data_parallel)
    axis = mesh.axis("data")
    if axis.size != data_parallel:
        raise ValueError(f"data_parallel={data_parallel} on a mesh whose "
                         f"data axis has {axis.size} ranks")
    core = steps.build_train_step(model, loss_cfg, optimizer, sampler,
                                  accum_steps, coord_noise,
                                  grad_psum_axis=axis)

    def step(params, optimizer, generator, mods_pool, segs_pool, step_idx,
             boundary_pool=None):
        g = torch.Generator(device=mods_pool.device).manual_seed(
            shard_seed(generator, axis.index))
        return core(params, optimizer, g, mods_pool, segs_pool, step_idx,
                    boundary_pool)

    return step
