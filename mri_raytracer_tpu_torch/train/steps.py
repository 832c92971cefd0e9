"""The training step (port of ``train/steps.py``).

One step samples ``accum_steps`` micro-batches from the device pool, runs
each through the model and the loss with ``backward()``, averages the
summed gradients, and applies one optimizer update: what the JAX package's
jitted step does with ``lax.scan`` over micro-batch keys
(``steps.py:121``). Everything stays on the device; the step returns its
metrics as device tensors, so the host reads them only when it logs.
Random draws (sampling, coordinate noise, the TV patch, dropout) come from
the ``torch.Generator`` passed in, in that order per micro-batch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from mri_raytracer_tpu_torch import losses
from mri_raytracer_tpu_torch.config import LossConfig
from mri_raytracer_tpu_torch.data.sampling import mc_dropout_entropy
from mri_raytracer_tpu_torch.env import device_floats
from mri_raytracer_tpu_torch.models.api import ModelBundle


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    ce: torch.Tensor
    dice_per_class: torch.Tensor
    ce_per_class: torch.Tensor


def make_loss(model: ModelBundle, loss_cfg: LossConfig, tv_patch: int = 24):
    num_classes = model.cfg.num_classes

    def loss_fn(params, batch, rng, tv_batch=None):
        logits = model.apply(params, batch.coords, batch.intensities,
                             rng=rng, train=True,
                             freq_dropout=loss_cfg.freq_dropout)
        total, aux = losses.segmentation_loss(logits, batch.labels, loss_cfg,
                                              num_classes, batch.weights)
        if loss_cfg.tv_weight > 0.0 and tv_batch is not None:
            # Spatial-coherence TV on a predicted probability patch
            # (reference L8): tv_batch carries an in-plane coords/intensity
            # grid of (P, P) voxels.
            tv_coords, tv_intens = tv_batch
            P = int(round(tv_coords.shape[0] ** 0.5))
            tv_logits = model.apply(params, tv_coords, tv_intens)
            probs = torch.softmax(tv_logits, -1).reshape(P, P, num_classes)
            total = total + loss_cfg.tv_weight * losses.tv_loss_slice(probs)
        return total, aux

    return loss_fn


def sample_tv_patch(generator: torch.Generator, mods_pool: torch.Tensor,
                    tv_patch: int = 24):
    """(P*P, 3) normalized coords + (P*P, M) intensities of a random axial
    patch of one pool case. The corner is drawn as (1,) tensors that
    broadcast in the gather: a 0-d tensor index is read on the host, a
    sync."""
    Pn, M, H, W, D = mods_pool.shape
    P = min(tv_patch, H, W)
    dev = mods_pool.device

    def draw(high):
        return torch.randint(0, high, (1,), generator=generator, device=dev)

    ci, x0, y0, z = draw(Pn), draw(max(H - P, 1)), draw(max(W - P, 1)), \
        draw(D)
    ar = torch.arange(P, device=dev)
    xs, ys = x0 + ar, y0 + ar
    intens = mods_pool[ci, :, xs[:, None], ys[None, :], z].reshape(-1, M)
    gx, gy = torch.meshgrid(xs.to(torch.float32), ys.to(torch.float32),
                            indexing="ij")
    gz = z.to(torch.float32).expand(P, P)
    coords = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
    dims = device_floats((H - 1, W - 1, D - 1), dev)
    return (coords / dims) * 2.0 - 1.0, intens


def build_train_step(model: ModelBundle, loss_cfg: LossConfig, optimizer,
                     sampler: Callable, accum_steps: int,
                     coord_noise: Optional[Callable] = None,
                     grad_psum_axis=None):
    """Returns ``step(params, optimizer, generator, mods_pool, segs_pool,
    step_idx, boundary_pool=None) -> StepMetrics``, which updates
    ``params`` (the model's ``nn.Module``) in place through ``optimizer``
    (``train.optimizers.ClippedOptimizer``).

    ``coord_noise(step_idx) -> sigma`` enables stochastic preconditioning
    (reference T7, ``improved.ipynb §12``: Gaussian coordinate noise with
    annealed sigma). ``grad_psum_axis`` (a ``parallel.mesh.MeshAxis``)
    turns it into one rank's data-parallel step: the mean gradient and the
    metrics are averaged over that mesh axis before the update, so every
    rank applies the same one (``parallel/training.py``).
    """
    tv_patch = 24
    loss_fn = make_loss(model, loss_cfg, tv_patch)
    inv = 1.0 / accum_steps

    def step(params, optimizer, generator, mods_pool, segs_pool, step_idx,
             boundary_pool=None):
        sigma = coord_noise(step_idx) if coord_noise is not None else 0.0
        optimizer.zero_grad()
        l_sum = aux_sum = None
        for _ in range(accum_steps):
            batch = sampler(generator, mods_pool, segs_pool, params,
                            boundary_pool)
            if coord_noise is not None:
                noise = torch.randn(batch.coords.shape, generator=generator,
                                    device=batch.coords.device) * sigma
                batch = batch._replace(coords=batch.coords + noise)
            tv_batch = (sample_tv_patch(generator, mods_pool, tv_patch)
                        if loss_cfg.tv_weight > 0.0 else None)
            total, aux = loss_fn(params, batch, generator, tv_batch)
            total.backward()
            total, aux = total.detach(), {k: v.detach()
                                          for k, v in aux.items()}
            if l_sum is None:
                l_sum, aux_sum = total, aux
            else:
                l_sum = l_sum + total
                aux_sum = {k: aux_sum[k] + aux[k] for k in aux}
        # Gradients summed over the micro-batches, then averaged, as the
        # JAX step sums them in its scan and scales by 1/accum_steps.
        with torch.no_grad():
            for p in params.parameters():
                if p.grad is not None:
                    p.grad.mul_(inv)
        metrics = StepMetrics(loss=l_sum * inv, ce=aux_sum["ce"] * inv,
                              dice_per_class=aux_sum["dice_per_class"] * inv,
                              ce_per_class=aux_sum["ce_per_class"] * inv)
        if grad_psum_axis is not None:
            metrics = _mean_over_axis(params, metrics, grad_psum_axis)
        # The mean loss reaches the optimizers that read it (momo_adam), as
        # the JAX step passes value=metrics.loss.
        optimizer.step(value=metrics.loss)
        return metrics

    return step


def _mean_over_axis(params, metrics: StepMetrics, axis) -> StepMetrics:
    """Average the gradients of ``params`` (in place) and ``metrics`` over
    mesh axis ``axis`` with one all-reduce of a flat buffer: a sum, then a
    division by the axis size (``ReduceOp.AVG`` is not on every backend
    and version)."""
    grads = [p.grad for p in params.parameters() if p.grad is not None]
    parts = grads + list(metrics)
    flat = torch.cat([t.reshape(-1) for t in parts])
    axis.all_reduce_sum(flat)
    flat.div_(axis.size)
    pieces = [piece.view_as(t) for t, piece in
              zip(parts, torch.split(flat, [t.numel() for t in parts]))]
    with torch.no_grad():
        for g, piece in zip(grads, pieces):
            g.copy_(piece)
    return StepMetrics(*pieces[len(grads):])


def make_coord_noise_schedule(sigma_start: float, sigma_end: float,
                              total_steps: int) -> Optional[Callable]:
    """Linear anneal sigma_start -> sigma_end (reference: 0.3 -> 0.1)."""
    if sigma_start <= 0.0 and sigma_end <= 0.0:
        return None

    def sched(step_idx):
        frac = min(max(float(step_idx) / max(total_steps, 1), 0.0), 1.0)
        return sigma_start + (sigma_end - sigma_start) * frac

    return sched


def make_uncertainty_fn(model: ModelBundle, params_ref, n_mc: int = 4,
                        base_key: int = 0):
    """MC-dropout predictive-entropy scorer for the hybrid sampler
    (reference D13, ``improved.ipynb §9``). Closure over current params via
    a mutable cell updated by the engine between steps; every call draws
    its dropout masks from a generator seeded ``base_key``, as the JAX
    scorer splits the same key every call."""

    def fn(coords, intensities):
        g = torch.Generator(device=coords.device).manual_seed(base_key)
        return mc_dropout_entropy(model, params_ref[0], coords, intensities,
                                  g, n_mc)

    return fn
