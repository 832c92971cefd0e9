"""Optimizer + LR schedule zoo (port of ``train/optimizers.py``, reference
T5, T6).

The JAX package builds ``optax.chain(clip_by_global_norm(c), X(schedule))``
and steps it with ``optimizer.update``. Here ``build_optimizer`` returns a
``ClippedOptimizer``: the same chain over a ``torch.optim.Optimizer``, whose
``step()`` clips the gradients by optax's rule, sets every param group's
``lr`` to the schedule at the update count, then steps the inner optimizer.

The schedules are plain functions of the update count, written from optax's
definitions (``warmup_cosine_decay_schedule``, ``cosine_decay_schedule``,
``join_schedules``): optax evaluates a schedule at the count before it is
incremented, so the first update uses ``schedule(0)``.

``adamw``, ``adam`` and ``sgd`` are ``torch.optim``'s, which compute what
optax's do with the group's ``lr`` set each step (optax's ``adamw`` decays
every leaf, biases too, by ``lr(t) * wd * p``, as ``torch.optim.AdamW``
does); ``lion`` is ``Lion`` below. The ``optax.contrib`` optimizers are not
ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Union

import torch

from mri_raytracer_tpu_torch.config import OptimConfig

Schedule = Callable[[int], float]

# The optax.contrib optimizers of the JAX package that the port has not
# written yet (ROADMAP Queue 1, item 12a).
UNPORTED = ("muon", "prodigy", "dadapt_adamw", "schedule_free_adamw",
            "sophia", "momo_adam")


def _linear(init_value: float, end_value: float, steps: int) -> Schedule:
    """optax.linear_schedule: constant ``init_value`` for ``steps <= 0``."""
    if steps <= 0:
        return lambda count: init_value

    def sched(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init_value - end_value) * frac + end_value

    return sched


def _cosine(init_value: float, decay_steps: int, alpha: float = 0.0
            ) -> Schedule:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay_steps}.")

    def sched(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return sched


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules of two schedules."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def _warmup_cosine(init_value: float, peak_value: float, warmup_steps: int,
                   decay_steps: int, end_value: float) -> Schedule:
    """optax.warmup_cosine_decay_schedule."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return _join(_linear(init_value, peak_value, warmup_steps),
                 _cosine(peak_value, decay_steps - warmup_steps, alpha),
                 warmup_steps)


def build_schedule(cfg: OptimConfig, total_steps: int
                   ) -> Union[float, Schedule]:
    if cfg.schedule == "constant":
        return cfg.lr
    if cfg.schedule == "warmup_cosine":
        return _warmup_cosine(
            cfg.lr * 0.01, cfg.lr,
            min(cfg.warmup_steps, max(1, total_steps // 10)),
            max(total_steps, cfg.warmup_steps + 1),
            cfg.lr * cfg.end_lr_scale)
    if cfg.schedule == "cosine":
        return _cosine(cfg.lr, max(1, total_steps), alpha=cfg.end_lr_scale)
    if cfg.schedule == "two_stage":
        # Coarse (higher LR, 40%) then refine (cosine down), both with warmup.
        split = max(1, int(total_steps * 0.4))
        coarse = _warmup_cosine(cfg.lr * 0.01, cfg.lr,
                                min(cfg.warmup_steps, split // 2), split,
                                cfg.lr * 0.5)
        refine = _cosine(cfg.lr * 0.5, max(1, total_steps - split),
                         alpha=cfg.end_lr_scale)
        return _join(coarse, refine, split)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


class Lion(torch.optim.Optimizer):
    """optax.lion (0.2.6): ``u = sign((1 - b1) g + b1 m)``, then
    ``m <- (1 - b2) g + b2 m``, and ``p <- p - lr (u + wd p)``."""

    def __init__(self, params, lr: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.99, weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, b1, b2 = group["lr"], group["b1"], group["b2"]
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                mu, g = state["mu"], p.grad
                u = torch.sign((1.0 - b1) * g + b1 * mu)
                mu.copy_((1.0 - b2) * g + b2 * mu)
                p.add_(-lr * (u + wd * p))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: ``g / |g| * max_norm`` where the
    global norm ``|g|`` is not below ``max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). Stays on the device: no host
    sync."""
    norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class ClippedOptimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), X(schedule))`` over a
    torch optimizer X. ``step()`` applies one update from the parameters'
    ``.grad``; ``count`` is optax's update count."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Union[float, Schedule], grad_clip: float):
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip = float(grad_clip)
        self.count = 0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        groups = self.optimizer.param_groups
        if self.grad_clip > 0:
            clip_by_global_norm_([p.grad for g in groups for p in g["params"]
                                  if p.grad is not None], self.grad_clip)
        s = self.schedule
        lr = float(s(self.count)) if callable(s) else float(s)
        for group in groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"optimizer": self.optimizer.state_dict(),
                "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


def build_optimizer(cfg: OptimConfig, total_steps: int,
                    params: Union[torch.nn.Module, Iterable[torch.Tensor]]
                    ) -> ClippedOptimizer:
    """The optimizer of ``cfg`` over ``params`` (a module or its
    parameters), stepping ``total_steps`` times."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    params = list(params)
    sched = build_schedule(cfg, total_steps)
    lr0 = sched(0) if callable(sched) else sched
    name = cfg.optimizer.lower()
    if name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr0, betas=(cfg.b1, cfg.b2),
                                eps=1e-8, weight_decay=cfg.weight_decay)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=lr0, betas=(cfg.b1, cfg.b2),
                               eps=1e-8)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr0, momentum=0.9)
    elif name == "lion":
        opt = Lion(params, lr=lr0, weight_decay=cfg.weight_decay)
    elif name in UNPORTED:
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} (optax.contrib in the JAX package) "
            "is not ported yet: ROADMAP Queue 1, item 12a")
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return ClippedOptimizer(opt, sched, cfg.grad_clip)
