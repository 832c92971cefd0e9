"""Optimizer + LR schedule zoo (port of ``train/optimizers.py``, reference
T5, T6).

The JAX package builds ``optax.chain(clip_by_global_norm(c), X)`` and
steps it with ``optimizer.update(grads, state, params, value=loss)``. Here
``build_optimizer`` returns a ``ClippedOptimizer``: the same chain over a
``torch.optim.Optimizer``, whose ``step(value=)`` clips the gradients by
optax's rule, sets every param group's ``lr`` to the optimizer's learning
rate at the update count, then steps the inner optimizer.

The schedules are plain functions of the update count, written from optax's
definitions (``warmup_cosine_decay_schedule``, ``cosine_decay_schedule``,
``join_schedules``): optax evaluates a schedule at the count before it is
incremented, so the first update uses ``schedule(0)``. Only adamw, adam,
sgd, lion and muon take the schedule, as in the JAX package; prodigy and
dadapt_adamw run at a constant 1.0, schedule_free_adamw and momo_adam at
a constant ``cfg.lr``.

``adamw``, ``adam`` and ``sgd`` are ``torch.optim``'s, which compute what
optax's do with the group's ``lr`` set each step (optax's ``adamw`` decays
every leaf, biases too, by ``lr(t) * wd * p``, as ``torch.optim.AdamW``
does). ``lion`` and the five ``optax.contrib`` optimizers (``Muon``,
``Prodigy``, ``DAdaptAdamW``, ``ScheduleFreeAdamW``, ``MomoAdam``) are
written here from optax 0.2.6's definitions, operation for operation in
float32, with optax's bias corrections ``1 - b**count`` rounded in float32
(``_bias``). Their scalar state (D-Adaptation's estimate, Momo's averages)
stays on the parameters' device, so a step makes no host sync. ``sophia``
raises optax's ``ValueError`` when built: optax's Hutchinson estimator
needs an ``obj_fn`` that the JAX train step never passes, so JAX's
``sophia`` fails on its first update (``tests/test_training.py:75-77``
leaves it out).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from mri_raytracer_tpu_torch.config import OptimConfig

Schedule = Callable[[int], float]


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


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float: a scalar optax computes
    in float32, which then multiplies a float32 tensor exactly."""
    return float(np.float32(x))


def _bias(decay: float, count: int) -> float:
    """optax's bias correction ``1 - decay**count`` in float32."""
    return _f32(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _vdot(xs: Iterable[torch.Tensor], ys: Iterable[torch.Tensor]
          ) -> torch.Tensor:
    """optax.tree.vdot: the sum over leaves of each leaf's inner product."""
    return torch.stack([torch.sum(x * y) for x, y in zip(xs, ys)]).sum()


def _abs_sum(xs: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax.tree.sum of the leaves' absolute values."""
    return torch.stack([torch.sum(torch.abs(x)) for x in xs]).sum()


class _TreeOptimizer(torch.optim.Optimizer):
    """A ``torch.optim.Optimizer`` over one param group that updates all
    leaves together, as an optax transformation updates a pytree. Scalar
    state lives in the first parameter's state (so ``state_dict`` carries
    it and ``load_state_dict`` moves it to the device); ``count`` is
    optax's update count, a host int."""

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    def _scalars(self) -> Dict:
        return self.state[self.param_groups[0]["params"][0]]

    def _grads(self) -> List[torch.Tensor]:
        ps = self._params()
        # optax updates every leaf; a leaf without a gradient takes zeros.
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in ps]


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


# optax.contrib.muon's defaults: Newton-Schulz coefficients and steps,
# momentum, epsilon, and its Adam's b1 / b2 for the other leaves.
NS_COEFFS = (3.4445, -4.7750, 2.0315)
NS_STEPS = 5
MUON_BETA = 0.95
EPS = 1e-8
ADAM_B1, ADAM_B2 = 0.9, 0.999
# prodigy's and dadapt_adamw's initial estimate of the step size d.
ESTIM_LR0 = 1e-6


def newton_schulz(x: torch.Tensor) -> torch.Tensor:
    """optax's ``orthogonalize_via_newton_schulz`` of a 2-D leaf (reduction
    axis 0, output axis 1): the wide orientation, scaled to Frobenius norm
    1, through NS_STEPS quintic iterations ``c0 x + (c1 A + c2 A A) x``
    with ``A = x x^T``."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.vector_norm(x) + EPS)
    c0, c1, c2 = NS_COEFFS
    for _ in range(NS_STEPS):
        a = x @ x.T
        b = c1 * a + c2 * a @ a
        x = c0 * x + b @ x
    return x.T if transposed else x


class Muon(_TreeOptimizer):
    """optax.contrib.muon (0.2.6) at its defaults: 2-D leaves take
    Nesterov momentum (beta 0.95) orthogonalized by ``newton_schulz`` and
    scaled by ``sqrt(max(1, out / in))``; every other leaf takes optax's
    ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, Nesterov, no decay). Both parts
    then scale by ``-lr``. A leaf is a 2-D parameter with axis 0 its input
    (reduction) axis and axis 1 its output axis, as the JAX leaf has them:
    the port's modules store 2-D weights in the JAX layout
    (``models/mlp.py``)."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        lr = self.param_groups[0]["lr"]
        sc = self._scalars()
        count = sc.get("count", 0) + 1
        for p, g in zip(self._params(), self._grads()):
            st = self.state[p]
            if "mu" not in st:
                st["mu"] = torch.zeros_like(p)
                if p.ndim != 2:
                    st["nu"] = torch.zeros_like(p)
            if p.ndim == 2:
                b = MUON_BETA
                mu = (1 - b) * g + b * st["mu"]
                mu_hat = (b * (mu / _bias(b, count + 1))
                          + (1 - b) * (g / _bias(b, count)))
                u = newton_schulz(mu_hat)
                u = _f32(np.sqrt(np.float32(max(1.0, p.shape[1]
                                                / p.shape[0])))) * u
            else:
                b1, b2 = ADAM_B1, ADAM_B2
                mu = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = (1 - b2) * g ** 2 + b2 * st["nu"]
                mu_hat = (b1 * (mu / _bias(b1, count + 1))
                          + (1 - b1) * (g / _bias(b1, count)))
                nu_hat = st["nu"] / _bias(b2, count)
                u = mu_hat / (torch.sqrt(nu_hat) + EPS)
            st["mu"] = mu
            p.add_(_f32(-lr) * u)
        sc["count"] = count


class Prodigy(_TreeOptimizer):
    """optax.contrib.prodigy (0.2.6) at ``betas=(0.9, 0.999)``, beta3 =
    sqrt(b2), eps 1e-8, estim_lr0 1e-6: D-Adaptation whose learning-rate
    estimate ``d`` weights recent gradients more, AdamW-style decay
    ``-wd * dlr * p``."""

    def __init__(self, params, weight_decay: float):
        super().__init__(params, dict(lr=1.0))
        self.wd = weight_decay

    @torch.no_grad()
    def step(self, closure=None):
        ps, gs = self._params(), self._grads()
        sched = self.param_groups[0]["lr"]
        sc = self._scalars()
        if "estim_lr" not in sc:
            sc["estim_lr"] = torch.full((), ESTIM_LR0, dtype=torch.float32,
                                        device=ps[0].device)
            sc["numerator_weighted"] = torch.zeros_like(sc["estim_lr"])
            for p in ps:
                self.state[p].update(exp_avg=torch.zeros_like(p),
                                     exp_avg_sq=torch.zeros_like(p),
                                     grad_sum=torch.zeros_like(p),
                                     params0=p.clone())
        count = sc.get("count", 0) + 1
        b1, b2 = ADAM_B1, ADAM_B2
        b3 = b2 ** 0.5
        bc = _f32(np.float32(_bias(b2, count)) ** np.float32(0.5)
                  / np.float32(_bias(b1, count)))
        estim_lr = sc["estim_lr"]
        dlr = estim_lr * sched * bc
        numerator_acum = _vdot(gs, [self.state[p]["params0"] - p
                                    for p in ps])
        for p, g in zip(ps, gs):
            st = self.state[p]
            dg = estim_lr * g
            st["exp_avg"] = b1 * st["exp_avg"] + (1 - b1) * dg
            st["exp_avg_sq"] = b2 * st["exp_avg_sq"] + (1 - b2) * dg * dg
            st["grad_sum"] = b3 * st["grad_sum"] + dlr * dg / ESTIM_LR0
        nw = b3 * sc["numerator_weighted"]
        nw = nw + (estim_lr / ESTIM_LR0) * dlr * numerator_acum
        denominator = _abs_sum(self.state[p]["grad_sum"] for p in ps)
        new_estim = torch.maximum(estim_lr, 1.0 * nw / denominator)
        for p in ps:
            st = self.state[p]
            p.add_(-self.wd * dlr * p - dlr * st["exp_avg"]
                   / (torch.sqrt(st["exp_avg_sq"]) + new_estim * EPS))
        sc.update(estim_lr=new_estim, numerator_weighted=nw, count=count)


class DAdaptAdamW(_TreeOptimizer):
    """optax.contrib.dadapt_adamw (0.2.6) at ``betas=(0.9, 0.999)``, eps
    1e-8, estim_lr0 1e-6: AdamW whose step size ``d`` is D-Adaptation's
    lower bound on the distance to the solution."""

    def __init__(self, params):
        super().__init__(params, dict(lr=1.0))

    @torch.no_grad()
    def step(self, closure=None):
        ps, gs = self._params(), self._grads()
        sched = self.param_groups[0]["lr"]
        sc = self._scalars()
        if "estim_lr" not in sc:
            sc["estim_lr"] = torch.full((), ESTIM_LR0, dtype=torch.float32,
                                        device=ps[0].device)
            sc["numerator_weighted"] = torch.zeros_like(sc["estim_lr"])
            for p in ps:
                self.state[p].update(exp_avg=torch.zeros_like(p),
                                     exp_avg_sq=torch.zeros_like(p),
                                     grad_sum=torch.zeros_like(p))
        count = sc.get("count", 0) + 1
        b1, b2 = ADAM_B1, ADAM_B2
        sb2 = b2 ** 0.5
        bc = _f32(np.float32(_bias(b2, count)) ** np.float32(0.5)
                  / np.float32(_bias(b1, count)))
        dlr = sc["estim_lr"] * sched * bc
        numerator_acum = _vdot(gs, [
            self.state[p]["grad_sum"]
            / (torch.sqrt(self.state[p]["exp_avg_sq"]) + EPS)
            for p in ps])
        for p, g in zip(ps, gs):
            st = self.state[p]
            st["exp_avg"] = b1 * st["exp_avg"] + (1 - b1) * dlr * g
            st["exp_avg_sq"] = b2 * st["exp_avg_sq"] + (1 - b2) * g * g
            st["grad_sum"] = sb2 * st["grad_sum"] + (1 - sb2) * dlr * g
        grad_sum_l1 = _abs_sum(self.state[p]["grad_sum"] for p in ps)
        nw = sb2 * sc["numerator_weighted"] + (1 - sb2) * dlr * numerator_acum
        d_estimate = nw / ((1 - sb2) * grad_sum_l1)
        for p in ps:
            st = self.state[p]
            p.add_(-st["exp_avg"] / (torch.sqrt(st["exp_avg_sq"]) + EPS))
        sc.update(estim_lr=torch.maximum(sc["estim_lr"], d_estimate),
                  numerator_weighted=nw, count=count)


class ScheduleFreeAdamW(_TreeOptimizer):
    """optax.contrib.schedule_free_adamw (0.2.6) without warmup: the base
    step is RMS-scaled (b2, eps outside the root, bias-corrected), decayed
    by ``wd * y`` and scaled by ``-lr``; it moves the sequence ``z``, the
    average ``x`` takes ``z`` at weight ``max_lr**2 / sum``, and the
    parameters are the evaluation point ``y = b1 x + (1 - b1) z``."""

    def __init__(self, params, lr: float, b1: float, weight_decay: float):
        super().__init__(params, dict(lr=lr))
        self.b1, self.wd = b1, weight_decay

    @torch.no_grad()
    def step(self, closure=None):
        ps, gs = self._params(), self._grads()
        lr = self.param_groups[0]["lr"]
        sc = self._scalars()
        if "weight_sum" not in sc:
            sc["weight_sum"] = torch.zeros((), dtype=torch.float32,
                                           device=ps[0].device)
            sc["max_lr"] = torch.zeros_like(sc["weight_sum"])
            for p in ps:
                self.state[p].update(z=p.clone(), nu=torch.zeros_like(p))
        count = sc.get("count", 0) + 1
        b1, b2 = self.b1, ADAM_B2
        max_lr = torch.clamp(sc["max_lr"], min=lr)
        weight = max_lr ** 2.0
        total = sc["weight_sum"] + weight
        ck = torch.nan_to_num(weight / total, nan=0.0, posinf=math.inf)
        bc = _bias(b2, count)
        for p, g in zip(ps, gs):
            st = self.state[p]
            st["nu"] = (1 - b2) * g ** 2 + b2 * st["nu"]
            u = 1 / (torch.sqrt(st["nu"] / bc) + EPS) * g
            u = -lr * (u + self.wd * p)
            z_old = st["z"]
            z = z_old + u
            prev_x = (p - (1.0 - b1) * z_old) / b1
            x = (1.0 - ck) * prev_x + ck * z
            p.add_((b1 * x + (1.0 - b1) * z) - p)
            st["z"] = z
        sc.update(weight_sum=total, max_lr=max_lr, count=count)


class MomoAdam(_TreeOptimizer):
    """optax.contrib.momo_adam (0.2.6) at b1 0.9, b2 0.999, eps 1e-8,
    lower bound 0 and no decay: Adam whose step is the Polyak-type
    model-based step capped at ``lr / bc1``. Reads the loss:
    ``step(value=loss)``. optax's terms in the lower bound and the decay
    are 0 and 1 here, which leaves every float32 result as it is."""

    takes_value = True

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None, value: Optional[torch.Tensor] = None):
        if value is None:
            raise ValueError("You must pass the loss value to MoMo.")
        ps, gs = self._params(), self._grads()
        alpha = self.param_groups[0]["lr"]
        sc = self._scalars()
        if "barf" not in sc:
            sc["barf"] = torch.zeros((), dtype=torch.float32,
                                     device=ps[0].device)
            sc["gamma"] = torch.zeros_like(sc["barf"])
            for p in ps:
                self.state[p].update(exp_avg=torch.zeros_like(p),
                                     exp_avg_sq=torch.zeros_like(p))
        count = sc.get("count", 0) + 1
        b1, b2 = ADAM_B1, ADAM_B2
        value = torch.as_tensor(value, dtype=torch.float32,
                                device=ps[0].device)
        barf = b1 * sc["barf"] + (1 - b1) * value
        bc2, bc1 = _bias(b2, count), _bias(b1, count)
        exp_avg, precond = [], []
        for p, g in zip(ps, gs):
            st = self.state[p]
            st["exp_avg"] = b1 * st["exp_avg"] + (1 - b1) * g
            st["exp_avg_sq"] = b2 * st["exp_avg_sq"] + (1 - b2) * g * g
            exp_avg.append(st["exp_avg"])
            precond.append(EPS + torch.sqrt(st["exp_avg_sq"] / bc2))
        exp_avg_norm = _vdot(exp_avg, [ea / pc for ea, pc in
                                       zip(exp_avg, precond)])
        gamma = b1 * sc["gamma"] + (1 - b1) * _vdot(gs, ps)
        iprod = _vdot(exp_avg, ps)
        t1 = torch.clamp(barf - gamma + iprod, min=0.0) / exp_avg_norm
        t1 = torch.where(exp_avg_norm <= np.finfo(float).eps,
                         torch.zeros_like(t1), t1)
        tau = torch.clamp(t1, max=_f32(np.float32(alpha) / np.float32(bc1)))
        for p, ea, pc in zip(ps, exp_avg, precond):
            p.sub_(tau * ea / pc)
        sc.update(barf=barf, gamma=gamma, count=count)


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
    """``optax.chain(clip_by_global_norm(grad_clip), X(lr))`` over a torch
    optimizer X, where ``lr`` is a schedule of the update count or a
    constant. ``step(value=)`` applies one update from the parameters'
    ``.grad``; ``value`` (the loss) reaches the optimizers that read it
    (``MomoAdam``) and is ignored by the rest, as optax's
    ``with_extra_args_support``; ``count`` is optax's update count."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Union[float, Schedule], grad_clip: float):
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip = float(grad_clip)
        self.count = 0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, value: Optional[torch.Tensor] = None) -> None:
        groups = self.optimizer.param_groups
        if self.grad_clip > 0:
            clip_by_global_norm_([p.grad for g in groups for p in g["params"]
                                  if p.grad is not None], self.grad_clip)
        s = self.schedule
        lr = float(s(self.count)) if callable(s) else float(s)
        for group in groups:
            group["lr"] = lr
        if getattr(self.optimizer, "takes_value", False):
            self.optimizer.step(value=value)
        else:
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
    parameters), stepping ``total_steps`` times, with the learning rate
    the JAX package's ``build_optimizer`` gives it."""
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
    elif name == "muon":
        opt = Muon(params, lr0)
    elif name == "prodigy":
        sched = 1.0
        opt = Prodigy(params, cfg.weight_decay)
    elif name == "dadapt_adamw":
        sched = 1.0
        opt = DAdaptAdamW(params)
    elif name == "schedule_free_adamw":
        sched = cfg.lr
        opt = ScheduleFreeAdamW(params, cfg.lr, cfg.b1, cfg.weight_decay)
    elif name == "momo_adam":
        sched = cfg.lr
        opt = MomoAdam(params, cfg.lr)
    elif name == "sophia":
        raise ValueError(
            "obj_fn must be provided to hutchinson update function. (optax's "
            "sophia, which the JAX package builds, fails on its first update "
            "the same way: its train step passes only value=)")
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return ClippedOptimizer(opt, sched, cfg.grad_clip)
