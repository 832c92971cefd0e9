"""The port's configs, losses, schedules and optimizers against the JAX
package, on the CPU.

Both sides get the same numpy inputs. Tolerances:
  * the config tree: equal (``to_dict`` of the defaults and of a CLI);
  * every loss term, ``segmentation_loss`` with its aux, and the gradient
    of its total with respect to the logits (``jax.grad`` against
    ``backward()``): atol 1e-6 (float32 softmax, logs and sums in another
    library);
  * the schedules at every count 0..100 against optax: rtol 1e-6 (optax
    evaluates in float32, the port in float64);
  * adamw / adam / sgd / lion behind the global-norm clip, 20 updates on a
    seeded gradient sequence, some above the clip norm, at the config's
    default lr 2e-3: params atol 1e-6. optax computes Adam's bias
    corrections ``1 - b**t`` in float32 (1.3e-5 relative error at
    b2 = 0.999, t = 1), torch in float64, so the params part by about
    lr * 4e-5 over 20 updates (2.1e-6 at lr 0.05).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mri_raytracer_tpu import losses as jl
from mri_raytracer_tpu.config import (LossConfig as JLoss,
                                      OptimConfig as JOptim,
                                      RenderConfig as JRender,
                                      TrainConfig as JTrain)
from mri_raytracer_tpu.train import optimizers as jopt, steps as jsteps
from mri_raytracer_tpu_torch import losses as tl
from mri_raytracer_tpu_torch.config import (LossConfig as TLoss,
                                            OptimConfig as TOptim,
                                            RenderConfig as TRender,
                                            TrainConfig as TTrain)
from mri_raytracer_tpu_torch.train import optimizers as topt, \
    steps as tsteps

torch.set_num_threads(2)
ATOL = 1e-6

CLI = ["--data-root", "/data/x", "--case-limit", "7", "--num-folds", "3",
       "--sampler", "hybrid", "--min-subclass-samples", "4,5,6",
       "--model", "coord_injection", "--hidden", "32,16", "--dropout", "0.1",
       "--optimizer", "lion", "--lr", "0.01", "--schedule", "two_stage",
       "--per-class-dice", "--focal-gamma", "2", "--tv-weight", "0.2",
       "--steps", "33", "--global-batch", "512", "--micro-batch", "128",
       "--out", "o", "--run-name", "r", "--wandb", "--data-parallel", "2"]


def test_config_tree_matches_jax():
    assert TTrain().to_dict() == JTrain().to_dict()
    assert TTrain.from_cli(CLI).to_dict() == JTrain.from_cli(CLI).to_dict()
    assert TTrain.from_cli([]).to_dict() == JTrain().to_dict()
    upd = {"LR": 0.5, "HIDDEN_DIMS": [8, 8], "sampler": "tumor",
           "model": {"kind": "siren"}, "train_steps": 9}
    assert TTrain.from_dict(upd).to_dict() == JTrain.from_dict(upd).to_dict()
    assert vars(TRender()) == vars(JRender())
    with pytest.raises(ValueError, match="3 ints"):
        TTrain.from_cli(["--min-subclass-samples", "1,2"])


def _logits_labels(n=96, c=4, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2.0, (n, c)).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    return logits, labels


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=atol)


def test_loss_terms_match_jax():
    logits, labels = _logits_labels()
    lt, lj = torch.from_numpy(logits), jnp.asarray(logits)
    yt = tl.one_hot(torch.from_numpy(labels), 4)
    yj = jl.one_hot(jnp.asarray(labels), 4)
    _close(yt, yj, 0)
    pt, pj = torch.softmax(lt, -1), jax.nn.softmax(lj, -1)
    w = np.random.default_rng(1).uniform(0.2, 2.0, 96).astype(np.float32)
    alpha = np.array([0.1, 0.3, 0.3, 0.3], np.float32)
    _close(tl.soft_dice_per_class(pt, yt), jl.soft_dice_per_class(pj, yj))
    for per_class in (False, True):
        _close(tl.soft_dice_loss(pt, yt, per_class=per_class),
               jl.soft_dice_loss(pj, yj, per_class=per_class))
    _close(tl.weighted_ce(lt, yt), jl.weighted_ce(lj, yj))
    _close(tl.weighted_ce(lt, yt, torch.from_numpy(w)),
           jl.weighted_ce(lj, yj, jnp.asarray(w)))
    _close(tl.focal_ce(lt, yt, 2.0), jl.focal_ce(lj, yj, 2.0))
    _close(tl.focal_ce(lt, yt, 1.5, torch.from_numpy(alpha)),
           jl.focal_ce(lj, yj, 1.5, jnp.asarray(alpha)))
    _close(tl.label_smooth(yt, 0.1), jl.label_smooth(yj, 0.1))
    gt2 = (labels == 2).astype(np.float32)
    _close(tl.tversky_index(pt[:, 2], torch.from_numpy(gt2), 0.8, 0.2),
           jl.tversky_index(pj[:, 2], jnp.asarray(gt2), 0.8, 0.2))
    _close(tl.unified_focal_loss(lt, yt), jl.unified_focal_loss(lj, yj))
    _close(tl.unified_focal_loss(lt, yt, 0.3, 0.7, 0.4),
           jl.unified_focal_loss(lj, yj, 0.3, 0.7, 0.4))
    sl = np.random.default_rng(2).random((6, 5, 4)).astype(np.float32)
    _close(tl.tv_loss_slice(torch.from_numpy(sl)),
           jl.tv_loss_slice(jnp.asarray(sl)))
    # Frequency dropout: the draw is the generator's; rate 0 keeps x, rate
    # 1 zeroes exactly the feature columns, as in JAX.
    x = np.random.default_rng(3).random((10, 3 + 12 + 4)).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    xt = torch.from_numpy(x)
    assert tl.freq_dropout_mask(g, xt, 3, 12, 0.0) is xt
    _close(tl.freq_dropout_mask(g, xt, 3, 12, 1.0),
           jl.freq_dropout_mask(jax.random.PRNGKey(0), jnp.asarray(x), 3, 12,
                                1.0), 0)
    half = tl.freq_dropout_mask(g, xt, 3, 12, 0.5).numpy()
    kept = np.all(half == x, axis=0)
    np.testing.assert_array_equal(kept[:3], True)
    np.testing.assert_array_equal(kept[15:], True)
    assert np.all(kept[3:15] | np.all(half[:, 3:15] == 0, axis=0))


LOSS_VARIANTS = {
    "base": {},
    "focal": dict(focal_gamma=2.0),
    "focal_alpha": dict(focal_gamma=1.0, focal_alpha=(0.1, 0.3, 0.3, 0.3)),
    "smooth": dict(label_smoothing=0.1),
    "edema_fp": dict(edema_fp_weight=0.5),
    "tversky": dict(tversky_weight=0.5),
    "logit_reg": dict(edema_logit_reg=0.1),
    "unified": dict(unified_focal_weight=1.0),
    "per_class": dict(per_class_dice=True),
    "no_dice": dict(dice_weight=0.0, class_weights=(0.5, 2.0, 1.0, 3.0)),
    "weights": dict(boundary_weight=0.0),
    "boundary": dict(boundary_weight=2.0),
}


@pytest.mark.parametrize("name", sorted(LOSS_VARIANTS))
def test_segmentation_loss_and_grad_match_jax(name):
    kw = LOSS_VARIANTS[name]
    logits, labels = _logits_labels(seed=5)
    sw = (np.random.default_rng(6).uniform(0.05, 1.0, 96).astype(np.float32)
          if name in ("weights", "boundary") else None)
    jcfg, tcfg = JLoss(**kw), TLoss(**kw)

    def jfun(lg):
        return jl.segmentation_loss(lg, jnp.asarray(labels), jcfg, 4,
                                    None if sw is None else jnp.asarray(sw))

    (lj, auxj), gj = jax.value_and_grad(jfun, has_aux=True)(
        jnp.asarray(logits))
    lt_in = torch.from_numpy(logits).requires_grad_(True)
    lt, auxt = tl.segmentation_loss(lt_in, torch.from_numpy(labels), tcfg, 4,
                                    None if sw is None
                                    else torch.from_numpy(sw))
    lt.backward()
    _close(lt, lj)
    assert set(auxt) == set(auxj)
    for k in auxj:
        _close(auxt[k], auxj[k])
    _close(lt_in.grad, gj)


@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine", "cosine",
                                      "two_stage"])
@pytest.mark.parametrize("total,warmup", [(100, 100), (37, 5), (5, 0)])
def test_schedules_match_optax(schedule, total, warmup):
    kw = dict(schedule=schedule, lr=3e-3, warmup_steps=warmup,
              end_lr_scale=0.05)
    sj = jopt.build_schedule(JOptim(**kw), total)
    st = topt.build_schedule(TOptim(**kw), total)
    if not callable(sj):
        assert st == sj
        return
    for count in range(101):
        np.testing.assert_allclose(st(count), float(sj(count)), rtol=1e-6,
                                   atol=0, err_msg=f"count {count}")


def _param_tree(seed=0):
    rng = np.random.default_rng(seed)
    return [{"W": rng.normal(0, 0.5, (5, 3)).astype(np.float32),
             "b": rng.normal(0, 0.5, (3,)).astype(np.float32)},
            {"W": rng.normal(0, 0.5, (3, 2)).astype(np.float32),
             "b": rng.normal(0, 0.5, (2,)).astype(np.float32)}]


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd", "lion"])
def test_optimizers_match_optax(name):
    cfg = dict(optimizer=name, lr=2e-3, weight_decay=0.01, grad_clip=1.0,
               schedule="warmup_cosine", warmup_steps=3)
    steps_n = 20
    jo = jopt.build_optimizer(JOptim(**cfg), steps_n)
    tree = _param_tree()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jo.init(jp)
    leaves = [torch.nn.Parameter(torch.from_numpy(l[k].copy()))
              for l in tree for k in ("W", "b")]
    to = topt.build_optimizer(TOptim(**cfg), steps_n, leaves)
    rng = np.random.default_rng(7)
    above = 0
    for i in range(steps_n):
        # Every third update's global norm is well above the clip norm.
        scale = 3.0 if i % 3 == 0 else 0.2
        g = [{k: (rng.normal(0, 1, v.shape) * scale).astype(np.float32)
              for k, v in layer.items()} for layer in tree]
        above += np.sqrt(sum(float((v ** 2).sum()) for l in g
                             for v in l.values())) > 1.0
        upd, state = jo.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                               jp, value=jnp.float32(1.0))
        jp = optax.apply_updates(jp, upd)
        for p, gv in zip(leaves, [l[k] for l in g for k in ("W", "b")]):
            p.grad = torch.from_numpy(gv.copy())
        to.step()
    assert above >= 6 and to.count == steps_n
    for p, (l, k) in zip(leaves, [(l, k) for l in range(2)
                                  for k in ("W", "b")]):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[l][k]),
                                   rtol=0, atol=ATOL, err_msg=f"{l}.{k}")


def test_clip_matches_optax_and_stays_on_device():
    g = [np.full((4,), 2.0, np.float32), np.full((2, 2), -1.0, np.float32)]
    for max_norm in (0.5, 100.0):
        clip = optax.clip_by_global_norm(max_norm)
        want, _ = clip.update([jnp.asarray(x) for x in g], clip.init(None))
        got = [torch.from_numpy(x.copy()) for x in g]
        topt.clip_by_global_norm_(got, max_norm)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["muon", "prodigy", "dadapt_adamw",
                                  "schedule_free_adamw", "sophia",
                                  "momo_adam"])
def test_unported_optimizers_raise(name):
    """The six optax.contrib optimizers, which raised NotImplementedError
    until they were ported: five now build and step (their parity with
    optax is tests/test_torch_port_optim.py); sophia raises optax's
    ValueError, as JAX's train step meets it at its first update; an
    unknown name still raises."""
    p = [torch.nn.Parameter(torch.ones(3, 2)),
         torch.nn.Parameter(torch.zeros(2))]
    jopt.build_optimizer(JOptim(optimizer=name), 10)  # exists in JAX
    if name == "sophia":
        with pytest.raises(ValueError, match="obj_fn must be provided"):
            topt.build_optimizer(TOptim(optimizer=name), 10, p)
    else:
        opt = topt.build_optimizer(TOptim(optimizer=name), 10, p)
        for q in p:
            q.grad = torch.ones_like(q)
        opt.step(value=torch.tensor(1.0))
        assert opt.count == 1
        assert all(bool(torch.isfinite(q).all()) for q in p)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.build_optimizer(TOptim(optimizer="nope"), 10, p)


def test_coord_noise_schedule_matches_jax():
    sj = jsteps.make_coord_noise_schedule(0.3, 0.1, 100)
    st = tsteps.make_coord_noise_schedule(0.3, 0.1, 100)
    for i in (0, 1, 37, 100, 150):
        np.testing.assert_allclose(st(i), float(sj(jnp.int32(i))), rtol=1e-6)
    assert tsteps.make_coord_noise_schedule(0.0, 0.0, 100) is None
