"""The port's ``optax.contrib`` optimizers (muon, prodigy, dadapt_adamw,
schedule_free_adamw, momo_adam) against optax 0.2.6 through the JAX
package's ``build_optimizer``, on the CPU.

Tolerances:
  * 10 updates on a seeded gradient sequence (a fixed direction plus
    noise, so D-Adaptation's estimate grows; every third update's global
    norm well above the clip norm), clipping on and off, momo fed seeded
    loss values: params and the scalar state (D-Adaptation's estimate,
    Momo's averages, schedule-free's weights) rtol 1e-5, params atol 1e-7,
    D-Adaptation's numerator rtol 1e-4 (XLA's fused rounding, below),
    float32 (the port computes optax's float32 bias
    corrections, so no lr-sized slack is needed, as
    ``tests/test_torch_port_losses.py`` needs for ``torch.optim``'s);
  * exact resume: 5 updates, ``save_train_state``, a fresh optimizer
    loaded with ``load_train_state``, 5 more, against 10 straight:
    bit-equal;
  * sophia: optax's ``ValueError`` in both packages (JAX's at its first
    update, the port's when built);
  * ``train_inr`` with each optimizer through the train step, which hands
    the loss to momo_adam as ``value=``: finite, moving losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mri_raytracer_tpu.config import OptimConfig as JOptim
from mri_raytracer_tpu.train import optimizers as jopt
from mri_raytracer_tpu_torch.config import OptimConfig as TOptim
from mri_raytracer_tpu_torch.config import TrainConfig as TTrain
from mri_raytracer_tpu_torch.data import synthetic as tsyn
from mri_raytracer_tpu_torch.io import checkpoint as tckpt
from mri_raytracer_tpu_torch.train import engine as tengine
from mri_raytracer_tpu_torch.train import optimizers as topt

torch.set_num_threads(2)
CONTRIB = ("muon", "prodigy", "dadapt_adamw", "schedule_free_adamw",
           "momo_adam")
KEYS = [(layer, k) for layer in range(3) for k in ("W", "b")]


def _tree(seed=0):
    """A 3-layer MLP pytree: 2-D leaves wide, tall and square (Muon's
    orthogonalization transposes the tall one), 1-D biases (Muon's Adam)."""
    rng = np.random.default_rng(seed)
    shapes = [(5, 3), (3, 7), (7, 7)]
    return [{"W": rng.normal(0, 0.5, s).astype(np.float32),
             "b": rng.normal(0, 0.5, (s[1],)).astype(np.float32)}
            for s in shapes]


def _grads(rng, tree, i):
    """Update i's gradients: a direction fixed by the tree's seed plus
    noise, scaled up every third update."""
    direction = _tree(99)
    scale = 3.0 if i % 3 == 0 else 0.2
    return [{k: ((direction[l][k] + 0.3 * rng.normal(0, 1, v.shape)) * scale)
             .astype(np.float32) for k, v in layer.items()}
            for l, layer in enumerate(tree)]


def _cfg(name, clip):
    return dict(optimizer=name, lr=2e-3, weight_decay=0.01, grad_clip=clip,
                schedule="warmup_cosine", warmup_steps=3)


def _port(name, clip, tree, steps_n=10):
    leaves = [torch.nn.Parameter(torch.from_numpy(tree[l][k].copy()))
              for l, k in KEYS]
    return leaves, topt.build_optimizer(TOptim(**_cfg(name, clip)), steps_n,
                                        leaves)


def _feed(leaves, opt, g, value):
    for p, (l, k) in zip(leaves, KEYS):
        p.grad = torch.from_numpy(g[l][k].copy())
    opt.step(value=torch.tensor(value))


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("name", CONTRIB)
def test_contrib_optimizers_match_optax(name, clip):
    steps_n = 10
    tree = _tree()
    jo = jopt.build_optimizer(JOptim(**_cfg(name, clip)), steps_n)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jo.init(jp)
    leaves, to = _port(name, clip, tree, steps_n)
    rng = np.random.default_rng(7)
    for i in range(steps_n):
        g = _grads(rng, tree, i)
        value = np.float32(rng.uniform(0.5, 2.0))
        upd, state = jo.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                               jp, value=jnp.float32(value))
        jp = optax.apply_updates(jp, upd)
        _feed(leaves, to, g, value)
    assert to.count == steps_n
    moved = 0.0
    for p, (l, k) in zip(leaves, KEYS):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[l][k]),
                                   rtol=1e-5, atol=1e-7, err_msg=f"{l}.{k}")
        moved = max(moved, float(np.abs(np.asarray(jp[l][k])
                                        - tree[l][k]).max()))
    assert moved > 5e-6  # the comparison is not of unmoved params
    scalars = {jax.tree_util.keystr(k).rsplit(".", 1)[-1]: float(v)
               for k, v in jax.tree_util.tree_flatten_with_path(state)[0]
               if np.ndim(v) == 0}
    mine = {k: float(v) for k, v in to.optimizer._scalars().items()
            if k != "count" and np.ndim(v) == 0}
    assert set(mine) <= set(scalars), (mine, scalars)
    for k, v in mine.items():
        # D-Adaptation's numerator parts from optax's by up to 1.8e-5
        # (measured, dadapt_adamw with clipping): the port rounds after
        # each float32 operation, XLA's fused program need not; the
        # estimate d drawn from it agrees to 1e-5.
        np.testing.assert_allclose(
            v, scalars[k], rtol=1e-4 if k == "numerator_weighted" else 1e-5,
            err_msg=k)
    if name in ("prodigy", "dadapt_adamw"):
        assert mine["estim_lr"] > 3e-6  # the estimate grew from 1e-6


@pytest.mark.parametrize("name", CONTRIB)
def test_contrib_optimizers_resume_exactly(name, tmp_path):
    tree = _tree(1)
    rng = np.random.default_rng(3)
    seq = [(_grads(rng, tree, i), np.float32(rng.uniform(0.5, 2.0)))
           for i in range(10)]
    straight, so = _port(name, 1.0, tree)
    for g, v in seq:
        _feed(straight, so, g, v)
    first, fo = _port(name, 1.0, tree)
    for g, v in seq[:5]:
        _feed(first, fo, g, v)
    gen = torch.Generator().manual_seed(0)
    path = tmp_path / "state.npz"
    params = torch.nn.ParameterList(first)
    tckpt.save_train_state(path, params, fo, gen, 5)
    st = tckpt.load_train_state(path)
    resumed = [torch.nn.Parameter(torch.zeros_like(p)) for p in first]
    ro = topt.build_optimizer(TOptim(**_cfg(name, 1.0)), 10, resumed)
    with torch.no_grad():
        for p, v in zip(resumed, tckpt.params_to_numpy(params)):
            p.copy_(torch.from_numpy(v))
    ro.load_state_dict(st["opt_state"])
    assert ro.count == 5 and st["step"] == 5
    for g, v in seq[5:]:
        _feed(resumed, ro, g, v)
    for a, b in zip(resumed, straight):
        assert torch.equal(a, b)


def test_sophia_raises_value_error_in_both_packages():
    jo = jopt.build_optimizer(JOptim(optimizer="sophia"), 10)
    jp = [{"W": jnp.ones((4, 3)), "b": jnp.zeros(3)}]
    with pytest.raises(ValueError, match="obj_fn must be provided"):
        jo.update(jp, jo.init(jp), jp, value=jnp.float32(1.0))
    with pytest.raises(ValueError, match="obj_fn must be provided"):
        topt.build_optimizer(TOptim(optimizer="sophia"), 10,
                             [torch.nn.Parameter(torch.zeros(2))])


def test_schedules_reach_only_the_scheduled_optimizers():
    """muon takes the warmup-cosine schedule; prodigy and dadapt_adamw a
    constant 1.0; schedule_free_adamw and momo_adam a constant lr."""
    want = {"muon": None, "prodigy": 1.0, "dadapt_adamw": 1.0,
            "schedule_free_adamw": 2e-3, "momo_adam": 2e-3}
    for name, lr in want.items():
        leaves, opt = _port(name, 1.0, _tree())
        seen = []
        for i in range(4):
            _feed(leaves, opt, _grads(np.random.default_rng(i), _tree(), i),
                  1.0)
            seen.append(opt.optimizer.param_groups[0]["lr"])
        if lr is None:
            assert seen == [opt.schedule(i) for i in range(4)]
            assert len(set(seen)) == 4
        else:
            assert seen == [lr] * 4


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats_port_optim")
    tsyn.write_synthetic_dataset(root, num_cases=3, shape=(16, 16, 12),
                                 seed=3)
    return root


@pytest.mark.parametrize("name", CONTRIB)
def test_train_inr_with_contrib_optimizers(dataset, tmp_path, name):
    c = TTrain()
    c.data.data_root = str(dataset)
    c.data.case_limit = 3
    c.data.num_folds = 3
    c.data.pool_size = 2
    c.data.pool_refresh = 0
    c.model.hidden_dims = (16, 16)
    c.model.fourier_freqs = 2
    c.train_steps = 8
    c.global_batch = 256
    c.micro_batch = 128
    c.log_every = 4
    c.eval_every = 0
    c.checkpoint_every = 0
    c.out_dir = str(tmp_path)
    c.optim.optimizer = name
    state = tengine.train_inr(c, device="cpu")
    losses = [h["loss"] for h in state["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] != losses[0]
