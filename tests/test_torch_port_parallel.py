"""The port's rank mesh and data-parallel training (``parallel/mesh.py``,
``parallel/training.py``, ``build_train_step(grad_psum_axis=)``,
``train_inr(data_parallel=2)``) against the JAX package, on the CPU.

The port's side runs in 4 gloo ranks spawned once for the module
(``tests/torch_parallel_worker.py``, suite ``train``); the JAX side runs
here on the root conftest's 8 virtual CPU devices, as
``tests/test_parallel.py`` does. Tolerances:
  * the DP step on a 2 x 2 mesh, 5 steps of 2 micro-batches a rank, both
    packages from the same weights and fed the same batches: metrics and
    params atol 1e-5, the bar of ``tests/test_torch_port_training.py``'s
    step (float32 in another library, then Adam's ratio of moments);
  * the same DP run against one rank with 4 micro-batches on the same
    batches: atol 1e-6 (only the order of the gradient sums differs);
  * the stripe render over 'space' of the same mesh: atol 2e-3, JAX's bar
    (``tests/test_parallel.py``: the stripe's shifted b0 can flip a bf16
    rounding);
  * ``grad_psum_axis`` on a 1 x 1 mesh and the world-1 DP step: equal to
    the plain step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.config import LossConfig as JLoss, \
    ModelConfig as JModel, OptimConfig as JOptim
from mri_raytracer_tpu.data import brats as jbrats, sampling as jsamp, \
    synthetic as jsyn
from mri_raytracer_tpu.models.api import build_model as jbuild
from mri_raytracer_tpu.parallel import mesh as jmesh, render as jrender, \
    training as jtrain
from mri_raytracer_tpu.render import params as jrp
from mri_raytracer_tpu.render.camera import OrbitalCamera as JCam
from mri_raytracer_tpu.train import optimizers as jopt
from mri_raytracer_tpu_torch import convert
from mri_raytracer_tpu_torch.config import LossConfig as TLoss, \
    ModelConfig as TModel, OptimConfig as TOptim, TrainConfig
from mri_raytracer_tpu_torch.data import sampling as tsamp, \
    synthetic as tsyn
from mri_raytracer_tpu_torch.io import checkpoint as tckpt
from mri_raytracer_tpu_torch.ops import shearwarp as tsw
from mri_raytracer_tpu_torch.parallel import mesh as tmesh, \
    training as ttrain
from mri_raytracer_tpu_torch.render import params as trp
from mri_raytracer_tpu_torch.render.camera import OrbitalCamera as TCam
from mri_raytracer_tpu_torch.train import engine as tengine, \
    optimizers as topt, steps as tsteps
from torch_parallel_worker import Ranks, obj

torch.set_num_threads(2)
STEPS, DP, ACCUM, B = 5, 2, 2, 96
MODEL = dict(hidden_dims=(16, 16), fourier_freqs=2)
OPTIM = dict(lr=5e-3, warmup_steps=3)
SHAPE = (16, 16, 12)
POSE = (0.5, 1.1)  # tests/test_parallel.py's combined-mesh render
RUN = "dp_run"


def _batches():
    rng = np.random.default_rng(0)
    n = STEPS * DP * ACCUM
    return (rng.uniform(-1, 1, (n, B, 3)).astype(np.float32),
            rng.normal(0, 1, (n, B, 4)).astype(np.float32),
            rng.integers(0, 4, (n, B)).astype(np.int32),
            rng.uniform(0.5, 1.5, (n, B)).astype(np.float32))


def _tree():
    jm = jbuild(JModel(**MODEL), 4)
    return jm, jax.tree_util.tree_map(np.asarray,
                                      jm.init(jax.random.PRNGKey(1)))


def _display(shape, seed):
    mods, seg = jsyn.synthetic_case(shape, seed=seed)
    return (np.stack([jbrats.percentile_normalize(m) for m in mods]),
            seg.astype(np.int32))


def _train_config(data, out):
    """tests/test_parallel.py's DP run at data_parallel=2, with periodic
    checkpoints so that every kind of file is written."""
    c = TrainConfig()
    c.data.data_root = str(data)
    c.data.case_limit = 3
    c.data.num_folds = 3
    c.data.pool_size = 2
    c.data.pool_refresh = 0
    c.model.hidden_dims = (16, 16)
    c.model.fourier_freqs = 2
    c.train_steps = 8
    c.global_batch = 512
    c.micro_batch = 64
    c.checkpoint_every = 4
    c.log_every = 2
    c.out_dir = str(out)
    c.run_name = RUN
    c.data_parallel = 2
    return c


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_parallel_train")
    data = tsyn.write_synthetic_dataset(tmp / "data", num_cases=3,
                                        shape=SHAPE, seed=5)
    coords, intens, labels, weights = _batches()
    mods, seg = _display(SHAPE, 2)
    inputs = {
        "dp_shape": np.array([STEPS, DP, ACCUM]),
        "dp_tree": obj(_tree()[1]),
        "dp_model": obj(MODEL),
        "dp_optim": obj(OPTIM),
        "dp_coords": coords, "dp_intens": intens, "dp_labels": labels,
        "dp_weights": weights,
        "combined/mods": mods, "combined/seg": seg,
        "combined/pose": np.array([*POSE, 64, 64]),
        "tr_config": obj(_train_config(data, tmp / RUN).to_dict()),
    }
    r = Ranks("train", tmp, inputs)
    r.out_dir = tmp / RUN
    yield r
    r.close()


@pytest.mark.parametrize("tag,shape", [("m22", (2, 2)), ("m14", (1, 4))])
def test_mesh_axes_groups_and_collectives(ranks, tag, shape):
    """Rank r sits at (r // space, r % space), as JAX's mesh places
    devices[r]; each axis's group sums and gathers over its ranks."""
    nd, ns = shape
    m = jmesh.make_mesh(nd, ns)
    assert m.shape == {"data": nd, "space": ns}
    devs = np.asarray([d.id for d in m.devices.flat]).reshape(nd, ns)
    for r, out in enumerate(ranks.result()):
        d, s = divmod(r, ns)
        assert devs[d, s] == jax.devices()[r].id
        np.testing.assert_array_equal(out[f"{tag}/data"], [d, nd])
        np.testing.assert_array_equal(out[f"{tag}/space"], [s, ns])
        col = [dd * ns + s for dd in range(nd)]
        row = [d * ns + ss for ss in range(ns)]
        np.testing.assert_array_equal(out[f"{tag}/data_gather"], col)
        np.testing.assert_array_equal(out[f"{tag}/space_gather"], row)
        assert out[f"{tag}/data_sum"] == [sum(col)]
        assert out[f"{tag}/space_sum"] == [sum(row)]


def test_mesh_too_big_raises_and_placements(ranks):
    with pytest.raises(ValueError, match="mesh 16x1 needs 16 devices, "
                                         "have 8"):
        jmesh.make_mesh(data=16, space=1)
    x = np.arange(32).reshape(4, 8)
    for r, out in enumerate(ranks.result()):
        assert str(out["too_big"]) == "mesh 4x2 needs 8 devices, have 4"
        np.testing.assert_array_equal(out["local/data0"],
                                      x[2 * (r // 2):2 * (r // 2) + 2])
        np.testing.assert_array_equal(out["local/space1"],
                                      x[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["local/replicated"], x)


def test_one_process_mesh_is_the_identity():
    """Without a process group the only mesh is 1 x 1, and its collectives
    give back their input."""
    m = tmesh.make_mesh(1, 1)
    ax = m.axis("data")
    assert (ax.index, ax.size, ax.group) == (0, 1, None)
    t = torch.arange(3.0)
    assert ax.all_reduce_sum(t) is t
    assert ax.all_gather(t) == [t]
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        tmesh.make_mesh(2, 1)
    assert tmesh.rendezvous_url("node7:29500") == "tcp://node7:29500"
    assert tmesh.rendezvous_url("/x/store").startswith("file:///x/store")
    tmesh.initialize_distributed(None, 1, 0)  # a no-op, as in JAX
    assert not torch.distributed.is_initialized()


def test_entry_points_need_a_card(monkeypatch):
    """The renderers and the bring-up run on the card unless given the
    CPU; none falls back."""
    from mri_raytracer_tpu_torch.parallel import render as trender

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = tmesh.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trender.build_sharded_renderer(m, SHAPE, 8, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trender.build_volume_sharded_renderer(m, SHAPE, 8, 8, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.initialize_distributed("localhost:1", 2, 0)
    assert not torch.distributed.is_initialized()


def _jax_dp_run():
    """JAX's ``build_dp_train_step`` on a 2 x 2 mesh: the sampler picks the
    batch whose precomputed key it is handed (fold_in(step key, shard),
    then split(accum), then the sampling key of split(k, 3))."""
    jm, tree = _tree()
    coords, intens, labels, weights = (jnp.asarray(a) for a in _batches())
    step_keys = [jax.random.PRNGKey(100 + s) for s in range(STEPS)]
    table = jnp.stack([jax.random.split(k, 3)[0] for sk in step_keys
                       for d in range(DP)
                       for k in jax.random.split(jax.random.fold_in(sk, d),
                                                 ACCUM)])

    def jsampler(key, mods, segs, params=None, boundary=None):
        i = jnp.argmax(jnp.all(table == key[None, :], axis=1))
        return jsamp.SampleBatch(coords[i], intens[i], labels[i], weights[i])

    jo = jopt.build_optimizer(JOptim(**OPTIM), STEPS)
    step = jtrain.build_dp_train_step(jm, JLoss(), jo, jsampler, ACCUM, DP,
                                      mesh=jmesh.make_mesh(DP, 2))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jo.init(jp)
    metrics = []
    for s in range(STEPS):
        jp, state, m = step(jp, state, step_keys[s],
                            jnp.zeros((1, 4, 2, 2, 2)),
                            jnp.zeros((1, 2, 2, 2), jnp.int32),
                            jnp.int32(s + 1))
        metrics.append(m)
    return tree, jp, metrics


def test_dp_step_matches_jax(ranks):
    tree, jp, metrics = _jax_dp_run()
    out = ranks.result()[0]
    for s, mj in enumerate(metrics):
        for f in mj._fields:
            np.testing.assert_allclose(out[f"dp/{s}/{f}"],
                                       np.asarray(getattr(mj, f)), rtol=0,
                                       atol=1e-5, err_msg=f"step {s} {f}")
    got = jax.tree_util.tree_leaves(out["dp/params"][()])
    for a, b in zip(got, jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    # The weights moved: the comparison is not of two untouched copies.
    assert max(float(np.abs(a - b).max()) for a, b in zip(
        got, jax.tree_util.tree_leaves(tree))) > 1e-3


def test_dp_ranks_stay_replicated(ranks):
    """Every rank of both data groups holds the same weights and metrics
    after the steps."""
    outs = ranks.result()
    leaves = [jax.tree_util.tree_leaves(o["dp/params"][()]) for o in outs]
    for other, out in zip(leaves[1:], outs[1:]):
        for a, b in zip(other, leaves[0]):
            np.testing.assert_array_equal(a, b)
        for s in range(STEPS):
            np.testing.assert_array_equal(out[f"dp/{s}/loss"],
                                          outs[0][f"dp/{s}/loss"])


def _plain_steps(accum, sampler_fn, tree, grad_psum_axis=None):
    tm, tp = convert.inr_params_from_numpy(tree, TModel(**MODEL))
    to = topt.build_optimizer(TOptim(**OPTIM), STEPS, tp)
    step = tsteps.build_train_step(tm, TLoss(), to, sampler_fn, accum,
                                   grad_psum_axis=grad_psum_axis)
    g = torch.Generator().manual_seed(0)
    ms = [step(tp, to, g, torch.zeros((1, 4, 2, 2, 2)),
               torch.zeros((1, 2, 2, 2), dtype=torch.int32), s + 1)
          for s in range(STEPS)]
    return tckpt.params_to_numpy(tp), ms


def _table_sampler():
    drawn = iter(range(STEPS * DP * ACCUM))
    table = _batches()

    def sampler(g, mods, segs, params=None, boundary=None):
        i = next(drawn)
        return tsamp.SampleBatch(*(torch.from_numpy(a[i]) for a in table))

    return sampler


def test_dp_matches_one_rank_with_the_batches_of_both(ranks):
    """2 ranks of ACCUM micro-batches = one rank of 2 * ACCUM on the same
    batches (one rank's step s takes batches (s, d, a) in that order)."""
    params, ms = _plain_steps(DP * ACCUM, _table_sampler(), _tree()[1])
    out = ranks.result()[0]
    for s, m in enumerate(ms):
        for f in m._fields:
            np.testing.assert_allclose(out[f"dp/{s}/{f}"],
                                       getattr(m, f).numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"step {s} {f}")
    for a, b in zip(jax.tree_util.tree_leaves(out["dp/params"][()]),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_grad_psum_on_one_rank_equals_the_plain_step():
    """On a 1 x 1 mesh (no process group) the averaged step and the world-1
    DP step are the plain step."""
    tree = _tree()[1]
    plain, m0 = _plain_steps(ACCUM, _table_sampler(), tree)
    axis = tmesh.make_mesh(1, 1).axis("data")
    psum, m1 = _plain_steps(ACCUM, _table_sampler(), tree, axis)
    for a, b in zip(jax.tree_util.tree_leaves(psum),
                    jax.tree_util.tree_leaves(plain)):
        np.testing.assert_array_equal(a, b)
    for x, y in zip(m0, m1):
        for f in x._fields:
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    # The world-1 DP step, its rank generator seeded from the key as the
    # plain step's is here.
    tm, tp = convert.inr_params_from_numpy(tree, TModel(**MODEL))
    to = topt.build_optimizer(TOptim(**OPTIM), STEPS, tp)
    seen = []

    def sampler(g, mods, segs, params=None, boundary=None):
        seen.append(g.initial_seed())
        return _table_sampler()(g, mods, segs)

    dp = ttrain.build_dp_train_step(tm, TLoss(), to, sampler, 1, 1)
    key = torch.Generator().manual_seed(7)
    dp(tp, to, key, torch.zeros((1, 4, 2, 2, 2)),
       torch.zeros((1, 2, 2, 2), dtype=torch.int32), 1)
    ref = torch.Generator().manual_seed(7)
    assert seen == [ttrain.shard_seed(ref, 0)]


def test_fold_in_decorrelates_ranks():
    seeds = {ttrain.fold_in(s, i) for s in range(64) for i in range(8)}
    assert len(seeds) == 64 * 8
    assert all(0 <= s < 2 ** 63 for s in seeds)
    g0 = torch.Generator().manual_seed(0)
    g1 = torch.Generator().manual_seed(0)
    assert ttrain.shard_seed(g0, 0) == ttrain.shard_seed(g1, 0)
    assert ttrain.shard_seed(g0, 0) != ttrain.shard_seed(g1, 1)


def test_combined_mesh_stripe_render_matches_jax(ranks):
    """tests/test_parallel.py's combined mesh: the stripe render over
    'space' of the 2 x 2 mesh that also ran the DP step."""
    mods, seg = _display(SHAPE, 2)
    p = jrp.default_render_params(SHAPE, show_seg=True)
    cam = JCam(radius=jrp.default_camera_radius(p, SHAPE), theta=POSE[0],
               phi=POSE[1])
    render = jrender.build_sharded_renderer(jmesh.make_mesh(2, 2), SHAPE,
                                            64, 64, out_res=64, has_seg=True)
    want = np.asarray(render(jnp.asarray(mods), jnp.asarray(seg), None,
                             cam.basis(), p))
    pt = trp.default_render_params(SHAPE, show_seg=True)
    camt = TCam(radius=trp.default_camera_radius(pt, SHAPE), theta=POSE[0],
                phi=POSE[1])
    single = tsw.render_brats(mods, seg, None, camt.basis(), pt, 64, 64,
                              out_res=64, device="cpu").numpy()
    outs = ranks.result()
    np.testing.assert_allclose(outs[0]["combined/img"], want, atol=2e-3)
    np.testing.assert_allclose(outs[0]["combined/img"], single, atol=2e-3)
    for out in outs[1:]:
        np.testing.assert_array_equal(out["combined/img"],
                                      outs[0]["combined/img"])


def test_train_inr_data_parallel_trains_on_two_ranks(ranks):
    """train_inr(data_parallel=2) under a 2-rank group: it learns, both
    ranks end with the same weights, and one set of files is written."""
    outs = ranks.result()
    for out in outs:
        assert "needs an initialized process group of 2 ranks" in \
            str(out["tr/refused"]) and "have 4" in str(out["tr/refused"])
    loss = outs[0]["tr/loss"]
    assert np.isfinite(loss).all() and loss[-1] < loss[0], loss
    np.testing.assert_array_equal(outs[1]["tr/loss"], loss)
    for a, b in zip(outs[1]["tr/params"][()], outs[0]["tr/params"][()]):
        np.testing.assert_array_equal(a, b)
    assert "tr/loss" not in outs[2] and "tr/loss" not in outs[3]
    d = ranks.out_dir
    for name in (f"{RUN}.npz", f"{RUN}_step000004.npz",
                 f"{RUN}_step000008.npz", f"{RUN}_trainstate.npz",
                 "splits/train.txt", "splits/val.txt",
                 "training_config_and_results.json"):
        assert (d / name).exists(), name
    recs = [json.loads(line) for line in
            (d / f"{RUN}_scalars.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in recs if "train/loss" in r]
    assert steps == [1, 2, 4, 6, 8], steps  # each logged once


def test_train_inr_data_parallel_needs_a_group(tmp_path):
    """One process cannot train data_parallel=2: one process a device."""
    c = TrainConfig()
    c.data_parallel = 2
    c.out_dir = str(tmp_path / "none")
    with pytest.raises(ValueError, match="data_parallel=2 needs an "
                                         "initialized process group of 2 "
                                         "ranks, one a device; have 1"):
        tengine.train_inr(c, device="cpu")
    assert not (tmp_path / "none").exists()
