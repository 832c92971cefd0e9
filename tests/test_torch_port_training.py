"""The port's training path (train step, ``train_inr``, checkpoints,
evaluation, logging, the CLI) against the JAX package, on the CPU, with
the 16 x 16 x 12 three-case synthetic dataset and ``_tiny_config`` of
``tests/test_training.py``.

Tolerances:
  * 10 steps of ``build_train_step`` with 2 accumulated micro-batches, both
    sides from the same converted weights and fed the same fixed batches:
    loss metrics and final params atol 1e-5 (float32 forward and backward
    in another library, then Adam's ratio of moments; optax rounds its bias
    corrections in float32, see tests/test_torch_port_losses.py);
  * a checkpoint the port wrote, loaded by JAX's ``model_load``: logits
    atol 1e-6 against the port's;
  * exact resume on the CPU: bit-equal;
  * ``predict_slice`` and ``evaluate_cases``: the generic float32 path
    (SIREN) equal labels and metrics; the separable bf16 bake (MLP) label
    mismatch < 5e-3, the JAX package's bar for the bake
    (tests/test_neural_march.py:248).
"""

import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.config import (LossConfig as JLoss,
                                      ModelConfig as JModel,
                                      OptimConfig as JOptim,
                                      TrainConfig as JTrain)
from mri_raytracer_tpu.data import sampling as jsamp
from mri_raytracer_tpu.eval import inference as jinf
from mri_raytracer_tpu.io import checkpoint as jckpt
from mri_raytracer_tpu.io.logging import RunLogger as JLogger
from mri_raytracer_tpu.models.api import build_model as jbuild
from mri_raytracer_tpu.train import engine as jengine, \
    optimizers as jopt, steps as jsteps
from mri_raytracer_tpu_torch import convert
from mri_raytracer_tpu_torch.apps import train_inr as tapp
from mri_raytracer_tpu_torch.config import (LossConfig as TLoss,
                                            ModelConfig as TModel,
                                            OptimConfig as TOptim,
                                            TrainConfig as TTrain)
from mri_raytracer_tpu_torch.data import sampling as tsamp, \
    synthetic as tsyn
from mri_raytracer_tpu_torch.eval import inference as tinf
from mri_raytracer_tpu_torch.io import checkpoint as tckpt
from mri_raytracer_tpu_torch.io.logging import RunLogger as TLogger
from mri_raytracer_tpu_torch.train import engine as tengine, \
    optimizers as topt, steps as tsteps

torch.set_num_threads(2)
SHAPE = (16, 16, 12)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats_port_train")
    tsyn.write_synthetic_dataset(root, num_cases=3, shape=SHAPE, seed=3)
    return root


def _tiny(cls, dataset, out, **kw):
    """tests/test_training.py's _tiny_config."""
    c = cls()
    c.data.data_root = str(dataset)
    c.data.case_limit = 3
    c.data.num_folds = 3
    c.data.fold_index = 0
    c.data.pool_size = 2
    c.data.pool_refresh = 0
    c.model.hidden_dims = (16, 16)
    c.model.fourier_freqs = 2
    c.train_steps = 12
    c.global_batch = 256
    c.micro_batch = 128
    c.checkpoint_every = 10
    c.log_every = 4
    c.out_dir = str(out)
    c.update(kw)
    return c


def _train(dataset, out, **kw):
    return tengine.train_inr(_tiny(TTrain, dataset, out, **kw), device="cpu")


def test_train_step_matches_jax():
    """10 steps, 2 micro-batches each, same weights and batches: the JAX
    sampler picks the batch whose precomputed key it is handed."""
    steps_n, accum, B = 10, 2, 96
    mcfg = dict(hidden_dims=(16, 16), fourier_freqs=2)
    jm = jbuild(JModel(**mcfg), 4)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tm, tp = convert.inr_params_from_numpy(tree, TModel(**mcfg))
    rng = np.random.default_rng(0)
    n = steps_n * accum
    coords = rng.uniform(-1, 1, (n, B, 3)).astype(np.float32)
    intens = rng.normal(0, 1, (n, B, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (n, B)).astype(np.int32)
    weights = rng.uniform(0.5, 1.5, (n, B)).astype(np.float32)
    step_keys = [jax.random.PRNGKey(100 + s) for s in range(steps_n)]
    table = jnp.stack([jax.random.split(k, 3)[0] for sk in step_keys
                       for k in jax.random.split(sk, accum)])

    def jsampler(key, mods, segs, params=None, boundary=None):
        i = jnp.argmax(jnp.all(table == key[None, :], axis=1))
        return jsamp.SampleBatch(jnp.asarray(coords)[i],
                                 jnp.asarray(intens)[i],
                                 jnp.asarray(labels)[i],
                                 jnp.asarray(weights)[i])

    drawn = iter(range(n))

    def tsampler(g, mods, segs, params=None, boundary=None):
        i = next(drawn)
        return tsamp.SampleBatch(*(torch.from_numpy(a[i]) for a in
                                   (coords, intens, labels, weights)))

    ocfg = dict(lr=5e-3, warmup_steps=3)
    jo = jopt.build_optimizer(JOptim(**ocfg), steps_n)
    jstep = jsteps.build_train_step(jm, JLoss(), jo, jsampler, accum)
    to = topt.build_optimizer(TOptim(**ocfg), steps_n, tp)
    tstep = tsteps.build_train_step(tm, TLoss(), to, tsampler, accum)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    state = jo.init(jp)
    dummy = np.zeros((1, 4, 2, 2, 2), np.float32)
    g = torch.Generator().manual_seed(0)
    for s in range(steps_n):
        jp, state, mj = jstep(jp, state, step_keys[s], jnp.asarray(dummy),
                              jnp.zeros((1, 2, 2, 2), jnp.int32),
                              jnp.int32(s + 1))
        mt = tstep(tp, to, g, torch.from_numpy(dummy),
                   torch.zeros((1, 2, 2, 2), dtype=torch.int32), s + 1)
        for f in mj._fields:
            np.testing.assert_allclose(getattr(mt, f).numpy(),
                                       np.asarray(getattr(mj, f)), rtol=0,
                                       atol=1e-5, err_msg=f"step {s} {f}")
    got = tckpt.params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    # The weights moved: the comparison is not of two untouched copies.
    assert max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(got),
        jax.tree_util.tree_leaves(tree))) > 1e-3


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    base = tmp_path_factory.mktemp("port_runs")
    jstate = jengine.train_inr(_tiny(JTrain, dataset, base / "jax"))
    tstate = _train(dataset, base / "port")
    return base, jstate, tstate


def test_train_inr_matches_jax_run(runs):
    base, jstate, tstate = runs
    hist = tstate["history"]
    assert [h["step"] for h in hist] == [h["step"] for h in
                                         jstate["history"]]
    assert hist[0]["loss"] > hist[-1]["loss"] * 0.5  # moving (JAX's rule)
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert sorted(os.listdir(base / "port")) == sorted(os.listdir(base /
                                                                  "jax"))
    assert set(tstate["eval"]) == set(jstate["eval"])
    assert tstate["checkpoint"] == str(base / "port" / "inr.npz")
    # The port's checkpoints load in the JAX package.
    params, cfg = jckpt.model_load(tstate["checkpoint"])
    assert cfg["FOURIER_FREQS"] == 2 and cfg["HIDDEN_DIMS"] == [16, 16]
    assert len(jckpt.load_params(base / "port" / "inr_flat.npz")) == 3
    jm = jbuild(JModel(hidden_dims=(16, 16), fourier_freqs=2), 4)
    rng = np.random.default_rng(4)
    c = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    f = rng.normal(0, 1, (200, 4)).astype(np.float32)
    want = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, params),
                               jnp.asarray(c), jnp.asarray(f)))
    with torch.no_grad():
        got = tstate["model"].apply(tstate["params"], torch.from_numpy(c),
                                    torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # Its scalar log has JAX's records.
    rec = [json.loads(l) for l in (base / "port" / "inr_scalars.jsonl")
           .read_text().splitlines()]
    jrec = [json.loads(l) for l in (base / "jax" / "inr_scalars.jsonl")
            .read_text().splitlines()]
    assert [sorted(r) for r in rec] == [sorted(r) for r in jrec]


def test_resume_from_jax_checkpoints(dataset, runs, tmp_path):
    """A JAX final checkpoint and a JAX train state (no generator state)
    both resume params only."""
    base, _, _ = runs
    for name in ("inr.npz", "inr_trainstate.npz"):
        with pytest.raises(KeyError, match="not a train-state"):
            tckpt.load_train_state(base / "jax" / name)
        s = _train(dataset, tmp_path / name, train_steps=3,
                   resume_from=str(base / "jax" / name))
        assert np.isfinite(s["history"][-1]["loss"])


def test_exact_train_state_resume_bit_equal(dataset, tmp_path):
    """N steps straight equal N/2 steps, a save, a load and N/2 more."""
    full = _train(dataset, tmp_path / "a", train_steps=8, checkpoint_every=4)
    _train(dataset, tmp_path / "b", train_steps=4, checkpoint_every=4)
    state = tckpt.load_train_state(tmp_path / "b" / "inr_trainstate.npz")
    assert state["step"] == 4 and state["rng_state"].dtype == torch.uint8
    assert state["opt_state"]["count"] == 4
    resumed = _train(dataset, tmp_path / "c", train_steps=8,
                     checkpoint_every=0,
                     resume_from=str(tmp_path / "b" / "inr_trainstate.npz"))
    assert [h["step"] for h in resumed["history"]] == [8]
    for a, b in zip(full["params"].parameters(),
                    resumed["params"].parameters()):
        assert torch.equal(a, b)
    assert resumed["history"][-1] == full["history"][-1]


def test_resume_shape_mismatch_raises(dataset, runs, tmp_path):
    _, _, tstate = runs
    with pytest.raises(ValueError, match="resume shape mismatch"):
        _train(dataset, tmp_path, hidden_dims=(8, 8),
               resume_from=tstate["checkpoint"])
    with pytest.raises(ValueError, match="resume mismatch"):
        _train(dataset, tmp_path, hidden_dims=(16,),
               resume_from=tstate["checkpoint"])


VARIANTS = {
    "tumor": dict(sampler="tumor"),
    "balanced": dict(sampler="balanced"),
    "hybrid": dict(sampler="hybrid", kind="coord_injection", dropout=0.2),
    "tv": dict(tv_weight=0.1),
    "boundary": dict(boundary_weight=2.0),
    "two_stage": dict(schedule="two_stage", coord_noise_sigma_start=0.3,
                      coord_noise_sigma_end=0.1),
    "siren": dict(kind="siren"),
    "coord_injection": dict(kind="coord_injection", dropout=0.1),
    "lion": dict(optimizer="lion"),
    "freq_dropout": dict(freq_dropout=0.2, per_class_dice=True),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variants_train(dataset, tmp_path, name):
    s = _train(dataset, tmp_path, train_steps=4, **VARIANTS[name])
    assert all(np.isfinite(h["loss"]) for h in s["history"])
    assert s["eval"] is not None and np.isfinite(s["eval"]["mean_dice"][0])


def test_periodic_eval_best_checkpoint_and_dashboard(dataset, tmp_path):
    s = _train(dataset, tmp_path, eval_every=6, live_dashboard=True)
    run = pathlib.Path(s["config"].out_dir)
    _, info = tckpt.model_load(run / "inr_best.npz",
                               config_override={"extra": 1})
    assert "val_mean_dice" in info and info["extra"] == 1
    assert (run / "inr_tables.jsonl").exists()
    assert list((run / "media").glob("val_slice_overlay_step*.png"))
    assert (run / "dashboard.png").exists()
    recs = [json.loads(l) for l in (run / "inr_scalars.jsonl")
            .read_text().splitlines()]
    assert any(k.startswith("val/dice_per_class/") for r in recs for k in r)
    lines = tckpt.inspect_npz(run / "inr_trainstate.npz")
    for key in ("params: <object>", "opt_state: <object>", "rng_state:",
                "step: shape=() dtype=int64"):
        assert any(l.startswith(key) for l in lines), key


def test_unsupported_options_raise(dataset, tmp_path):
    # data_parallel > 1 trains under a process group of that many ranks
    # (tests/test_torch_port_parallel.py); one process refuses it.
    with pytest.raises(ValueError, match="data_parallel=2 needs an "
                                         "initialized process group of 2"):
        _train(dataset, tmp_path, data_parallel=2)
    # muon trains since it was ported (tests/test_torch_port_optim.py);
    # sophia fails as JAX's does on its first step.
    with pytest.raises(ValueError, match="obj_fn must be provided"):
        _train(dataset, tmp_path, optimizer="sophia")


@pytest.mark.parametrize("kind", ["mlp", "siren"])
def test_predict_slice_and_evaluate_cases_match_jax(runs, kind):
    _, _, tstate = runs
    mcfg = dict(kind=kind, hidden_dims=(16, 16), fourier_freqs=2)
    jm = jbuild(JModel(**mcfg), 4)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    if kind == "mlp":  # several classes, as a trained field has
        tree[-1]["b"] = np.array([0.0, 0.4, 0.5, 0.45], np.float32)
    tm, tp = convert.inr_params_from_numpy(tree, TModel(**mcfg))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    cases = [tstate["val_cache"].get(0), tstate["train_cache"].get(1)]
    mods = cases[0]["mods"]
    for z in (0, 5, SHAPE[2] - 1):
        sj = jinf.predict_slice(jm, jp, jnp.asarray(mods), z)
        st = tinf.predict_slice(tm, tp, torch.from_numpy(mods), z)
        assert st.shape == SHAPE[:2]
        np.testing.assert_array_equal(st, np.asarray(sj))
    rj, aj = jinf.evaluate_cases(jm, jp, cases)
    rt, at = tinf.evaluate_cases(tm, tp, cases, device="cpu")
    assert set(at) == set(aj) and len(rt) == len(rj) == 2
    for a, b in zip(rt, rj):
        mismatch = np.mean(a["pred_vol"] != b["pred_vol"])
        np.testing.assert_array_equal(a["true_vol"], b["true_vol"])
        if kind == "siren":
            assert mismatch == 0
            assert a["class_scores"] == pytest.approx(b["class_scores"],
                                                      nan_ok=True)
            assert a["hausdorff_scores"] == pytest.approx(
                b["hausdorff_scores"], nan_ok=True)
        else:
            assert mismatch < 5e-3
            assert len(np.unique(a["pred_vol"])) >= 3
    if kind == "siren":
        for k in aj:
            np.testing.assert_allclose(at[k], aj[k], rtol=1e-12)


def test_run_logger_files_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((6, 8, 3)).astype(np.float32)

    def drive(cls, out):
        lg = cls(out, "r", {"a": 1, "b": [1, 2]})
        lg.log({"train/loss": np.float32(0.5), "x": 2}, 1)
        lg.log_bar("val/d", ["c0", "c1"], [0.1, 0.2], 3)
        lg.log_table("val/m", ["class", "dice"], [[0, 0.5], [1, None]], 3)
        lg.log_image("val/img", img, 3)
        lg.log_summary({"val": {"mean_dice": [0.4, 0.0]}})
        lg.save_best({"val": 1, "checkpoint": "x.npz"})
        lg.log_artifact("x.npz")
        lg.finish()

    drive(JLogger, tmp_path / "j")
    drive(TLogger, tmp_path / "t")
    files = sorted(str(p.relative_to(tmp_path / "t"))
                   for p in (tmp_path / "t").rglob("*"))
    assert files == sorted(str(p.relative_to(tmp_path / "j"))
                           for p in (tmp_path / "j").rglob("*"))
    for name in files:
        a, b = (tmp_path / "t" / name), (tmp_path / "j" / name)
        if a.is_dir():
            continue
        if name.endswith(".jsonl"):
            ra = [json.loads(l) for l in a.read_text().splitlines()]
            rb = [json.loads(l) for l in b.read_text().splitlines()]
            for r in ra + rb:
                r.pop("t", None)
            assert ra == rb, name
        elif name.endswith(".json"):
            ra, rb = json.loads(a.read_text()), json.loads(b.read_text())
            for r in (ra, rb):
                r.pop("started_at", None)
                r.pop("finished_at", None)
            assert ra == rb, name
        else:
            assert a.read_bytes() == b.read_bytes(), name


def test_cli_trains_on_the_cpu(dataset, tmp_path, capsys):
    rc = tapp.main(["--data-root", str(dataset), "--case-limit", "3",
                    "--num-folds", "3", "--pool-size", "2", "--hidden",
                    "8,8", "--fourier-freqs", "2", "--steps", "3",
                    "--global-batch", "128", "--micro-batch", "64",
                    "--checkpoint-every", "0", "--out", str(tmp_path),
                    "--run-name", "cli", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "final loss=" in out and "mean_dice" in out
    assert (tmp_path / "cli.npz").exists()


def test_metrics_match_jax():
    """The numpy metrics are copies (equal); the device ones torch
    counterparts: Dice equal, SSIM atol 1e-6 (float32 blur sums)."""
    from mri_raytracer_tpu.eval import metrics as jmet
    from mri_raytracer_tpu_torch.eval import metrics as tmet

    rng = np.random.default_rng(0)
    true = rng.integers(0, 4, (12, 10, 8))
    pred = np.where(rng.random(true.shape) < 0.8, true,
                    rng.integers(0, 3, true.shape))
    for fn in ("dice_score", "hausdorff_distance"):
        assert getattr(tmet, fn)(pred, true) == pytest.approx(
            getattr(jmet, fn)(pred, true), nan_ok=True)
    assert tmet.hausdorff_distance(pred, true, (1.0, 1.5, 2.0)) == \
        pytest.approx(jmet.hausdorff_distance(pred, true, (1.0, 1.5, 2.0)))
    assert tmet.coverage_dice(pred, true) == jmet.coverage_dice(pred, true)
    assert tmet.coverage_dice(pred * 0, true * 0) == 0.0
    assert tmet.macro_slice_dice(pred[..., 3], true[..., 3]) == \
        jmet.macro_slice_dice(pred[..., 3], true[..., 3])
    a, b = rng.random((9, 11, 5)), rng.random((9, 11, 5))
    np.testing.assert_array_equal(tmet.psnr_per_slice(a, b),
                                  jmet.psnr_per_slice(a, b))
    assert tmet.ssim(a, b) == jmet.ssim(a, b)
    d_t = tmet.dice_score_device(torch.from_numpy(pred),
                                 torch.from_numpy(true), 5).numpy()
    d_j = np.asarray(jmet.dice_score_device(jnp.asarray(pred),
                                            jnp.asarray(true), 5))
    np.testing.assert_array_equal(d_t, d_j)
    assert np.isnan(d_t[4])
    for shape in ((20, 17), (4, 30)):  # (4, 30): padding wider than the image
        x = rng.random(shape).astype(np.float32)
        y = np.clip(x + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
        s_t = float(tmet.ssim_torch(torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(
            s_t, float(jmet.ssim_jax(jnp.asarray(x), jnp.asarray(y))),
            rtol=0, atol=1e-6)
        np.testing.assert_allclose(s_t, jmet.ssim(x, y), rtol=0, atol=1e-5)


def test_uncertainty_fn_and_label_overlay_match_jax():
    from mri_raytracer_tpu.io.dashboard import label_overlay as jover
    from mri_raytracer_tpu_torch.io.dashboard import label_overlay as tover

    rng = np.random.default_rng(1)
    gray = rng.random((7, 9)).astype(np.float32) * 1.2 - 0.1
    lab = rng.integers(-1, 6, (7, 9))
    np.testing.assert_array_equal(tover(gray, lab), jover(gray, lab))
    cfg = TModel(kind="coord_injection", hidden_dims=(16, 16, 16, 16),
                 fourier_freqs=2, dropout=0.3)
    from mri_raytracer_tpu_torch.models.api import build_model
    model = build_model(cfg, 4)
    cell = [model.init(torch.Generator().manual_seed(0))]
    fn = tsteps.make_uncertainty_fn(model, cell, n_mc=6, base_key=3)
    c = torch.rand((50, 3)) * 2 - 1
    f = torch.randn((50, 4))
    e1, e2 = fn(c, f), fn(c, f)
    assert e1.shape == (50,) and torch.equal(e1, e2)  # same key each call
    assert float(e1.min()) >= 0 and float(e1.max()) <= np.log(4) + 1e-6
    cell[0] = model.init(torch.Generator().manual_seed(1))
    assert not torch.equal(fn(c, f), e1)  # reads the current params


def test_tv_patch_is_an_axial_pool_patch():
    """The TV patch: P x P in-plane voxels of one case at one z, row-major
    as JAX's, coords normalized like the samplers'."""
    rng = np.random.default_rng(3)
    pool = torch.from_numpy(rng.random((3, 4, 30, 28, 9)).astype(np.float32))
    g = torch.Generator().manual_seed(4)
    for _ in range(5):
        coords, intens = tsteps.sample_tv_patch(g, pool, 24)
        assert coords.shape == (576, 3) and intens.shape == (576, 4)
        idx = np.rint((coords.numpy() + 1) / 2 * np.array([29, 27, 8])
                      ).astype(int)
        assert len(np.unique(idx[:, 2])) == 1
        np.testing.assert_array_equal(idx[:24, 1] - idx[0, 1], np.arange(24))
        np.testing.assert_array_equal(idx[::24, 0] - idx[0, 0],
                                      np.arange(24))
        hits = [c for c in range(3) if np.array_equal(
            pool[c, :, idx[:, 0], idx[:, 1], idx[:, 2]].T.numpy(),
            intens.numpy())]
        assert hits
