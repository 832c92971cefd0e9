"""The port's fit-from-views (``train/fit_views.py``, its CLI and the fit
params converters) against the JAX package on the CPU, at small sizes.

Tolerances:
  * orbit bases: bit-equal (the same float32 numpy camera);
  * target field, target views, bake (values and its params gradient):
    atol 1e-5, float32 on both sides, with weights carried across by
    ``convert.fit_params_from_numpy``;
  * 5 Adam updates of ``fit_from_views`` and of ``fit_views_shearwarp``
    from the same weights, both sides fed the same ray / view draws (JAX's
    key stream cannot be matched): losses rtol 1e-5, params atol 1e-5;
  * whole runs (the port's own draws): the bars of
    tests/test_fit_views.py:13-23 and tests/test_diff_shearwarp.py:122-148.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.data import brats as jbrats, synthetic as jsyn
from mri_raytracer_tpu.ops import shearwarp as jsw
from mri_raytracer_tpu.render import params as jrp
from mri_raytracer_tpu.train import fit_views as jfv
from mri_raytracer_tpu_torch import convert
from mri_raytracer_tpu_torch.apps import fit_from_views as tapp
from mri_raytracer_tpu_torch.render import params as trp
from mri_raytracer_tpu_torch.train import fit_views as tfv

torch.set_num_threads(2)
TOL = dict(rtol=0, atol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_params(port, jtree, **tol):
    got = convert.fit_params_to_numpy(port)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(_np_tree(jtree))):
        np.testing.assert_allclose(a, b, **(tol or TOL))


@pytest.fixture(scope="module")
def disp():
    """A 12^3 synthetic case, percentile-normalized (M, X, Y, Z)."""
    mods, _ = jsyn.synthetic_case((12, 12, 12), seed=1)
    return np.stack([jbrats.percentile_normalize(m) for m in mods]) \
        .astype(np.float32)


def test_orbit_bases_bit_equal():
    for kw in (dict(), dict(radius=1.7, phase=np.pi / 16, phi=1.3)):
        jb = jfv.make_orbit_bases(16, **kw)
        tb = tfv.make_orbit_bases(16, **kw)
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b.pack().numpy(),
                                          np.asarray(a.pack()))


def test_fit_params_round_trip():
    tree = _np_tree(jfv.init_inr_field(jax.random.PRNGKey(3), rff_dim=8,
                                       hidden=(16, 16)))
    field = convert.fit_params_from_numpy(tree)
    back = convert.fit_params_to_numpy(field)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(0).uniform(-1, 1, (20, 3)).astype(np.float32)
    jf = jfv.make_inr_field(jax.tree_util.tree_map(jnp.asarray, tree))
    tf = tfv.make_inr_field(field)
    with torch.no_grad():
        for a, b in zip(tf(torch.from_numpy(x)), jf(jnp.asarray(x))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    with pytest.raises(ValueError, match="not a fit params tree"):
        convert.fit_params_from_numpy({"mlp": tree["mlp"]})


def test_target_field_and_views_match_jax(disp):
    x = np.random.default_rng(1).uniform(-1.1, 1.1, (50, 3)) \
        .astype(np.float32)
    jf = jfv.make_target_field(jnp.asarray(disp))
    tf = tfv.make_target_field(torch.from_numpy(disp))
    for a, b in zip(tf(torch.from_numpy(x)), jf(jnp.asarray(x))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    want = jfv.render_target_views(jf, jfv.make_orbit_bases(2), 16, 0.9,
                                   4.3, n_samples=32, row_chunk=8)
    got = tfv.render_target_views(tf, tfv.make_orbit_bases(2), 16, 0.9, 4.3,
                                  n_samples=32, row_chunk=8, device="cpu")
    assert got.shape == (2, 16, 16, 3) and got.max() > 0.05
    np.testing.assert_allclose(got, want, **TOL)


def test_bake_modalities_matches_jax():
    """Values and the params gradient of a probe of the bake, at a shape
    whose voxel count pads the last chunk."""
    shape = (6, 5, 4)
    jtree = jfv.init_modality_inr(jax.random.PRNGKey(2), rff_dim=8,
                                  hidden=(16, 16))
    probe = np.random.default_rng(2).normal(size=(4,) + shape) \
        .astype(np.float32)

    def jloss(t):
        return jnp.sum(jfv.bake_modalities(t, shape, chunk=32) * probe)

    want = jfv.bake_modalities(jtree, shape, chunk=32)
    jg = jax.grad(jloss)(jtree)
    field = convert.fit_params_from_numpy(_np_tree(jtree))
    got = tfv.bake_modalities(field, shape, chunk=32)
    assert got.shape == (4,) + shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    (got * torch.from_numpy(probe)).sum().backward()
    grads = {"B": field.B.grad,
             "mlp": [{"W": l.W.grad, "b": l.b.grad} for l in field.mlp]}
    for a, b in zip(jax.tree_util.tree_leaves(grads),
                    jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_fit_from_views_updates_match_jax(disp, monkeypatch):
    """5 Adam updates of the marcher fit from the same weights on the same
    ray batches: JAX's randint is handed the batch of the step key it
    derives, the port's draw the same batches in order."""
    steps, B, res, seed = 5, 64, 16, 7
    jf = jfv.make_target_field(jnp.asarray(disp))
    targets = jfv.render_target_views(jf, jfv.make_orbit_bases(2), res, 0.9,
                                      4.3, n_samples=32)
    n_rays = targets.shape[0] * res * res
    batches = np.random.default_rng(3).integers(0, n_rays, (steps, B)) \
        .astype(np.int32)
    key, _ = jax.random.split(jax.random.PRNGKey(seed))
    step_keys = []
    for _ in range(steps):
        key, kb = jax.random.split(key)
        step_keys.append(kb)
    table = jnp.stack(step_keys)

    def fake_randint(k, shape, lo, hi):
        i = jnp.argmax(jnp.all(table == k[None, :], axis=1))
        return jnp.asarray(batches)[i]

    jtree = jfv.init_inr_field(jax.random.PRNGKey(4), rff_dim=16,
                               hidden=(32, 32))
    field = convert.fit_params_from_numpy(_np_tree(jtree))
    kw = dict(steps=steps, batch_rays=B, n_coarse=8, n_fine=16, lr=3e-3,
              log_every=1, log_fn=lambda *_: None)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "randint", fake_randint)
        jparams, jlosses = jfv.fit_from_views(
            targets, jfv.make_orbit_bases(2), 0.9, 4.3,
            key=jax.random.PRNGKey(seed), params=jtree, **kw)
    drawn = iter(batches)
    monkeypatch.setattr(tfv, "_draw_rays", lambda g, n, b: torch.from_numpy(
        next(drawn)).long())
    tparams, tlosses = tfv.fit_from_views(
        targets, tfv.make_orbit_bases(2), 0.9, 4.3, seed=seed, params=field,
        device="cpu", **kw)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-7)
    _assert_params(tparams, jparams)
    moved = convert.fit_params_to_numpy(tparams)["mlp"][0]["W"] \
        - np.asarray(jtree["mlp"][0]["W"])
    assert np.abs(moved).max() > 1e-3


def test_fit_views_shearwarp_updates_match_jax(monkeypatch):
    """5 Adam updates of the shear-warp fit from the same weights on the
    same views (each step's views from its axis group)."""
    shape, res, out_res, steps = (12, 12, 12), 24, 16, 5
    mods, _ = jsyn.synthetic_case(shape, seed=3)
    d = np.stack([jbrats.percentile_normalize(m) for m in mods]) \
        .astype(np.float32)
    jp = jrp.default_render_params(shape, show_seg=False)
    radius = jrp.default_camera_radius(jp, shape)
    jb = jfv.make_orbit_bases(4, radius=radius)
    targets = np.stack([np.asarray(jsw.render_brats(
        jnp.asarray(d), None, None, b, jp, res, res, out_res=out_res,
        composite="scan", use_gamma=False, use_clip=False)) for b in jb])
    groups = {}
    for i, b in enumerate(jb):
        groups.setdefault(jsw.dominant_axis(b), []).append(i)
    axes = sorted(groups)
    assert len(axes) > 1
    rng = np.random.default_rng(5)
    picks = [rng.choice(groups[axes[it % len(axes)]], size=2)
             for it in range(steps)]

    class FakeRng:
        def __init__(self, *_):
            self.it = iter(picks)

        def choice(self, group, size, replace):
            return next(self.it)

    jtree = jfv.init_modality_inr(jax.random.PRNGKey(6), rff_dim=8,
                                  hidden=(16, 16))
    field = convert.fit_params_from_numpy(_np_tree(jtree))
    kw = dict(out_res=out_res, steps=steps, views_per_step=2, lr=2e-3,
              log_every=1, log_fn=lambda *_: None)
    # JAX runs op by op: its jitted sweep and its eager one part at rays
    # that graze the box (a crossing exactly on a box bound, an entry
    # offset exactly 2 plane spacings), where XLA's fused rounding flips a
    # mask (0.03 on these frames, whose bake has content on the box
    # faces); the port computes as the eager ops do (4.5e-8).
    with monkeypatch.context() as m, jax.disable_jit():
        m.setattr(np.random, "default_rng", FakeRng)
        jparams, jlosses = jfv.fit_views_shearwarp(
            targets, jb, jp, shape, key=jax.random.PRNGKey(0), params=jtree,
            **kw)
    drawn = iter(picks)
    monkeypatch.setattr(tfv, "_draw_views",
                        lambda g, group, k: list(next(drawn)))
    tp = trp.default_render_params(shape, show_seg=False)
    tparams, tlosses = tfv.fit_views_shearwarp(
        targets, tfv.make_orbit_bases(4, radius=radius), tp, shape,
        params=field, device="cpu", **kw)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-7)
    _assert_params(tparams, jparams)
    moved = convert.fit_params_to_numpy(tparams)["mlp"][0]["W"] \
        - np.asarray(jtree["mlp"][0]["W"])
    assert np.abs(moved).max() > 1e-3


def test_run_converges():
    """tests/test_fit_views.py:13-23's run and bars, with the port's own
    draws."""
    rec = tfv.run(shape=(12, 12, 12), res=24, n_train_views=3,
                  n_held_views=1, steps=90, batch_rays=384, n_coarse=12,
                  n_fine=16, seed=1, log_fn=lambda *_: None, device="cpu")
    assert rec["psnr_train_mean"] > 18.0, rec["psnr_train_mean"]
    assert np.isfinite(rec["psnr_heldout_mean"])
    assert rec["losses"][-1] < rec["losses"][0] * 0.2
    assert rec["n_params"] > 1000
    assert rec["_recovered"].shape == (3, 24, 24, 3)


def test_run_shearwarp_learns():
    """tests/test_diff_shearwarp.py:122-148's fit (16^3, 4 views at 32^2,
    out_res 16, 12 steps of 2 views) through run_shearwarp: the loss halves
    and the params stay finite."""
    rec = tfv.run_shearwarp(shape=(16, 16, 16), res=32, out_res=16,
                            n_train_views=4, n_held_views=1, steps=12,
                            views_per_step=2, seed=0, log_fn=lambda *_: None,
                            device="cpu")
    assert rec["losses"][-1] < 0.5 * rec["losses"][0], rec["losses"]
    assert all(bool(torch.isfinite(t).all())
               for t in rec["_params"].parameters())
    assert rec["n_params"] == 58244  # MLP 192 -> 128 x 3 -> 4
    assert np.isfinite(rec["psnr_heldout_mean"])


def test_cli_writes_record(tmp_path):
    out = tmp_path / "fv"
    rc = tapp.main(["--cpu", "--shape", "10,10,10", "--res", "16", "--views",
                    "2", "--held-views", "1", "--steps", "6", "--batch-rays",
                    "64", "--n-coarse", "8", "--n-fine", "8", "--out",
                    str(out)])
    assert rc in (0, 1)
    rec = json.loads((out / "fit_from_views.json").read_text())
    assert {"psnr_train_mean", "psnr_heldout_mean", "wall_s_fit",
            "losses", "n_params"} <= set(rec) and rec["device"] == "the CPU"
    assert not any(k.startswith("_") for k in rec)
    assert "Success bar (>= 30 dB" in (out / "FIT_FROM_VIEWS.md").read_text()
    assert (out / "img" / "fit_from_views_pair.png").read_bytes()[:4] \
        == b"\x89PNG"
    rc = tapp.main(["--cpu", "--renderer", "shearwarp", "--shape", "8,8,8",
                    "--res", "16", "--out-res", "8", "--views", "2",
                    "--held-views", "1", "--steps", "2", "--out", str(out)])
    assert rc in (0, 1)
    rec = json.loads((out / "fit_from_views_shearwarp.json").read_text())
    assert rec["renderer"] == "shearwarp" and "volume_psnr_db" in rec
