"""The port's INR models, config, normalization and checkpoint reader
against the JAX package, on the CPU.

Weights cross with ``convert.inr_params_from_numpy`` (``jax.random`` draws
cannot be reproduced in torch). Tolerances: atol 1e-6 for the
deterministic Fourier features and ``build_input`` (elementwise float32
sin/cos; their angles stay under 6 pi); a bound per element for the
random-projection features (RFF, anisotropic), ``rff_bound``: the angle
``2 pi (coords @ B)`` reaches ~106 rad here, where a float32 ulp is
7.6e-6, and the two packages sum the dot product in another order. Its
three products, two additions and the scaling by 2 pi each round to at
most half an ulp of a value no larger than ``2 pi (|coords| @ |B|)``, so
the angles differ by at most 3 ulps of that value; sin and cos move by no
more than their argument does, and add 2.4e-7 of their own rounding;
rtol/atol 1e-5 for logits (float32 matmuls
summed in another order); bit-equality for host numpy code
(``zscore_nonzero``, the config) and for the pytree both checkpoint
loaders return.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.config import ModelConfig as JCfg
from mri_raytracer_tpu.data import brats as jbrats
from mri_raytracer_tpu.io import checkpoint as jckpt
from mri_raytracer_tpu.models import features as jfeat
from mri_raytracer_tpu.models.api import build_model as jbuild
from mri_raytracer_tpu.models.mlp import count_params as jcount
from mri_raytracer_tpu_torch import convert
from mri_raytracer_tpu_torch.config import ModelConfig as TCfg
from mri_raytracer_tpu_torch.data import brats as tbrats
from mri_raytracer_tpu_torch.io import checkpoint as tckpt
from mri_raytracer_tpu_torch.models import features as tfeat, mlp as tmlp
from mri_raytracer_tpu_torch.models.api import build_model as tbuild

torch.set_num_threads(2)

KINDS = {
    "mlp": dict(),
    "mlp_small": dict(hidden_dims=(16, 16), fourier_freqs=4),
    "mlp_no_ff_no_mods": dict(hidden_dims=(16,), fourier_freqs=0,
                              use_modalities=False),
    "rff": dict(rff_dim=8, hidden_dims=(16,)),
    "aniso": dict(aniso_features=True, rff_dim=8, hidden_dims=(16,),
                  voxel_spacing=(1.0, 1.2, 0.8)),
    "siren": dict(kind="siren", hidden_dims=(16, 16)),
    "coord_injection": dict(kind="coord_injection",
                            hidden_dims=(16, 16, 16, 16)),
}


def _inputs(n=257, m=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.normal(0, 1, (n, m)).astype(np.float32))


def _both(cfg_kw, seed=1):
    jc = JCfg(**cfg_kw)
    jm = jbuild(jc, num_modalities=4)
    jp = jm.init(jax.random.PRNGKey(seed))
    rff_B = None if jm.rff_B is None else np.asarray(jm.rff_B)
    tm, tp = convert.inr_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), dataclasses.asdict(jc),
        rff_B=rff_B)
    return jm, jp, tm, tp


def test_model_config_matches_jax():
    assert dataclasses.asdict(TCfg()) == dataclasses.asdict(JCfg())
    assert [f.name for f in dataclasses.fields(TCfg)] == \
        [f.name for f in dataclasses.fields(JCfg)]
    # The sidecar forms the JAX apps read (apps/brats_app.py:91-99).
    jc = JCfg(kind="siren", hidden_dims=(32, 32), num_classes=3)
    info = {"model": json.loads(json.dumps(dataclasses.asdict(jc)))}
    assert TCfg.from_info(info) == TCfg(**dataclasses.asdict(jc))
    ref = TCfg.from_info({"FOURIER_FREQS": 3, "HIDDEN_DIMS": [8, 8]})
    assert (ref.fourier_freqs, ref.hidden_dims, ref.num_classes) == \
        (3, (8, 8), 4)
    assert TCfg.from_info({"step": 7}) == TCfg()
    assert TCfg.from_info(None) == TCfg()


@pytest.mark.parametrize("arr", [
    np.random.default_rng(0).normal(3, 2, (6, 7, 5)).astype(np.float32)
    * (np.random.default_rng(1).random((6, 7, 5)) > 0.4),
    np.zeros((4, 4, 4), np.float32),
    np.full((3, 3, 3), 2.5, np.float32),
], ids=["masked", "zeros", "constant"])
def test_zscore_nonzero_bit_equal(arr):
    a = jbrats.zscore_nonzero(arr.copy())
    b = tbrats.zscore_nonzero(arr.copy())
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def rff_bound(coords, B):
    """Per-element bound on |port - JAX| of [sin(ang), cos(ang)] with
    ang = 2 pi (coords @ B): 3 ulps of 2 pi (|coords| @ |B|) in float32,
    plus 2.4e-7 for sin and cos themselves (module docstring)."""
    mag = (2.0 * np.pi * (np.abs(coords).astype(np.float64)
                          @ np.abs(B).astype(np.float64))).astype(np.float32)
    per = 3.0 * np.spacing(mag).astype(np.float64) + 2.4e-7
    return np.concatenate([per, per], axis=-1)


@pytest.mark.parametrize("k", [0, 1, 6])
def test_features_match_jax(k):
    coords, intens = _inputs()
    cj, ij = jnp.asarray(coords), jnp.asarray(intens)
    ct, it = torch.from_numpy(coords), torch.from_numpy(intens)
    B = np.random.default_rng(2).normal(0, 5, (3, 8)).astype(np.float32)
    if k:
        np.testing.assert_allclose(tfeat.fourier_features(ct, k).numpy(),
                                   np.asarray(jfeat.fourier_features(cj, k)),
                                   atol=1e-6)
    np.testing.assert_allclose(
        tfeat.build_input(ct, it, k).numpy(),
        np.asarray(jfeat.build_input(cj, ij, k)), atol=1e-6)
    bound = rff_bound(coords, B)
    got = tfeat.build_input(ct, None, k, torch.from_numpy(B)).numpy()
    want = np.asarray(jfeat.build_input(cj, None, k, jnp.asarray(B)))
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    assert np.all(np.abs(got[:, 3:] - want[:, 3:]) <= bound), \
        np.max(np.abs(got[:, 3:] - want[:, 3:]) / bound)
    got = tfeat.apply_anisotropic_features(ct, torch.from_numpy(B)).numpy()
    want = np.asarray(jfeat.apply_anisotropic_features(cj, jnp.asarray(B)))
    assert np.all(np.abs(got - want) <= bound), \
        np.max(np.abs(got - want) / bound)
    for rff in (0, 8):
        assert tfeat.feature_dim(3, k, rff) == jfeat.feature_dim(3, k, rff)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_apply_logits_match_jax(kind):
    jm, jp, tm, tp = _both(KINDS[kind])
    assert tm.input_dim == jm.input_dim
    assert tmlp.count_params(tp) == jcount(jp)
    coords, intens = _inputs()
    lj = np.asarray(jm.apply(jp, jnp.asarray(coords), jnp.asarray(intens)))
    lt = tm.apply(tp, torch.from_numpy(coords), torch.from_numpy(intens))
    assert lt.shape == lj.shape == (len(coords), 4)
    np.testing.assert_allclose(lt.detach().numpy(), lj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_port_init_shapes_and_ranges(kind):
    """The port's own init gives the JAX layout (same parameter count and
    shapes as a converted model) and the JAX distributions' ranges."""
    cfg = TCfg(**KINDS[kind])
    tm = tbuild(cfg, num_modalities=4)
    a = tm.init(torch.Generator().manual_seed(0))
    b = tm.init(torch.Generator().manual_seed(0))
    _, _, _, tp = _both(KINDS[kind])
    assert {k: v.shape for k, v in a.state_dict().items()} == \
        {k: v.shape for k, v in tp.state_dict().items()}
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name  # same generator seed, same draw
    first = next(v for k, v in a.state_dict().items() if k.endswith("W"))
    fan_in, fan_out = first.shape
    lim = 1.0 / fan_in if cfg.kind == "siren" else \
        (6.0 / (fan_in + fan_out)) ** 0.5
    assert float(first.abs().max()) <= lim
    assert float(first.abs().max()) > 0.5 * lim


def test_coord_injection_dropout_and_freq_dropout_train_only():
    _, _, tm, tp = _both(KINDS["coord_injection"])
    tm.cfg.dropout = 0.5
    coords, intens = map(torch.from_numpy, _inputs())
    ev = tm.apply(tp, coords, intens)
    tr = tm.apply(tp, coords, intens, rng=torch.Generator().manual_seed(0),
                  train=True)
    assert torch.equal(ev, tm.apply(tp, coords, intens, train=True))
    assert not torch.equal(ev, tr)
    _, _, tm2, tp2 = _both(KINDS["mlp_small"])
    g = torch.Generator().manual_seed(0)
    assert not torch.equal(
        tm2.apply(tp2, coords, intens),
        tm2.apply(tp2, coords, intens, rng=g, train=True, freq_dropout=0.5))


def test_converter_rejects_mismatches():
    jm, jp, _, _ = _both(KINDS["mlp_small"])
    tree = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(ValueError):  # 4 hidden layers in the config
        convert.inr_params_from_numpy(tree, TCfg(fourier_freqs=4))
    with pytest.raises(ValueError):  # fan-in too small for 6 harmonics
        convert.inr_params_from_numpy(tree, TCfg(hidden_dims=(16, 16)))
    with pytest.raises(ValueError):  # RFF needs the JAX projection
        convert.inr_params_from_numpy(
            tree, TCfg(rff_dim=8, hidden_dims=(16, 16)))


@pytest.mark.parametrize("fmt,kind", [("flat", "mlp_small"),
                                      ("object", "mlp_small"),
                                      ("object", "siren"),
                                      ("object", "aniso")])
def test_jax_checkpoints_load_in_the_port(tmp_path, fmt, kind):
    jc = JCfg(**KINDS[kind])
    jm = jbuild(jc, num_modalities=4)
    jp = jm.init(jax.random.PRNGKey(7))
    path = tmp_path / "run.npz"
    if fmt == "flat":
        jckpt.save_flat(jp, path)
        loaded, info = tckpt.model_load(path, require_sidecar=False)
        assert info == {}
        cfg = dataclasses.asdict(jc)
    else:
        jckpt.save_object(jp, path, info={"model": dataclasses.asdict(jc),
                                          "step": 3})
        loaded, info = tckpt.model_load(path)
        assert info["step"] == 3
        cfg = TCfg.from_info(info)
        assert cfg == TCfg(**dataclasses.asdict(jc))
    tm, tp = convert.inr_params_from_numpy(loaded, cfg)
    coords, intens = _inputs(seed=3)
    lj = np.asarray(jm.apply(jp, jnp.asarray(coords), jnp.asarray(intens)))
    lt = tm.apply(tp, torch.from_numpy(coords), torch.from_numpy(intens))
    np.testing.assert_allclose(lt.detach().numpy(), lj, rtol=1e-5, atol=1e-5)
    # Both loaders return the same pytree.
    ref = jckpt.load_params(path)
    got = tckpt.load_params(path)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        tckpt.model_load(tmp_path / "missing.npz")
    jp = jbuild(JCfg(**KINDS["mlp_small"]), 4).init(jax.random.PRNGKey(0))
    path = tmp_path / "x.npz"
    jckpt.save_flat(jp, path)
    with pytest.raises(FileNotFoundError):  # no sidecar
        tckpt.model_load(path)
    np.savez(tmp_path / "bad.npz", a=np.zeros(2), b=np.ones(2))
    with pytest.raises(KeyError):
        tckpt.load_params(tmp_path / "bad.npz")
    # A single unnamed array loads as itself, as in the JAX loader.
    np.savez(tmp_path / "one.npz", np.arange(3.0))
    np.testing.assert_array_equal(tckpt.load_params(tmp_path / "one.npz"),
                                  jckpt.load_params(tmp_path / "one.npz"))
