"""The port's U-Net baseline path against the JAX package, on the CPU, at
the sizes of ``tests/test_unet_nnunet.py`` (the 16 x 16 x 12 three-case
synthetic dataset, base 8): slices, prefetch, manifests, ``UNet2D``, the
trainer and distillation, the ``.pth`` loaders, ``predict_volume``'s
options, nnU-Net's adapter and the native loader.

Tolerances:
  * ``build_slice_index``, ``slice_batches``, ``collect_voxels``,
    manifests, nnU-Net's files: bit-equal;
  * ``UNet2D`` forward from carried weights, train and eval mode, and a
    reference ``.pth`` through the loaders: 2e-4 (the bar of
    ``tests/test_torch_interop.py``), the running averages 1e-6;
  * 3 AdamW steps against flax + ``optax.adamw`` on the same batches:
    loss, params and ``batch_stats`` 1e-4 relative, in float64 on both
    sides. A convolution bias in front of a BatchNorm has a gradient of 0
    in exact arithmetic (the norm subtracts it again): Adam turns the
    rounding noise there into steps of up to ``lr`` that differ between
    any two implementations (float32: 1e-3 at lr 1e-3 after 3 steps), so
    those leaves are held to stay at 0 (< 1e-9) on both sides in float64,
    and the float32 steps are compared by their losses (1e-4);
  * ``combo_loss`` and its gradient 1e-6, ``hard_dice_classes`` equal;
  * one distillation step from the same weights on the same indices: loss
    and params 1e-5 (Adam's float32 bias corrections, as
    ``tests/test_torch_port_losses.py``);
  * ``unet_best.npz`` written by the port, through JAX's ``load_params`` +
    ``UNet2D.apply``: logits 2e-4 against the port's;
  * ``predict_volume(gaussian_sigma=1.0)`` and ``exact=True``: labels
    equal to JAX's (the float32 path; the filter is SciPy's on both sides);
  * the native loader: the port's binding and JAX's on the same library
    bit-equal, ``RAMCache(use_native=True)`` bit-equal to JAX's; the
    library's z-score against NumPy doing its arithmetic (double sums)
    bit-equal, against ``zscore_nonzero`` (float32 sums) 1e-4, as
    ``tests/test_native_io.py``. Skipped without a C++ compiler.
"""

import ctypes
import gzip
import json
import pathlib
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mri_raytracer_tpu.data import cache as jcache, \
    manifest as jmanifest, slices as jslices
from mri_raytracer_tpu.eval import inference as jinf
from mri_raytracer_tpu.io import checkpoint as jckpt, native as jnative
from mri_raytracer_tpu.config import ModelConfig as JModel
from mri_raytracer_tpu.models import unet as junet
from mri_raytracer_tpu.models.api import build_model as jbuild
from mri_raytracer_tpu.train import nnunet as jnn, unet_trainer as jtrain
from mri_raytracer_tpu_torch import convert
from mri_raytracer_tpu_torch.config import ModelConfig as TModel
from mri_raytracer_tpu_torch.data import brats as tbrats, cache as tcache, \
    manifest as tmanifest, nifti as tnifti, slices as tslices, \
    synthetic as tsyn
from mri_raytracer_tpu_torch.eval import inference as tinf
from mri_raytracer_tpu_torch.io import checkpoint as tckpt, native as tnative
from mri_raytracer_tpu_torch.models import unet as tunet
from mri_raytracer_tpu_torch.train import nnunet as tnn, \
    unet_trainer as ttrain

torch.set_num_threads(2)
SHAPE = (16, 16, 12)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats_port_unet")
    tsyn.write_synthetic_dataset(root, num_cases=3, shape=SHAPE, seed=9)
    return root


@pytest.fixture(scope="module")
def caches(dataset):
    cases = tbrats.find_cases(dataset)
    kw = dict(verbose=False, use_native=False)
    return (jcache.RAMCache(cases[:2], **kw), jcache.RAMCache(cases[2:], **kw),
            tcache.RAMCache(cases[:2], **kw), tcache.RAMCache(cases[2:], **kw))


# ------------------------------------------------------------------ slices
@pytest.mark.parametrize("min_fg,bg_keep,seed", [(0.0, 0.3, 0),
                                                 (0.05, 0.5, 3),
                                                 (0.0, 1.0, 1)])
def test_slice_index_and_batches_bit_equal(caches, min_fg, bg_keep, seed):
    jtr, _, ttr, _ = caches
    ij = jslices.build_slice_index(jtr, min_fg, bg_keep, seed)
    it = tslices.build_slice_index(ttr, min_fg, bg_keep, seed)
    assert it == ij and len(it) > 4
    for pad in (8, 5):
        bj = list(jslices.slice_batches(jtr, ij, 3, seed=seed, epochs=2,
                                        pad_mult=pad))
        bt = list(tslices.slice_batches(ttr, it, 3, seed=seed, epochs=2,
                                        pad_mult=pad))
        assert len(bt) == len(bj) > 0
        for (xt, yt), (xj, yj) in zip(bt, bj):
            assert xt.dtype == np.float32 and yt.dtype == np.int32
            assert xt.shape[1] % pad == 0 and xt.shape[-1] == 4
            np.testing.assert_array_equal(xt, xj)
            np.testing.assert_array_equal(yt, yj)


def test_prefetch_stages_batches_and_raises(caches):
    _, _, ttr, _ = caches
    idx = tslices.build_slice_index(ttr, bg_keep_ratio=1.0)
    want = list(tslices.slice_batches(ttr, idx, 2, epochs=1))
    got = list(tslices.prefetch(tslices.slice_batches(ttr, idx, 2, epochs=1),
                                max_prefetch=2, device="cpu"))
    assert len(got) == len(want) >= 10
    for (xt, yt), (xn, yn) in zip(got, want):
        assert isinstance(xt, torch.Tensor) and xt.device.type == "cpu"
        np.testing.assert_array_equal(xt.numpy(), xn)
        np.testing.assert_array_equal(yt.numpy(), yn)

    def broken():
        yield want[0]
        raise OSError("disk gone")

    it = tslices.prefetch(broken(), device="cpu")
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(tslices.prefetch(iter(want)))


# --------------------------------------------------------------- manifests
def test_manifest_matches_jax(dataset, tmp_path):
    rt = tmanifest.build_brats_manifest(dataset, tmp_path / "t.csv")
    rj = jmanifest.build_brats_manifest(dataset, tmp_path / "j.csv")
    assert rt == rj and len(rt) == 3
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    loaded = tmanifest.load_manifest(tmp_path / "t.csv")
    assert loaded == jmanifest.load_manifest(tmp_path / "j.csv")
    assert tmanifest.manifest_case_paths(loaded, dataset) == \
        jmanifest.manifest_case_paths(loaded, dataset)
    pytest.importorskip("pandas")
    df = tmanifest.load_mu_glioma_manifest(tmp_path / "t.csv")
    assert df.equals(jmanifest.load_mu_glioma_manifest(tmp_path / "j.csv"))


# ------------------------------------------------------------------- U-Net
@pytest.fixture(scope="module")
def flax_unet():
    """flax's UNet2D at base 8 and its variables (numpy) with non-trivial
    running averages, so eval mode exercises them. ``create_unet``'s init,
    jitted: the same variables, a quarter of the time."""
    model = junet.UNet2D(n_classes=4, base=8)
    var = jax.jit(lambda k: model.init(k, jnp.zeros((1, 16, 16, 4)),
                                       train=False))(jax.random.PRNGKey(0))
    var = jax.tree_util.tree_map(np.asarray, var)
    rng = np.random.default_rng(1)
    var["batch_stats"] = jax.tree_util.tree_map(
        lambda v: (v + rng.uniform(0.2, 0.5, v.shape)).astype(np.float32),
        var["batch_stats"])
    return model, var


def _port_unet(var, base=8):
    net = tunet.UNet2D(4, 4, base)
    net.load_state_dict(convert.unet_from_flax(var))
    return net


def _max_rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("train", [False, True])
def test_unet_forward_matches_flax(flax_unet, train):
    model, var = flax_unet
    net = _port_unet(var)
    x = np.random.default_rng(2).normal(size=(4, 16, 16, 4)).astype(np.float32)
    got = tunet.unet_apply(net, torch.from_numpy(x), train=train)
    assert got.shape == (4, 16, 16, 4)
    if train:
        want, mut = junet.unet_apply(model, var, jnp.asarray(x), train=True)
        stats = convert.unet_to_flax(net)["batch_stats"]
        for a, b in zip(jax.tree_util.tree_leaves(stats),
                        jax.tree_util.tree_leaves(mut["batch_stats"])):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    else:
        want = junet.unet_apply(model, var, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_unet_layout_and_flax_roundtrip(flax_unet):
    _, var = flax_unet
    net = _port_unet(var)
    assert list(dict(net.named_children())) == [
        "d1", "d2", "d3", "b", "u3", "c3", "u2", "c2", "u1", "c1", "out"]
    assert [type(m).__name__ for m in net.d1.net] == [
        "Conv2d", "FlaxBatchNorm2d", "ReLU", "Conv2d", "FlaxBatchNorm2d",
        "ReLU"]
    back = convert.unet_to_flax(net)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(var)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(var)):
        np.testing.assert_array_equal(a, b)
    # flax's initializers: lecun_normal kernels, zero biases, unit BN.
    fresh = tunet.create_unet(torch.Generator().manual_seed(0), 4, 4, 32,
                              (240, 240))
    w = fresh.c3.net[0].weight.detach()
    assert abs(float(w.std()) - (1.0 / (256 * 9)) ** 0.5) < 2e-3
    assert float(w.abs().max()) <= 2.0 * (1.0 / (256 * 9)) ** 0.5 / 0.8796 + 1e-6
    assert float(fresh.u3.bias.detach().abs().max()) == 0.0
    with pytest.raises(ValueError, match="divisible by 8"):
        tunet.create_unet(torch.Generator(), 4, 4, 8, (20, 16))


def _pre_bn_bias(path: str) -> bool:
    return "DoubleConv" in path and "Conv_" in path and path.endswith(
        "['bias']") and "BatchNorm" not in path


def test_unet_three_adamw_steps_match_flax(flax_unet):
    model, var = flax_unet
    rng = np.random.default_rng(5)
    # Batch 4 of 16 x 16: the bottleneck normalizes 2 x 2 x 4 = 16 values,
    # where the unbiased variance is 16/15 of flax's biased one.
    batches = [(rng.normal(size=(4, 16, 16, 4)),
                rng.integers(0, 4, (4, 16, 16)).astype(np.int32))
               for _ in range(3)]

    def run(dtype, jdtype):
        net = _port_unet(var).to(dtype)
        step = ttrain.make_train_step(net, ttrain.build_adamw(net, 1e-3), 4)
        tx = optax.adamw(1e-3)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdtype),
                                        var["params"])
        bs = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdtype),
                                    var["batch_stats"])
        st = tx.init(params)

        def lf(p, bs, x, y):
            lg, mut = model.apply({"params": p, "batch_stats": bs}, x,
                                  train=True, mutable=["batch_stats"])
            return jtrain.combo_loss(lg, y, 4), mut

        grad = jax.jit(jax.value_and_grad(lf, has_aux=True))
        lt, lj = [], []
        for x, y in batches:
            (l, mut), g = grad(params, bs, jnp.asarray(x, jdtype),
                               jnp.asarray(y))
            upd, st = tx.update(g, st, params)
            params, bs = optax.apply_updates(params, upd), mut["batch_stats"]
            lj.append(float(l))
            lt.append(float(step(torch.from_numpy(x).to(dtype),
                                 torch.from_numpy(y))))
        return lt, lj, convert.unet_to_flax(net), params, bs

    lt, lj, back, params, bs = run(torch.float32, jnp.float32)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    with jax.enable_x64(True):
        lt, lj, back, params, bs = run(torch.float64, jnp.float64)
        np.testing.assert_allclose(lt, lj, rtol=1e-4)
        for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = jax.tree_util.keystr(path)
            got = back["params"]
            for k in path:
                got = got[k.key]
            if _pre_bn_bias(key):
                assert np.abs(got).max() < 1e-9, key
                assert np.abs(np.asarray(want)).max() < 1e-9, key
            else:
                assert _max_rel(got, want) <= 1e-4, key
        for a, b in zip(jax.tree_util.tree_leaves(back["batch_stats"]),
                        jax.tree_util.tree_leaves(bs)):
            assert _max_rel(a, b) <= 1e-4


def test_combo_loss_and_hard_dice_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (3, 8, 8, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (3, 8, 8)).astype(np.int32)
    for kw in ({}, {"class_weights": (0.5, 1.0, 3.0, 2.0), "dice_w": 0.2}):
        lj, gj = jax.value_and_grad(
            lambda z: jtrain.combo_loss(z, jnp.asarray(labels), 4, **kw))(
                jnp.asarray(logits))
        lt_in = torch.from_numpy(logits).requires_grad_(True)
        lt = ttrain.combo_loss(lt_in, torch.from_numpy(labels), 4, **kw)
        lt.backward()
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
        np.testing.assert_allclose(lt_in.grad.numpy(), np.asarray(gj),
                                   rtol=1e-6, atol=1e-8)
    pred = rng.integers(0, 4, (2, 8, 8))
    true = rng.integers(0, 3, (2, 8, 8))
    for classes in ((1, 2, 3), (0, 3)):
        dt = ttrain.hard_dice_classes(pred, true, classes)
        dj = jtrain.hard_dice_classes(pred, true, classes)
        assert list(dt) == list(dj)
        np.testing.assert_array_equal(list(dt.values()), list(dj.values()))


# ------------------------------------------------------------- .pth files
class _RefDouble(torch.nn.Module):
    """The reference's DoubleConv (Final-1.ipynb §4), plain torch BN."""

    def __init__(self, ci, co):
        super().__init__()
        self.net = torch.nn.Sequential(
            torch.nn.Conv2d(ci, co, 3, padding=1), torch.nn.BatchNorm2d(co),
            torch.nn.ReLU(),
            torch.nn.Conv2d(co, co, 3, padding=1), torch.nn.BatchNorm2d(co),
            torch.nn.ReLU())

    def forward(self, x):
        return self.net(x)


class _RefUNet(torch.nn.Module):
    """The reference's UNet2D (as ``tests/test_torch_interop.py``)."""

    def __init__(self, in_ch=4, n_classes=4, base=8):
        super().__init__()
        b = base
        self.d1, self.d2 = _RefDouble(in_ch, b), _RefDouble(b, b * 2)
        self.d3, self.b = _RefDouble(b * 2, b * 4), _RefDouble(b * 4, b * 8)
        self.u3 = torch.nn.ConvTranspose2d(b * 8, b * 4, 2, stride=2)
        self.c3 = _RefDouble(b * 8, b * 4)
        self.u2 = torch.nn.ConvTranspose2d(b * 4, b * 2, 2, stride=2)
        self.c2 = _RefDouble(b * 4, b * 2)
        self.u1 = torch.nn.ConvTranspose2d(b * 2, b, 2, stride=2)
        self.c1 = _RefDouble(b * 2, b)
        self.out = torch.nn.Conv2d(b, n_classes, 1)

    def forward(self, x):
        pool = torch.nn.functional.max_pool2d
        x1 = self.d1(x)
        x2 = self.d2(pool(x1, 2))
        x3 = self.d3(pool(x2, 2))
        xb = self.b(pool(x3, 2))
        y = self.c3(torch.cat([self.u3(xb), x3], 1))
        y = self.c2(torch.cat([self.u2(y), x2], 1))
        y = self.c1(torch.cat([self.u1(y), x1], 1))
        return self.out(y)


def test_reference_pth_loads_into_the_port(tmp_path):
    torch.manual_seed(0)
    net = _RefUNet(in_ch=4, n_classes=3, base=8)
    with torch.no_grad():
        net.train()
        for _ in range(3):
            net(torch.randn(2, 4, 16, 16))
    net.eval()
    x = np.random.default_rng(2).normal(size=(2, 16, 16, 4)).astype(np.float32)
    with torch.no_grad():
        want = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    for i, wrap in enumerate((lambda sd: sd, lambda sd: {"state_dict": sd},
                              lambda sd: {"model_state_dict": sd},
                              lambda sd: {"network_weights": sd,
                                          "current_epoch": 4})):
        p = tmp_path / f"unet_{i}.pth"
        torch.save(wrap(net.state_dict()), p)
        sd_t = tckpt.load_torch_state_dict(p)
        sd_j = jckpt.load_torch_state_dict(p)
        assert sd_t.keys() == sd_j.keys()
        port = tckpt.load_torch_unet(sd_t)
        assert not port.training and port.base == 8 and port.n_classes == 3
        got = tunet.unet_apply(port, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want.transpose(0, 2, 3, 1),
                                   rtol=2e-4, atol=2e-4)
    # The port's weights carried to flax equal JAX's own loader's.
    jvar = jckpt.torch_unet_to_flax(sd_j)
    tvar = convert.unet_to_flax(port)
    for a, b in zip(jax.tree_util.tree_leaves(tvar),
                    jax.tree_util.tree_leaves(jvar)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no tensors"):
        torch.save({"epoch": 3}, tmp_path / "empty.pth")
        tckpt.load_torch_state_dict(tmp_path / "empty.pth")


def test_reference_mlp_pth_to_port(tmp_path):
    torch.manual_seed(1)
    net = torch.nn.Sequential(torch.nn.Linear(3, 64), torch.nn.ReLU(),
                              torch.nn.Linear(64, 64), torch.nn.ReLU(),
                              torch.nn.Linear(64, 4))
    p = tmp_path / "implicit_mlp.pth"
    torch.save({"network_weights": net.state_dict()}, p)
    mlp = tckpt.torch_mlp_to_pytree(tckpt.load_torch_state_dict(p))
    tree = tckpt.params_to_numpy(mlp)
    want_tree = jckpt.torch_mlp_to_pytree(jckpt.load_torch_state_dict(p))
    for a, b in zip(tree, want_tree):
        for k in ("W", "b"):
            np.testing.assert_array_equal(a[k], b[k])
    x = np.random.default_rng(1).normal(size=(32, 3)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(mlp(torch.from_numpy(x)).numpy(),
                                   net(torch.from_numpy(x)).numpy(),
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the trainer
def test_train_unet_end_to_end_and_checkpoint_in_jax(caches, tmp_path):
    _, _, ttr, tva = caches
    out = ttrain.train_unet(ttr, tva, epochs=2, batch_size=4, base=8,
                            out_dir=str(tmp_path), verbose=False,
                            device="cpu")
    hist = out["history"]
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"] * 1.5
    assert out["best"]["epoch"] in (0, 1)
    ckpt = tmp_path / "unet_best.npz"
    info = json.loads((tmp_path / "unet_best_info.json").read_text())
    assert info["base"] == 8 and info["epoch"] == out["best"]["epoch"]
    variables = jckpt.load_params(ckpt)
    net = tunet.UNet2D(4, 4, 8)
    net.load_state_dict(convert.unet_from_flax(tckpt.load_params(ckpt)))
    x = np.random.default_rng(3).normal(size=(2, 16, 16, 4)).astype(np.float32)
    want = junet.unet_apply(junet.UNet2D(n_classes=4, base=8), variables,
                            jnp.asarray(x))
    got = tunet.unet_apply(net, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    if out["best"]["epoch"] == len(hist) - 1:  # the model is the best epoch's
        np.testing.assert_array_equal(
            got.numpy(), tunet.unet_apply(out["model"],
                                          torch.from_numpy(x)).numpy())


def test_train_unet_runs_on_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train_unet(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.distill_to_implicit(np.zeros((4, 4, 4), np.int16))


# ----------------------------------------------------------- distillation
@pytest.mark.parametrize("n,seed,fg_bias", [(512, 1, 0.5), (1000, 7, 0.2),
                                            (64, 0, 0.0)])
def test_collect_voxels_bit_equal(n, seed, fg_bias):
    _, seg = tsyn.synthetic_case(SHAPE, seed=4)
    ct, lt = ttrain.collect_voxels(seg.astype(np.int16), n, seed, fg_bias)
    cj, lj = jtrain.collect_voxels(seg.astype(np.int16), n, seed, fg_bias)
    assert ct.dtype == np.float32 and lt.dtype == np.int32
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(lt, lj)


def test_distill_step_matches_jax():
    _, seg = tsyn.synthetic_case(SHAPE, seed=4)
    coords, labels = jtrain.collect_voxels(seg.astype(np.int16), 2048, 0)
    kw = dict(kind="mlp", hidden_dims=(16, 16), fourier_freqs=4,
              num_classes=4, use_modalities=False)
    jm = jbuild(JModel(**kw), num_modalities=0)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm, tp = convert.inr_params_from_numpy(tree, TModel(**kw))
    sel = np.random.default_rng(0).integers(0, len(coords), 512)

    # JAX's step, as distill_to_implicit builds it.
    tx = optax.adam(1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    st = tx.init(jp)

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(coords)[sel], None)
        y = jax.nn.one_hot(jnp.asarray(labels)[sel], 4)
        from mri_raytracer_tpu import losses as jl
        return jnp.mean(jl.weighted_ce(logits, y))

    opt = torch.optim.Adam(tp.parameters(), lr=1e-3, betas=(0.9, 0.999),
                           eps=1e-8)
    step = ttrain.make_distill_step(tm, tp, opt, torch.from_numpy(coords),
                                    torch.from_numpy(labels), 4)
    for _ in range(2):
        lj, g = jax.value_and_grad(loss_fn)(jp)
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
        lt = step(torch.from_numpy(sel))
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    got = tckpt.params_to_numpy(tp)
    for a, b in zip(got, jax.tree_util.tree_map(np.asarray, jp)):
        for k in ("W", "b"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5)


def test_distill_to_implicit_learns():
    _, seg = tsyn.synthetic_case(SHAPE, seed=4)
    out = ttrain.distill_to_implicit(seg.astype(np.int16), hidden=(16, 16),
                                     steps=120, batch=512, device="cpu")
    assert out["loss_history"][-1] < out["loss_history"][0]
    coords, labels = ttrain.collect_voxels(seg.astype(np.int16), 512, 1)
    with torch.no_grad():
        logits = out["model"].apply(out["params"], torch.from_numpy(coords),
                                    None)
    assert float((logits.argmax(-1).numpy() == labels).mean()) > 0.5


# ---------------------------------------------------------- predict_volume
def test_predict_volume_gaussian_and_exact_match_jax(caches):
    jtr, _, _, _ = caches
    case = jtr.get(0)
    kw = dict(kind="mlp", hidden_dims=(16, 16), fourier_freqs=2)
    jm = jbuild(JModel(**kw), 4)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    tree[-1]["b"] = np.array([0.0, 0.4, 0.5, 0.45], np.float32)
    tm, tp = convert.inr_params_from_numpy(tree, TModel(**kw))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    for opts in ({"gaussian_sigma": 1.0, "exact": True}, {"exact": True},
                 {"gaussian_sigma": 1.5}):
        pj, sj = jinf.predict_volume(jm, jp, case, **opts)
        pt, st = tinf.predict_volume(tm, tp, case, device="cpu", **opts)
        np.testing.assert_array_equal(st, sj)
        assert pt.dtype == np.asarray(pj).dtype and pt.shape == SHAPE
        if opts.get("exact"):
            np.testing.assert_array_equal(pt, np.asarray(pj))
        else:  # the separable bf16 bake: JAX's bar (test_neural_march.py)
            assert float((pt != np.asarray(pj)).mean()) < 5e-3
    plain, _ = tinf.predict_volume(tm, tp, case, exact=True, device="cpu")
    smooth, _ = tinf.predict_volume(tm, tp, case, exact=True,
                                    gaussian_sigma=1.0, device="cpu")
    assert (plain != smooth).any()  # the filter reached the model


# ------------------------------------------------------------------ nnU-Net
def test_nnunet_conversion_matches_jax(dataset, tmp_path):
    cases = tbrats.find_cases(dataset)
    env_t = tnn.setup_nnunet_env(tmp_path / "t")
    env_j = jnn.setup_nnunet_env(tmp_path / "j")
    dt = tnn.prepare_brats_dataset(cases, env_t["nnUNet_raw"], 501)
    dj = jnn.prepare_brats_dataset(cases, env_j["nnUNet_raw"], 501)
    assert (dt / "dataset.json").read_text() == \
        (dj / "dataset.json").read_text()
    meta = json.loads((dt / "dataset.json").read_text())
    assert meta["numTraining"] == 3 and meta["labels"]["ET"] == 3
    imgs = sorted(p.name for p in (dt / "imagesTr").iterdir())
    assert imgs == sorted(p.name for p in (dj / "imagesTr").iterdir())
    assert len(imgs) == 12 and imgs[0].endswith("_0000.nii.gz")
    assert all((dt / "imagesTr" / n).is_symlink() for n in imgs)
    for p in sorted((dt / "labelsTr").iterdir()):
        lab = tnifti.load(p).data
        assert set(np.unique(lab)) <= {0, 1, 2, 3}
        np.testing.assert_array_equal(
            lab, tnifti.load(dj / "labelsTr" / p.name).data)
    copied = tnn.prepare_brats_dataset(cases[:1], tmp_path / "c", 7, "X",
                                       use_symlinks=False)
    assert not any(p.is_symlink() for p in (copied / "imagesTr").iterdir())


def test_nnunet_gating_device_and_find_checkpoint(tmp_path):
    assert tnn.has_nnunet() == jnn.has_nnunet()
    if not tnn.has_nnunet():
        for call in (lambda: tnn.plan_and_preprocess(501),
                     lambda: tnn.run_training(501),
                     lambda: tnn.export_model(501, tmp_path / "m.zip")):
            with pytest.raises(RuntimeError, match="not installed"):
                call()
    assert tnn.select_device() == jnn.select_device()
    d = tmp_path / "Dataset501_X" / "nnUNetTrainer__nnUNetPlans__3d_fullres" \
        / "fold_0"
    d.mkdir(parents=True)
    (d / "checkpoint_final.pth").write_bytes(b"x")
    for kw in ({}, {"fold": 1}, {"plans_identifier": "Other"}):
        assert tnn.find_checkpoint(tmp_path, 501, **kw) == \
            jnn.find_checkpoint(tmp_path, 501, **kw)
    assert tnn.find_checkpoint(tmp_path, 501).name == "checkpoint_final.pth"
    assert tnn.find_checkpoint(tmp_path, 502) is None


def _fake_nnunet(monkeypatch, results):
    """A recording nnunetv2 in sys.modules, as tests/test_nnunet_mocked.py
    installs it."""
    calls = {}
    mods = {n: types.ModuleType(n) for n in (
        "nnunetv2", "nnunetv2.experiment_planning",
        "nnunetv2.experiment_planning.plan_and_preprocess_api",
        "nnunetv2.run", "nnunetv2.run.run_training",
        "nnunetv2.model_sharing", "nnunetv2.model_sharing.model_export")}
    api = mods["nnunetv2.experiment_planning.plan_and_preprocess_api"]
    api.extract_fingerprints = lambda ids, **kw: calls.update(
        fingerprint=(ids, kw))
    api.plan_experiments = lambda ids, **kw: calls.update(
        plan=(ids, kw)) or "nnUNetPlans"
    api.preprocess = lambda ids, **kw: calls.update(preprocess=(ids, kw))

    def run_training(dataset, configuration, fold, **kw):
        calls["train"] = ((dataset, configuration, fold), kw)
        d = (pathlib.Path(results) / "Dataset501_BraTS2023"
             / f"{kw['trainer_class_name']}__{kw['plans_identifier']}"
               f"__{configuration}" / f"fold_{fold}")
        d.mkdir(parents=True, exist_ok=True)
        (d / "checkpoint_final.pth").write_bytes(b"\x00")

    def export(dataset_id, out_path, **kw):
        calls["export"] = ((dataset_id, out_path), kw)
        pathlib.Path(out_path).write_bytes(b"\x00")

    mods["nnunetv2.run.run_training"].run_training = run_training
    mods["nnunetv2.model_sharing.model_export"].export_pretrained_model = \
        export
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return calls


def test_nnunet_pipeline_drives_the_api_as_jax(tmp_path, monkeypatch):
    data = tmp_path / "data"
    tsyn.write_synthetic_dataset(data, num_cases=2, shape=(12, 12, 10),
                                 seed=3)
    cases = sorted(p for p in data.iterdir() if p.is_dir())
    recorded = []
    for pkg, work in ((tnn, tmp_path / "t"), (jnn, tmp_path / "j")):
        calls = _fake_nnunet(monkeypatch, work / "nnUNet_results")
        ckpt = pkg.run_pipeline(cases, work, dataset_id=501,
                                dataset_name="BraTS2023", fold=0,
                                num_processes=4, device="cpu")
        assert ckpt is not None and ckpt.name == "checkpoint_final.pth"
        assert ckpt.relative_to(work) == pathlib.Path(
            "nnUNet_results/Dataset501_BraTS2023/"
            "nnUNetTrainer__nnUNetPlans__3d_fullres/fold_0/"
            "checkpoint_final.pth")
        (ds, _, _), kw = calls["train"]
        assert ds == "Dataset501_BraTS2023" and str(kw["device"]) == "cpu"
        calls["train"][1]["device"] = str(kw["device"])
        calls["export"] = ((calls["export"][0][0],
                            pathlib.Path(calls["export"][0][1]).name),
                           calls["export"][1])
        recorded.append(calls)
        arr = tnifti.load(next((work / "nnUNet_raw" / "Dataset501_BraTS2023"
                                / "labelsTr").iterdir())).data
        assert arr.max() <= 3
    assert recorded[0] == recorded[1]
    assert recorded[0]["fingerprint"] == ([501], {
        "check_dataset_integrity": False, "clean": True, "verbose": True})


# ------------------------------------------------------------------ native
requires_cxx = pytest.mark.skipif(shutil.which("g++") is None,
                                  reason="no C++ compiler to build "
                                         "libmri_io")


def _lib_for_jax(monkeypatch):
    """JAX's binding pointed at the library the port built, so both
    bindings run the same code."""
    assert tnative.available(), tnative.build_info()
    lib = ctypes.CDLL(tnative.build_info()["path"])
    lib.mri_gunzip.restype = ctypes.c_longlong
    lib.mri_nifti_to_f32.restype = ctypes.c_longlong
    lib.mri_bc4_decode.restype = ctypes.c_int
    lib.mri_load_batch.restype = ctypes.c_int
    monkeypatch.setattr(jnative, "_LIB", lib)


def _zscore_like_the_library(arr):
    """runtime/mri_io.cpp's mri_zscore_nonzero in NumPy: sums and sums of
    squares in double, in order; mean and std rounded to float32."""
    v = arr[arr != 0].astype(np.float64)
    if v.size == 0:
        return arr
    mu = np.cumsum(v)[-1] / v.size
    var = np.cumsum(v * v)[-1] / v.size - mu * mu
    sigma = np.float32(np.sqrt(max(var, 0.0))) + np.float32(1e-6)
    return (arr - np.float32(mu)) / sigma


@requires_cxx
def test_native_binding_matches_jax_and_python(tmp_path, monkeypatch):
    _lib_for_jax(monkeypatch)
    info = tnative.build_info()
    assert info["error"] is None and pathlib.Path(info["path"]).parts[-3:] \
        == ("build", "native", "libmri_io.so")
    payload = b"hello native runtime " * 100
    assert tnative.gunzip(gzip.compress(payload), 4096) == payload
    from mri_raytracer_tpu_torch.data import codecs as tcodecs
    img = np.random.default_rng(0).integers(0, 256, (8, 12), np.uint8)
    data = tcodecs.encode_bc4(img)
    np.testing.assert_array_equal(tnative.decode_bc4(data, 12, 8, 1),
                                  tcodecs.decode_bc4(data, 12, 8, 1))
    mods, _ = tsyn.synthetic_case((10, 12, 8), seed=5)
    paths = []
    for i in range(3):
        paths.append(tmp_path / f"v{i}.nii.gz")
        tnifti.save(paths[-1], mods[i])
    bad = tmp_path / "bad.nii.gz"
    bad.write_bytes(gzip.compress(b"not a nifti"))
    for zs in (True, False):
        got = tnative.load_nifti_batch(paths + [bad], zscore=zs,
                                       max_voxels=10 * 12 * 8, n_threads=2)
        want = jnative.load_nifti_batch(paths + [bad], zscore=zs,
                                        max_voxels=10 * 12 * 8, n_threads=2)
        assert got[-1] is None and want[-1] is None
        for i, ((vt, dt), (vj, dj)) in enumerate(zip(got[:-1], want[:-1])):
            assert dt == dj == (10, 12, 8)
            np.testing.assert_array_equal(vt, vj)
            raw = tnifti.load(paths[i]).data.astype(np.float32)
            if zs:
                np.testing.assert_array_equal(vt, _zscore_like_the_library(raw))
                np.testing.assert_allclose(
                    vt, tbrats.zscore_nonzero(raw.copy()), rtol=1e-4,
                    atol=1e-4)
            else:
                np.testing.assert_array_equal(vt, raw)


@requires_cxx
@pytest.mark.parametrize("kw", [{}, {"modalities": ["t1n", "t2w"]}])
def test_ramcache_native_path_bit_equal(dataset, monkeypatch, kw):
    _lib_for_jax(monkeypatch)
    cases = tbrats.find_cases(dataset)
    nat = tcache.RAMCache(cases, verbose=False, use_native=True, **kw)
    jnat = jcache.RAMCache(cases, verbose=False, use_native=True, **kw)
    py = tcache.RAMCache(cases, verbose=False, use_native=False, **kw)
    assert nat.n_modalities == (len(kw["modalities"]) if kw else 4)
    for a, b, c in zip(nat.cache, jnat.cache, py.cache):
        assert a["name"] == b["name"] == c["name"]
        np.testing.assert_array_equal(a["mods"], b["mods"])
        np.testing.assert_array_equal(a["seg"], b["seg"])
        np.testing.assert_array_equal(a["seg"], c["seg"])
        assert a["seg"].dtype == c["seg"].dtype == np.int16
        np.testing.assert_allclose(a["mods"], c["mods"], rtol=1e-4, atol=1e-4)
    # Another normalization takes the Python path, as in JAX.
    pct = tcache.RAMCache(cases, verbose=False, use_native=True,
                          normalization="percentile")
    np.testing.assert_array_equal(
        pct.cache[0]["mods"],
        tcache.RAMCache(cases, verbose=False, use_native=False,
                        normalization="percentile").cache[0]["mods"])


def test_native_fallback_reports_why(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tnative, "_STATE", {
        "tried": False, "lib": None, "error": None, "seconds": None,
        "built": False})
    monkeypatch.setattr(tnative, "LIB_PATH", tmp_path / "x" / "libmri_io.so")
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    assert not tnative.available()
    info = tnative.build_info()
    assert not info["available"] and "no-such-compiler-here" in info["error"]
    assert "no-such-compiler-here" in capsys.readouterr().err
    mods, _ = tsyn.synthetic_case((6, 6, 6), seed=1)
    p = tmp_path / "v.nii.gz"
    tnifti.save(p, mods[0])
    out = tnative.load_nifti_batch([p], zscore=False)
    np.testing.assert_allclose(out[0][0], mods[0], rtol=1e-5)
    assert tnative.gunzip(gzip.compress(b"abc"), 16) == b"abc"
