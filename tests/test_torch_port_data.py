"""The port's data pipeline (caches, splits, device pool, samplers)
against the JAX package, on the CPU, with the 16 x 16 x 12 three-case
synthetic dataset of ``tests/test_training.py``.

The host code (splits, caches, boundary maps, the pool's case choice and
contents) and the deterministic part of sampling (indices in, batch out)
must be equal bit for bit. JAX's key streams cannot be reproduced in
torch, so the draws are held to the statistics ``tests/test_data.py``
asks of JAX's samplers.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.data import cache as jcache, pool as jpool, \
    sampling as jsamp, synthetic as jsyn
from mri_raytracer_tpu_torch.config import ModelConfig
from mri_raytracer_tpu_torch.data import brats as tbrats, cache as tcache, \
    pool as tpool, sampling as tsamp, synthetic as tsyn

torch.set_num_threads(2)
SHAPE = (16, 16, 12)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats_port_data")
    tsyn.write_synthetic_dataset(root, num_cases=3, shape=SHAPE, seed=3)
    return root


@pytest.fixture(scope="module")
def caches(dataset):
    cases = tbrats.find_cases(dataset)
    return (jcache.RAMCache(cases, verbose=False, use_native=False),
            tcache.RAMCache(cases, verbose=False, use_native=False))


def test_synthetic_dataset_files_equal(dataset, tmp_path):
    jsyn.write_synthetic_dataset(tmp_path, num_cases=3, shape=SHAPE, seed=3)
    for f in sorted(pathlib.Path(dataset).rglob("*.nii.gz")):
        other = tmp_path / f.relative_to(dataset)
        assert tbrats.nifti.load(f).data.tobytes() == \
            tbrats.nifti.load(other).data.tobytes(), f.name


@pytest.mark.parametrize("folds,fold,seed", [(3, 0, 0), (3, 2, 5),
                                             (2, 1, 1), (5, 4, 9)])
def test_kfold_split_and_split_files_equal(tmp_path, folds, fold, seed):
    cases = [pathlib.Path(f"/d/BraTS-{i:05d}") for i in range(11)]
    tj = jcache.kfold_split(cases, folds, fold, seed)
    tt = tcache.kfold_split(cases, folds, fold, seed)
    assert tt == tj
    jcache.save_splits(tmp_path / "j", *tj)
    tcache.save_splits(tmp_path / "t", *tt)
    for name in ("train.txt", "val.txt"):
        assert (tmp_path / "t" / name).read_text() == \
            (tmp_path / "j" / name).read_text()
    assert tcache.load_splits(tmp_path / "j") == \
        jcache.load_splits(tmp_path / "t")
    with pytest.raises(ValueError, match="out of range"):
        tcache.kfold_split(cases, folds, folds, seed)


def test_ram_cache_equal(caches):
    cj, ct = caches
    assert ct.n_cases == cj.n_cases == 3
    assert ct.vol_shape == cj.vol_shape and ct.n_modalities == 4
    for a, b in zip(ct.stacked(), cj.stacked()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for i in range(3):
        assert ct.get(i)["name"] == cj.get(i)["name"]
    rng = np.random.default_rng(0)
    idx = [rng.integers(0, n, 50) for n in (3,) + SHAPE]
    for a, b in zip(ct.sample_voxels(*idx), cj.sample_voxels(*idx)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_lru_chunked_and_train_val_caches_equal(dataset):
    cases = tbrats.find_cases(dataset)
    lj, lt = jcache.CaseLRU(cases, capacity=2), tcache.CaseLRU(cases,
                                                               capacity=2)
    for i in (0, 1, 2, 0):
        np.testing.assert_array_equal(lt.get(i)["mods"], lj.get(i)["mods"])
    assert list(lt._cache) == list(lj._cache) == [2, 0]
    kj = jcache.ChunkedCache(cases, chunk_cases=2, seed=4)
    kt = tcache.ChunkedCache(cases, chunk_cases=2, seed=4)
    for _ in range(2):
        for a, b in zip(kt.cache, kj.cache):
            assert a["name"] == b["name"]
            np.testing.assert_array_equal(a["boundary"], b["boundary"])
        kj.next_chunk()
        kt.next_chunk()
    tj, vj, ij = jcache.build_train_val_caches(dataset, 3, 3, 1, 0,
                                               verbose=False,
                                               use_native=False)
    tt, vt, it = tcache.build_train_val_caches(dataset, 3, 3, 1, 0,
                                               verbose=False,
                                               use_native=False)
    assert it == ij
    np.testing.assert_array_equal(tt.stacked()[0], tj.stacked()[0])
    np.testing.assert_array_equal(vt.stacked()[1], vj.stacked()[1])


def test_boundary_map_equal(caches):
    cj, _ = caches
    segs = [cj.get(i)["seg"] for i in range(3)]
    segs += [np.zeros((5, 6, 7), np.int16), np.ones((5, 6, 7), np.int16)]
    for seg in segs:
        bt = tcache.ChunkedCache.boundary_map(seg)
        assert bt.dtype == np.float32
        np.testing.assert_array_equal(
            bt, jcache.ChunkedCache.boundary_map(seg))


@pytest.mark.parametrize("pool_size,seed", [(2, 0), (3, 7), (5, 1)])
def test_device_pool_equal(caches, pool_size, seed):
    cj, ct = caches
    for i in range(3):
        for c in (cj, ct):
            c.get(i)["boundary"] = jcache.ChunkedCache.boundary_map(
                c.get(i)["seg"])
    pj = jpool.DevicePool(cj, pool_size, seed=seed, with_boundary=True)
    pt = tpool.DevicePool(ct, pool_size, seed=seed, device="cpu",
                          with_boundary=True)
    for _ in range(3):  # the refresh sequence picks the same cases too
        assert pt.shape == pj.shape
        assert pt.mods.dtype == torch.float32 and pt.segs.dtype == \
            torch.int32
        for a, b in ((pt.mods, pj.mods), (pt.segs, pj.segs),
                     (pt.boundary, pj.boundary)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        pj.maybe_refresh(4, 2)
        pt.maybe_refresh(4, 2)
    before = pt.mods.clone()
    pt.maybe_refresh(3, 2)  # not a refresh step
    assert torch.equal(before, pt.mods)


@pytest.fixture(scope="module")
def pools(caches):
    cj, ct = caches
    pj = jpool.DevicePool(cj, 2, seed=0)
    pt = tpool.DevicePool(ct, 2, seed=0, device="cpu")
    return pj, pt


def test_gather_and_normalize_exact(pools):
    pj, pt = pools
    rng = np.random.default_rng(11)
    ci, ix, iy, iz = (rng.integers(0, n, 300) for n in (2,) + SHAPE)
    ij, lj = jsamp.gather_pool(pj.mods, pj.segs, *(jnp.asarray(a) for a in
                                                   (ci, ix, iy, iz)))
    it, lt = tsamp.gather_pool(pt.mods, pt.segs, *(torch.from_numpy(a) for a
                                                   in (ci, ix, iy, iz)))
    assert tuple(it.shape) == (300, 4) and lt.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(
        tsamp._normalize(*(torch.from_numpy(a) for a in (ix, iy, iz)),
                         SHAPE).numpy(),
        np.asarray(jsamp._normalize(*(jnp.asarray(a) for a in (ix, iy, iz)),
                                    SHAPE)))


def _hybrid_model():
    cfg = ModelConfig(kind="coord_injection", hidden_dims=(16, 16, 16, 16),
                      fourier_freqs=2, dropout=0.3)
    from mri_raytracer_tpu_torch.models.api import build_model
    model = build_model(cfg, 4)
    return model, model.init(torch.Generator().manual_seed(0))


def test_sampler_statistics(pools):
    """tests/test_data.py's checks of the samplers, on the port's."""
    _, p = pools
    g = torch.Generator().manual_seed(0)
    b = tsamp.sample_uniform(g, p.mods, p.segs, 64)
    assert b.coords.shape == (64, 3) and b.intensities.shape == (64, 4)
    assert b.labels.shape == (64,) and b.labels.dtype == torch.int32
    assert float(b.coords.min()) >= -1.0 and float(b.coords.max()) <= 1.0
    torch.testing.assert_close(b.weights, torch.ones(64))
    bt = tsamp.sample_tumor_biased(g, p.mods, p.segs, 64, tumor_ratio=0.5,
                                   oversample=16)
    assert int((bt.labels > 0).sum()) >= 16
    bb = tsamp.sample_class_balanced(g, p.mods, p.segs, 64, (4, 4, 4),
                                     oversample=256)
    for cls in (2, 3):
        assert int((bb.labels == cls).sum()) >= 2
    assert int((bb.labels == 1).sum()) >= 1
    with pytest.raises(ValueError, match="> batch"):
        tsamp.sample_class_balanced(g, p.mods, p.segs, 8, (4, 4, 4))
    bh = tsamp.sample_hybrid(g, p.mods, p.segs, 64)
    assert bh.coords.shape[0] == 64
    # Every draw is the generator's: the same seed gives the same batch.
    again = tsamp.sample_uniform(torch.Generator().manual_seed(0), p.mods,
                                 p.segs, 64)
    torch.testing.assert_close(again.coords, b.coords, rtol=0, atol=0)
    # Each sample's label and intensities are the pool's at its voxel.
    idx = np.round((bt.coords.numpy() + 1.0) / 2.0
                   * (np.array(SHAPE) - 1)).astype(int)
    for n in range(64):
        hits = [c for c in range(2) if np.array_equal(
            p.mods[c, :, idx[n, 0], idx[n, 1], idx[n, 2]].numpy(),
            bt.intensities[n].numpy())]
        assert any(int(p.segs[c, idx[n, 0], idx[n, 1], idx[n, 2]])
                   == int(bt.labels[n]) for c in hits)


@pytest.mark.parametrize("kind", ["uniform", "tumor", "balanced", "hybrid"])
def test_boundary_weights_for_every_sample(caches, kind):
    """As tests/test_data.py: every sampler, and every hybrid sub-batch,
    gathers the boundary map at the sampled voxel."""
    _, ct = caches
    for i in range(ct.n_cases):
        ct.get(i)["boundary"] = tcache.ChunkedCache.boundary_map(
            ct.get(i)["seg"])
    p = tpool.DevicePool(ct, 2, seed=0, device="cpu", with_boundary=True)
    model, params = _hybrid_model()
    fn = tsamp.make_sampler(kind, 64, 0.5, (4, 4, 4), model=model)
    b = fn(torch.Generator().manual_seed(3), p.mods, p.segs, params,
           p.boundary)
    idx = np.round((b.coords.numpy() + 1.0) / 2.0
                   * (np.array(SHAPE) - 1)).astype(int)
    w = b.weights.numpy()
    assert w.shape == (64,) and not np.allclose(w, 1.0)
    bp = p.boundary.numpy()
    for n in range(64):
        vals = bp[:, idx[n, 0], idx[n, 1], idx[n, 2]]
        assert np.any(np.isclose(w[n], vals, atol=1e-6)), (n, w[n], vals)


def test_hybrid_scores_by_model_entropy(pools):
    """With a model, the uncertainty half is the top-entropy candidates:
    its samples' MC-dropout entropy beats the uniform tail's on average."""
    _, p = pools
    model, params = _hybrid_model()
    with torch.no_grad():
        params[-1].b += torch.tensor([3.0, 0.0, 0.0, 0.0])
    fn = tsamp.make_sampler("hybrid", 400, model=model)
    b = fn(torch.Generator().manual_seed(5), p.mods, p.segs, params)
    ent = tsamp.mc_dropout_entropy(model, params, b.coords, b.intensities,
                                   torch.Generator().manual_seed(1), 16)
    assert not ent.requires_grad
    assert float(ent[:200].mean()) > float(ent[320:].mean())
    with pytest.raises(ValueError, match="unknown sampler"):
        tsamp.make_sampler("nope", 4)


def test_sample_batch_host(caches):
    _, ct = caches
    b = tsamp.sample_batch_host(torch.Generator().manual_seed(0), 16, ct,
                                ct.vol_shape)
    assert b.intensities.shape == (16, 4) and b.labels.dtype == torch.int32
    idx = np.round((b.coords.numpy() + 1.0) / 2.0
                   * (np.array(SHAPE) - 1)).astype(int)
    mods, _ = ct.stacked()
    for n in range(16):
        assert any(np.array_equal(mods[c, :, idx[n, 0], idx[n, 1],
                                       idx[n, 2]], b.intensities[n].numpy())
                   for c in range(3))

