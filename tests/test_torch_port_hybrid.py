"""The port's hybrid volume + mesh-shadow renderer (``render/hybrid.py``)
and its app against the JAX package on the CPU (mirrors
tests/test_hybrid.py). The same numpy volumes and masks go through both.

Tolerances:
  * ``_pool_any`` and ``extract_boundary_mesh`` (with ``downsample``, on
    non-cubic volumes, an empty mask): bit-equal;
  * ``render_hybrid`` with shadows and the mesh skip each on and off:
    1e-5 against jitted JAX (measured <= 6e-7 at 40^3, 48^2; the shadow
    and skip BVH passes hit the same pixels);
  * the app: each PNG frame within one 8-bit level of the JAX app's.
"""

import numpy as np
import pytest
import torch

from mri_raytracer_tpu.render import hybrid as jh
from mri_raytracer_tpu.render.camera import OrbitalCamera as JCam
from mri_raytracer_tpu_torch.render import hybrid as th
from mri_raytracer_tpu_torch.render.camera import OrbitalCamera as TCam

torch.set_num_threads(2)


def _ball(shape):
    """Fuzzy ball volume centred in ``shape`` (tests/test_hybrid.py)."""
    idx = np.indices(shape).astype(np.float32)
    c = ((np.array(shape, np.float32) - 1) / 2.0)[:, None, None, None]
    r = np.sqrt(((idx - c) ** 2).sum(0))
    return np.clip(1.0 - r / (0.42 * shape[0]), 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("shape,f", [((9, 9, 9), 3), ((13, 10, 7), 2),
                                     ((8, 8, 8), 1), ((5, 6, 7), 4)])
def test_pool_any_bit_equal(shape, f):
    rng = np.random.default_rng(sum(shape) + f)
    mask = rng.random(shape) < 0.2
    np.testing.assert_array_equal(th._pool_any(mask, f), jh._pool_any(mask, f))


@pytest.mark.parametrize("case", ["cube", "random", "noncubic", "downsample",
                                  "empty", "placed"])
def test_extract_boundary_mesh_bit_equal(case):
    rng = np.random.default_rng(7)
    kw = {}
    if case == "cube":
        mask = np.zeros((8, 8, 8), bool)
        mask[2:6, 2:6, 2:6] = True
    elif case == "random":
        mask = rng.random((11, 9, 10)) < 0.3
    elif case == "noncubic":
        mask = _ball((16, 14, 9)) > 0.3
    elif case == "downsample":
        mask = rng.random((13, 12, 11)) < 0.1
        kw = dict(downsample=3)
    elif case == "empty":
        mask = np.zeros((6, 6, 6), bool)
    else:
        mask = rng.random((7, 7, 7)) < 0.4
        kw = dict(vol_min=(-0.3, 0.1, 0.2), voxel_size=(0.1, 0.05, 0.2))
    vj, tj = jh.extract_boundary_mesh(mask, **kw)
    vt, tt = th.extract_boundary_mesh(mask, **kw)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(tt, tj)
    assert vt.dtype == vj.dtype and tt.dtype == tj.dtype
    if case == "cube":
        assert tt.shape[0] == 6 * 16 * 2 and vt.shape[0] == 5 ** 3 - 3 ** 3


@pytest.fixture(scope="module")
def renderers():
    """tests/test_hybrid.py's shadow scene: a 40^3 ball with an occluder
    slab between it and a +x light; and its skip scene: the occluder is
    the ball's bright core."""
    vol = _ball((40, 40, 40))
    slab = np.zeros(vol.shape, bool)
    slab[34:38, 8:32, 8:32] = True
    out = {}
    for name, mask, kw in (("slab", slab, dict(light_dir=(1.0, 0.0, 0.0))),
                           ("core", vol > 0.55, {})):
        out[name] = (jh.HybridRenderer(vol, mask, width=48, height=48,
                                       max_steps=64, **kw),
                     th.HybridRenderer(vol, mask, width=48, height=48,
                                       max_steps=64, device="cpu", **kw))
    return out


@pytest.mark.parametrize("scene,cam", [
    ("slab", dict(radius=3.0, theta=np.pi, phi=1.2)),
    ("core", dict(radius=3.0, theta=0.8, phi=0.9))])
@pytest.mark.parametrize("shadows,skip", [(True, True), (True, False),
                                          (False, True), (False, False)])
def test_render_hybrid_matches_jax(renderers, scene, cam, shadows, skip):
    jr, tr = renderers[scene]
    assert tr.n_tris == jr.n_tris
    want = jr.render_numpy(JCam(**cam).basis(), shadows=shadows,
                           mesh_skip=skip)
    got = tr.render_numpy(TCam(**cam).basis(), shadows=shadows,
                          mesh_skip=skip)
    assert float(want.max()) > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert ("shadow" in tr.last_stats) == shadows
    assert ("skip" in tr.last_stats) == skip


def test_port_shadow_darkens_far_side(renderers):
    """tests/test_hybrid.py::test_shadow_darkens_far_side on the port."""
    _, tr = renderers["slab"]
    basis = TCam(radius=3.0, theta=np.pi, phi=1.2).basis()
    on = tr.render_numpy(basis, shadows=True, mesh_skip=False)
    off = tr.render_numpy(basis, shadows=False, mesh_skip=False)
    assert np.all(on <= off + 1e-6) and (off - on).max() > 0.05


def test_render_hybrid_noncubic_matches_jax():
    """A non-cubic volume (the centred box of both the mesh and the march)
    with extra render options."""
    vol = _ball((36, 36, 26))
    mask = np.zeros(vol.shape, bool)
    mask[10:26, 10:26, 8:18] = True
    kw = dict(sigma=4.0, ambient=0.2, shadow_strength=0.9, bg=0.1)
    jr = jh.HybridRenderer(vol, mask, width=40, height=32, max_steps=48)
    tr = th.HybridRenderer(vol, mask, width=40, height=32, max_steps=48,
                           device="cpu")
    cam = dict(radius=2.6, theta=0.7, phi=1.1)
    want = jr.render_numpy(JCam(**cam).basis(), **kw)
    got = tr.render_numpy(TCam(**cam).basis(), **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    ns = tr.render_numpy(TCam(**cam).basis(), shadows=False, **kw)
    assert got.mean() < ns.mean() - 1e-4


def test_hybrid_app_matches_jax(tmp_path):
    from PIL import Image

    from mri_raytracer_tpu.apps import hybrid_app as japp
    from mri_raytracer_tpu_torch.apps import hybrid_app as tapp

    argv = ["--shape", "24,24,20", "--width", "32", "--height", "32",
            "--frames", "2", "--max-steps", "48", "--cpu"]
    assert japp.main(argv + ["--out", str(tmp_path / "j")]) == 0
    assert tapp.main(argv + ["--out", str(tmp_path / "t")]) == 0
    for k in range(2):
        a, b = (np.asarray(Image.open(tmp_path / d / f"frame_{k:04d}.png"),
                           np.int16) for d in ("j", "t"))
        assert int(np.abs(a - b).max()) <= 1


def test_hybrid_app_case_dir(tmp_path):
    """--case loads a NIfTI case directory through the port's load_case."""
    from mri_raytracer_tpu_torch.apps import hybrid_app as tapp
    from mri_raytracer_tpu_torch.data import synthetic as tsyn

    root = tsyn.write_synthetic_dataset(tmp_path / "d", num_cases=1,
                                        shape=(20, 20, 16))
    case = next(root.iterdir())
    assert tapp.main(["--case", str(case), "--width", "24", "--height",
                      "24", "--frames", "1", "--max-steps", "32",
                      "--no-skip", "--out", str(tmp_path / "o"),
                      "--cpu"]) == 0
    assert (tmp_path / "o" / "frame_0000.png").exists()


def test_hybrid_defaults_to_the_card(monkeypatch, tmp_path):
    from mri_raytracer_tpu_torch.apps import hybrid_app as tapp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp.main(["--frames", "1", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        th.HybridRenderer(_ball((8, 8, 8)), np.ones((8, 8, 8), bool))
    assert not list(tmp_path.glob("*.png"))
