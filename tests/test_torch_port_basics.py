"""PyTorch port vs the JAX package: package isolation, devices, camera,
params, conversion, data helpers, samplers and the lockstep oracle.

Inputs are made with numpy and fed to both sides. Tolerances: bit-equality
for host numpy code (camera, data); 1e-6 for single samplers; 1e-4 for the
oracle (float32 transcendentals and ~100 compositing steps in a different
library)."""

import subprocess
import sys
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.data import brats as jbrats, synthetic as jsyn
from mri_raytracer_tpu.ops import raymarch_xla as jrx, trilinear as jtri
from mri_raytracer_tpu.render import params as jrp
from mri_raytracer_tpu.render.camera import OrbitalCamera as JCam
from mri_raytracer_tpu_torch import convert
from mri_raytracer_tpu_torch.apps import train_inr as train_app
from mri_raytracer_tpu_torch.config import TrainConfig
from mri_raytracer_tpu_torch.data import brats as tbrats, synthetic as tsyn
from mri_raytracer_tpu_torch.eval.metrics import psnr
from mri_raytracer_tpu_torch.ops import raymarch as trx, shearwarp as tsw
from mri_raytracer_tpu_torch.ops import trilinear as ttri
from mri_raytracer_tpu_torch.render import params as trp
from mri_raytracer_tpu_torch.render.brats import BratsRenderer
from mri_raytracer_tpu_torch.render.camera import OrbitalCamera as TCam
from mri_raytracer_tpu_torch.train.engine import train_inr

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (24, 24, 20)

PORT_MODULES = [
    "mri_raytracer_tpu_torch",
    "mri_raytracer_tpu_torch.env",
    "mri_raytracer_tpu_torch.config",
    "mri_raytracer_tpu_torch.convert",
    "mri_raytracer_tpu_torch.data.synthetic",
    "mri_raytracer_tpu_torch.data.brats",
    "mri_raytracer_tpu_torch.eval.metrics",
    "mri_raytracer_tpu_torch.eval.inference",
    "mri_raytracer_tpu_torch.io.checkpoint",
    "mri_raytracer_tpu_torch.models.features",
    "mri_raytracer_tpu_torch.models.mlp",
    "mri_raytracer_tpu_torch.models.api",
    "mri_raytracer_tpu_torch.ops.kernels",
    "mri_raytracer_tpu_torch.ops.trilinear",
    "mri_raytracer_tpu_torch.ops.raymarch",
    "mri_raytracer_tpu_torch.ops.shearwarp",
    "mri_raytracer_tpu_torch.ops.composite",
    "mri_raytracer_tpu_torch.ops.warp",
    "mri_raytracer_tpu_torch.ops.neural_march",
    "mri_raytracer_tpu_torch.render.params",
    "mri_raytracer_tpu_torch.render.camera",
    "mri_raytracer_tpu_torch.render.brats",
    "mri_raytracer_tpu_torch.render.presets",
    "mri_raytracer_tpu_torch.data.nifti",
    "mri_raytracer_tpu_torch.io.png",
    "mri_raytracer_tpu_torch.utils.arith",
    "mri_raytracer_tpu_torch.utils.profiling",
    "mri_raytracer_tpu_torch.apps.brats_app",
    "mri_raytracer_tpu_torch.apps.serve",
    "mri_raytracer_tpu_torch.losses",
    "mri_raytracer_tpu_torch.data.cache",
    "mri_raytracer_tpu_torch.data.pool",
    "mri_raytracer_tpu_torch.data.sampling",
    "mri_raytracer_tpu_torch.io.logging",
    "mri_raytracer_tpu_torch.io.dashboard",
    "mri_raytracer_tpu_torch.train.optimizers",
    "mri_raytracer_tpu_torch.train.steps",
    "mri_raytracer_tpu_torch.train.engine",
    "mri_raytracer_tpu_torch.apps.train_inr",
    "mri_raytracer_tpu_torch.ops.diffrender",
    "mri_raytracer_tpu_torch.ops.importance",
    "mri_raytracer_tpu_torch.ops.isosurface",
    "mri_raytracer_tpu_torch.train.fit_views",
    "mri_raytracer_tpu_torch.apps.fit_from_views",
    "mri_raytracer_tpu_torch.ops.roi_policy",
    "mri_raytracer_tpu_torch.eval.roi_protocol",
    "mri_raytracer_tpu_torch.apps.roi_policy_eval",
    "mri_raytracer_tpu_torch.data.codecs",
    "mri_raytracer_tpu_torch.render.volume",
    "mri_raytracer_tpu_torch.ops.sdf",
    "mri_raytracer_tpu_torch.ops.noise2d",
    "mri_raytracer_tpu_torch.render.mesh",
    "mri_raytracer_tpu_torch.render.hybrid",
    "mri_raytracer_tpu_torch.io.gif",
    "mri_raytracer_tpu_torch.apps.volume_app",
    "mri_raytracer_tpu_torch.apps.sdf_app",
    "mri_raytracer_tpu_torch.apps.noise_app",
    "mri_raytracer_tpu_torch.apps.mesh_app",
    "mri_raytracer_tpu_torch.apps.hybrid_app",
    "mri_raytracer_tpu_torch.data.manifest",
    "mri_raytracer_tpu_torch.data.slices",
    "mri_raytracer_tpu_torch.io.native",
    "mri_raytracer_tpu_torch.models.unet",
    "mri_raytracer_tpu_torch.train.unet_trainer",
    "mri_raytracer_tpu_torch.train.nnunet",
    "mri_raytracer_tpu_torch.parallel.mesh",
    "mri_raytracer_tpu_torch.parallel.training",
    "mri_raytracer_tpu_torch.parallel.render",
    "mri_raytracer_tpu_torch.render.widgets",
    "mri_raytracer_tpu_torch.apps.neural_psnr_cert",
    "mri_raytracer_tpu_torch.apps.bench_neural_march",
    "mri_raytracer_tpu_torch.apps.orbit_video",
    "mri_raytracer_tpu_torch.apps.demo_end_to_end",
    "mri_raytracer_tpu_torch.apps.full_geometry_smoke",
    "mri_raytracer_tpu_torch.apps.read_npz",
    "mri_raytracer_tpu_torch.apps.roi_report",
    "mri_raytracer_tpu_torch.apps.roi_showcase_figures",
    "mri_raytracer_tpu_torch.apps.bench_roi_overhead",
    "mri_raytracer_tpu_torch.apps.roi_retime",
    "mri_raytracer_tpu_torch.apps.roi_occupancy_bound",
]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module, and chip_smoke.py, imports cleanly in a fresh
    interpreter without pulling in jax or mri_raytracer_tpu; nor, the
    notebook viewers included, ipywidgets or IPython (``show()`` imports
    them)."""
    code = (
        "import importlib, sys, runpy\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"runpy.run_path({str(REPO / 'chip_smoke.py')!r}, run_name='x')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'mri_raytracer_tpu'\n"
        "       or m.startswith('mri_raytracer_tpu.')\n"
        "       or m.split('.')[0] in ('ipywidgets', 'IPython')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mods = np.zeros((4,) + SHAPE, np.float32)
    p = trp.default_render_params(SHAPE)
    basis = TCam(radius=2.0).basis()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BratsRenderer(mods)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trx.render_brats(mods, None, None, basis, p, 8, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsw.render_brats(mods, None, None, basis, p, 8, 8)
    # Training, through the engine and the CLI, before it touches data.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_inr(TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_app.main(["--steps", "1"])
    # The CPU stays available when asked for.
    assert BratsRenderer(mods, device="cpu", width=8, height=8).backend \
        == "sweep"


@pytest.mark.parametrize("theta,phi,ops", [
    (0.6, 1.2, ()), (0.0, 0.005, ()), (2.4, 3.1, ()),
    (0.3, 0.9, (("orbit", 0.4, -0.2), ("pan", 12.0, -7.0, 512),
                ("zoom", 0.7), ("fov", 40.0))),
])
def test_packed_camera_bit_equal(theta, phi, ops):
    kw = dict(radius=2.3, theta=theta, phi=phi)
    cams = [JCam(**kw), TCam(**kw)]
    for cam in cams:
        for op in ops:
            if op[0] == "orbit":
                cam.orbit(op[1], op[2])
            elif op[0] == "pan":
                cam.pan(op[1], op[2], op[3])
            elif op[0] == "zoom":
                cam.zoom(op[1])
            else:
                cam.set_fov_degrees(op[1])
    vj = cams[0].basis().pack()
    vt = cams[1].basis().pack().numpy()
    assert vj.dtype == vt.dtype == np.float32
    np.testing.assert_array_equal(vj, vt)
    # The packed JAX camera converts to the same port basis.
    back = convert.camera_from_packed(vj).pack().numpy()
    np.testing.assert_array_equal(back, vt)


def test_params_equal_and_convert():
    kw = dict(voxel_zooms=(1.0, 1.2, 0.9), step_size=0.03, show_pred=True,
              ww=0.8, wl=0.45, gamma=1.3, near=0.2, far=3.0,
              bg_color=(0.1, 0.2, 0.3))
    pj = jrp.default_render_params((40, 36, 30), **kw)
    pt = trp.default_render_params((40, 36, 30), **kw)
    for f in pt._fields:
        np.testing.assert_array_equal(np.asarray(getattr(pj, f)),
                                      getattr(pt, f).numpy(), err_msg=f)
    for leaves in (pj._asdict(), tuple(pj)):
        pc = convert.render_params_from_numpy(leaves, device="cpu")
        for f in pt._fields:
            np.testing.assert_array_equal(getattr(pc, f).numpy(),
                                          getattr(pt, f).numpy(), err_msg=f)
    assert jrp.default_camera_radius(pj, (40, 36, 30)) == \
        trp.default_camera_radius(pt, (40, 36, 30))
    with pytest.raises(ValueError):
        convert.render_params_from_numpy(tuple(pj)[:-1])


@pytest.mark.parametrize("shape,seed,nmod", [((24, 24, 20), 1, 4),
                                             ((17, 30, 9), 7, 2)])
def test_synthetic_and_normalize_bit_equal(shape, seed, nmod):
    mj, sj = jsyn.synthetic_case(shape, seed=seed, num_modalities=nmod)
    mt, st = tsyn.synthetic_case(shape, seed=seed, num_modalities=nmod)
    np.testing.assert_array_equal(mj, mt)
    np.testing.assert_array_equal(sj, st)
    assert sj.dtype == st.dtype
    for m in mj:
        np.testing.assert_array_equal(jbrats.percentile_normalize(m),
                                      tbrats.percentile_normalize(m))
    const = np.full((4, 4, 4), 3.0, np.float32)  # the b <= a guard
    np.testing.assert_array_equal(jbrats.percentile_normalize(const),
                                  tbrats.percentile_normalize(const))


def test_samplers_match_jax():
    rng = np.random.default_rng(3)
    vol = rng.random((9, 7, 8)).astype(np.float32)
    lab = rng.integers(0, 5, (9, 7, 8)).astype(np.int32)
    pts = (rng.random((50, 3)) * np.array([11, 9, 10]) - 1.0).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jtri.trilinear_sample_base(jnp.asarray(vol), jnp.asarray(pts))),
        ttri.trilinear_sample_base(torch.from_numpy(vol),
                                   torch.from_numpy(pts)).numpy(), atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(jtri.nearest_sample(jnp.asarray(lab), jnp.asarray(pts))),
        ttri.nearest_sample(torch.from_numpy(lab),
                            torch.from_numpy(pts)).numpy())


def test_psnr():
    a = np.zeros((4, 4, 3), np.float32)
    b = a + 0.1
    assert psnr(torch.from_numpy(a), b) == pytest.approx(20.0)
    assert psnr(a, a) == float("inf")


@pytest.fixture(scope="module")
def scene():
    mods, seg = jsyn.synthetic_case(SHAPE, seed=1)
    disp = np.stack([jbrats.percentile_normalize(m) for m in mods])
    return disp, seg.astype(np.int32)


@pytest.mark.parametrize("theta,phi,pred", [(0.7, 1.1, False),
                                            (0.0, 1.57, True),
                                            (4.2, 2.2, False)])
def test_oracle_matches_jax(scene, theta, phi, pred):
    disp, seg = scene
    kw = dict(show_seg=True, show_pred=pred, step_size=1.8 / 24)
    pj = jrp.default_render_params(SHAPE, **kw)
    pt = trp.default_render_params(SHAPE, **kw)
    cam = dict(radius=jrp.default_camera_radius(pj, SHAPE), theta=theta,
               phi=phi)
    pred_v = seg if pred else None
    img_j = np.asarray(jrx.render_brats(
        jnp.asarray(disp), jnp.asarray(seg),
        None if pred_v is None else jnp.asarray(pred_v), JCam(**cam).basis(),
        pj, 48, 40, max_steps=256))
    img_t = trx.render_brats(disp, seg, pred_v, TCam(**cam).basis(), pt, 48,
                             40, max_steps=256, device="cpu").numpy()
    assert img_t.shape == (40, 48, 3)
    np.testing.assert_allclose(img_t, img_j, atol=1e-4)
