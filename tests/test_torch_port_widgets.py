"""The port's notebook viewers (render/widgets.py) against the JAX
package, on the CPU.

Both sides get the same numpy inputs and, for the INRs, the same weights
(``convert.inr_params_from_numpy``). Tolerances:
  * ``window_level``/``overlay_labels``: 1e-7 (the same NumPy code);
  * ``SliceViewer``: 1e-6 (NumPy; the blend is a float32 tensordot);
  * ``HoldoutViewer``'s prediction: disagreement < 5e-3 of the voxels
    (tests/test_torch_port_neural.py's label bar: bf16 hidden states flip
    near-tie argmaxes); given JAX's prediction, report and image equal;
  * ``OrbitViewer.frame`` over the 'sweep' renderer: 3e-3 (the renderer
    bar of tests/test_torch_port_renderer.py).
That importing the viewers pulls in no ipywidgets is checked in a fresh
interpreter by tests/test_torch_port_basics.py's import test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.config import ModelConfig as JCfg
from mri_raytracer_tpu.data import brats as jbrats, synthetic as jsyn
from mri_raytracer_tpu.models.api import build_model as jbuild
from mri_raytracer_tpu.render import params as jrp, widgets as jw
from mri_raytracer_tpu.render.brats import BratsRenderer as JRenderer
from mri_raytracer_tpu.render.camera import OrbitalCamera as JCam
from mri_raytracer_tpu_torch import convert
from mri_raytracer_tpu_torch.eval import inference as tinf
from mri_raytracer_tpu_torch.render import params as trp, widgets as tw
from mri_raytracer_tpu_torch.render.brats import BratsRenderer
from mri_raytracer_tpu_torch.render.camera import OrbitalCamera as TCam

torch.set_num_threads(2)


def _disp(shape, seed):
    mods, seg = jsyn.synthetic_case(shape, seed=seed)
    return (np.stack([jbrats.percentile_normalize(m) for m in mods]),
            seg.astype(np.int32))


def _inr(cfg, seed=0):
    """(JAX model, params, port model, params) with equal weights."""
    jm = jbuild(cfg, num_modalities=4)
    jp = jm.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tm, tp = convert.inr_params_from_numpy(tree, dataclasses.asdict(cfg))
    return jm, jp, tm, tp


def _cams(shape, p, theta, phi):
    kw = dict(radius=jrp.default_camera_radius(p, shape), theta=theta,
              phi=phi)
    return JCam(**kw), TCam(**kw)


# ------------------------------------------------------------------ widgets
@pytest.mark.parametrize("seed,opacity", [(0, 1.0), (1, 0.37), (2, 1.9)])
def test_window_level_and_overlay_match_jax(seed, opacity):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-0.3, 1.4, (19, 23)).astype(np.float32)
    labels = rng.integers(-3, 12, (19, 23))  # < 0 and >= 8 are transparent
    for ww, wl in ((1.0, 0.5), (0.4, 0.7), (1e-9, 0.2)):
        np.testing.assert_allclose(tw.window_level(img, ww, wl),
                                   jw.window_level(img, ww, wl), atol=1e-7)
    gray = tw.window_level(img, 0.8, 0.45)
    for lab in (labels, None):
        np.testing.assert_allclose(
            tw.overlay_labels(gray, lab, opacity_scale=opacity),
            jw.overlay_labels(gray, lab, opacity_scale=opacity), atol=1e-7)


@pytest.fixture(scope="module")
def slice_case():
    """tests/test_apps.py's 16 x 16 x 12 synthetic case."""
    return _disp((16, 16, 12), 0)


@pytest.mark.parametrize("axis,index", [("axial", 6), ("coronal", 3),
                                        ("sagittal", 11)])
def test_slice_viewer_matches_jax(slice_case, axis, index):
    disp, seg = slice_case
    pred = np.roll(seg, 2, axis=0)
    tv = tw.SliceViewer(disp, seg=seg, pred=pred)
    jv = jw.SliceViewer(disp, seg=seg, pred=pred)
    for kw in (dict(weights=[1, 0.5, 0, 0], ww=0.8, wl=0.4),
               dict(show_seg=False, show_pred=True),
               dict(weights=[0, 0, 2, 1], show_pred=True, ww=1.3, wl=0.6)):
        got = tv.render_slice(axis, index, **kw)
        assert got.shape == jv.render_slice(axis, index, **kw).shape
        np.testing.assert_allclose(got, jv.render_slice(axis, index, **kw),
                                   atol=1e-6)
    multi = tv.render_multiview(0.3, weights=[1, 1, 0, 0], show_pred=True)
    np.testing.assert_allclose(
        multi, jv.render_multiview(0.3, weights=[1, 1, 0, 0],
                                   show_pred=True), atol=1e-6)
    assert multi.shape[1] > multi.shape[0]


def test_holdout_viewer_matches_jax(monkeypatch):
    mods, seg = jsyn.synthetic_case((12, 12, 10), seed=1)
    zsc = np.stack([jbrats.zscore_nonzero(m.copy()) for m in mods])
    cases = [{"mods": zsc, "seg": seg, "name": "syn0"}]
    jm, jp, tm, tp = _inr(JCfg(hidden_dims=(8,), fourier_freqs=1))
    jv = jw.HoldoutViewer(jm, jp, cases)
    tv = tw.HoldoutViewer(tm, tp, cases, device="cpu")
    calls = []
    real = tinf.predict_volume
    monkeypatch.setattr(tinf, "predict_volume",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    pred_t, pred_j = tv.prediction(0), jv.prediction(0)
    assert pred_t.shape == pred_j.shape == seg.shape
    assert np.mean(pred_t != pred_j) < 5e-3
    assert tv.prediction(0) is pred_t and len(calls) == 1  # cache hit
    # Given JAX's prediction, the report and the image are equal.
    tv._pred_cache[0] = pred_j
    for z in (0, 5, 9):
        rep_t, rep_j = tv.slice_report(0, z), jv.slice_report(0, z)
        assert rep_t.keys() == rep_j.keys()
        for k in rep_t:
            assert rep_t[k] == rep_j[k] or (np.isnan(rep_t[k])
                                            and np.isnan(rep_j[k]))
        img = tv.render(0, z)
        assert img.shape == (12, 24, 3)
        np.testing.assert_array_equal(img, jv.render(0, z))
    assert len(calls) == 1


@pytest.mark.parametrize("theta,phi", [(0.6, 1.2), (3.9, 2.0)])
def test_orbit_viewer_matches_jax(theta, phi):
    disp, seg = _disp((24, 24, 24), 3)
    shape = disp.shape[1:]
    pj = jrp.default_render_params(shape, show_seg=True)
    pt = trp.default_render_params(shape, show_seg=True)
    cj, ct = _cams(shape, pj, theta, phi)
    jv = jw.OrbitViewer(JRenderer(jnp.asarray(disp), jnp.asarray(seg), None,
                                  width=64, height=64, backend="sweep"),
                        pj, cj)
    tv = tw.OrbitViewer(BratsRenderer(disp, seg, None, width=64, height=64,
                                      backend="sweep", device="cpu"),
                        pt, ct)
    img = tv.frame()
    assert img.shape == (64, 64, 3) and img.min() >= 0 and img.max() <= 1
    np.testing.assert_allclose(img, jv.frame(), atol=3e-3)
    # The camera is live: moving it moves the frame.
    ct.orbit(0.4, 0.0)
    assert np.abs(tv.frame() - img).max() > 1e-2


def test_holdout_viewer_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tm, tp = _inr(JCfg(hidden_dims=(8,), fourier_freqs=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tw.HoldoutViewer(tm, tp, [])
