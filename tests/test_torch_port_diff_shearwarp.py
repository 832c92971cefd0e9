"""The port's differentiable shear-warp renderer (``composite='scan_remat'``)
against the JAX package on the CPU, at the scene of
``tests/test_diff_shearwarp.py`` (24 x 24 x 20 synthetic case, seed 2;
48 x 48 frames, out_res 64).

Tolerances:
  * the volume gradient of a probe-weighted frame against ``jax.grad`` of
    JAX's ``render_brats(composite='scan_remat')``: atol 2^-7 * max|g|, two
    bf16 ulps at the largest gradient, rtol 0. Both sides resample with
    bf16 operands and round the dots' cotangents through bf16 (a value
    near 0.02 has a 1.2e-4 ulp); measured 6.1e-5 to 1.2e-4 abs at three
    poses against max|g| 0.024-0.028 (1 ulp), with frames within 6e-5;
  * 'scan_remat' against the unchecked sweep ('scan', whose warp is the
    plain gather on the CPU): rtol 1e-4, atol 1e-6
    (tests/test_diff_shearwarp.py:68-69);
  * a directional finite difference within 2% (:45-59).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.data import brats as jbrats, synthetic as jsyn
from mri_raytracer_tpu.ops import shearwarp as jsw
from mri_raytracer_tpu.render import params as jrp
from mri_raytracer_tpu.render.camera import OrbitalCamera as JCam
from mri_raytracer_tpu_torch.ops import shearwarp as tsw
from mri_raytracer_tpu_torch.ops import warp as twarp
from mri_raytracer_tpu_torch.render import params as trp
from mri_raytracer_tpu_torch.render.camera import OrbitalCamera as TCam

torch.set_num_threads(2)
SHAPE = (24, 24, 20)
POSES = [(0.5, 1.2), (2.1, 1.0), (4.0, 0.7)]
PROBE = np.cos(np.arange(48.0))[None, :].astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    mods, _ = jsyn.synthetic_case(SHAPE, seed=2)
    disp = np.stack([jbrats.percentile_normalize(m) for m in mods]) \
        .astype(np.float32)
    jp = jrp.default_render_params(SHAPE, show_seg=False)
    tp = trp.default_render_params(SHAPE, show_seg=False)
    return disp, jp, tp, jrp.default_camera_radius(jp, SHAPE)


def _port_grad(disp, tp, basis, composite, axis=None):
    m = torch.tensor(disp, requires_grad=True)
    img = tsw.render_brats(m, None, None, basis, tp, 48, 48, out_res=64,
                           composite=composite, axis=axis, device="cpu")
    loss = (img[..., 0] * torch.from_numpy(PROBE)).sum()
    loss.backward()
    return float(loss.detach()), m.grad.numpy()


@pytest.fixture(scope="module")
def jax_grads(scene):
    """JAX's frame and volume gradient at each pose (jit, scan_remat)."""
    disp, jp, _, r = scene
    out = []
    for theta, phi in POSES:
        basis = JCam(radius=r, theta=theta, phi=phi).basis()

        def loss(m):
            img = jsw.render_brats(m, None, None, basis, jp, 48, 48,
                                   out_res=64, composite="scan_remat")
            return jnp.sum(img[..., 0] * PROBE), img

        (_, img), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jnp.asarray(disp))
        out.append((np.asarray(img), np.asarray(g)))
    return out


@pytest.mark.parametrize("pose", range(len(POSES)))
def test_scan_remat_grad_matches_jax(scene, jax_grads, pose):
    disp, _, tp, r = scene
    theta, phi = POSES[pose]
    basis = TCam(radius=r, theta=theta, phi=phi).basis()
    jimg, jg = jax_grads[pose]
    with torch.no_grad():
        img = tsw.render_brats(torch.tensor(disp), None, None, basis, tp, 48,
                               48, out_res=64, composite="scan_remat",
                               device="cpu")
    np.testing.assert_allclose(img.numpy(), jimg, rtol=0, atol=1e-4)
    _, g = _port_grad(disp, tp, basis, "scan_remat")
    assert float(np.abs(jg).max()) > 0
    np.testing.assert_allclose(g, jg, rtol=0,
                               atol=2.0 ** -7 * float(np.abs(jg).max()))


def test_clip_tie_gradient_matches_jax(scene, jax_grads):
    """wl 0.5 / ww 1.0: the value clip's input is exactly 0 wherever the
    resampled volume is 0, so jnp.clip hands half the gradient there. The
    port's gradient at zero-background voxels equals JAX's (torch.clamp
    would hand all of it: twice JAX's)."""
    disp, _, tp, r = scene
    assert float(tp.wl) == 0.5 and float(tp.ww) == 1.0
    bg = disp == 0.0
    assert bg.mean() > 0.5
    jg = jax_grads[0][1]
    _, g = _port_grad(disp, tp, TCam(radius=r, theta=POSES[0][0],
                                     phi=POSES[0][1]).basis(), "scan_remat")
    assert float(np.abs(jg[bg]).max()) > 1e-3  # the ties carry gradient
    np.testing.assert_allclose(g[bg], jg[bg], rtol=0,
                               atol=2.0 ** -7 * float(np.abs(jg).max()))


def test_remat_grads_match_plain_scan(scene):
    """'scan_remat' (per-plane torch.utils.checkpoint) computes the
    gradient of the unchecked sweep: remat changes memory, not math."""
    disp, _, tp, r = scene
    basis = TCam(radius=r, theta=0.5, phi=1.2).basis()
    l1, g1 = _port_grad(disp, tp, basis, "scan")
    l2, g2 = _port_grad(disp, tp, basis, "scan_remat")
    assert l1 == l2
    np.testing.assert_allclose(g2, g1, rtol=1e-4, atol=1e-6)


def test_grad_matches_directional_fd(scene):
    """The analytic gradient through the full sweep matches a directional
    finite difference (eps above the bf16 resample's quantization)."""
    disp, _, tp, r = scene
    basis = TCam(radius=r, theta=0.5, phi=1.2).basis()
    _, g = _port_grad(disp, tp, basis, "scan_remat")
    assert np.isfinite(g).all()
    assert float((np.abs(g) > 0).mean()) > 0.1, "gradient mostly dead"
    d = g / np.linalg.norm(g)
    eps = 0.3

    def loss(m):
        with torch.no_grad():
            img = tsw.render_brats(torch.tensor(m), None, None, basis, tp,
                                   48, 48, out_res=64, composite="scan_remat",
                                   device="cpu")
        return float((img[..., 0] * torch.from_numpy(PROBE)).sum())

    fd = (loss(disp + eps * d) - loss(disp - eps * d)) / (2 * eps)
    an = float(np.vdot(g, d))
    assert abs(fd - an) / max(abs(an), 1e-9) < 0.02, (fd, an)


def test_axis_override_matches_derived(scene):
    disp, _, tp, r = scene
    basis = TCam(radius=r, theta=0.5, phi=1.2).basis()
    ax = tsw.dominant_axis(basis)
    a = tsw.render_brats(disp, None, None, basis, tp, 48, 48, out_res=64,
                         composite="scan", device="cpu")
    b = tsw.render_brats(disp, None, None, basis, tp, 48, 48, out_res=64,
                         composite="scan", axis=ax, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_scan_remat_never_reaches_k2(scene, monkeypatch):
    """'scan_remat' warps with the plain gather on every device: K2's
    wrapper is not called."""
    disp, _, tp, r = scene

    def no_k2(*a, **kw):
        raise AssertionError("scan_remat reached warp_screen")

    monkeypatch.setattr(twarp, "warp_screen", no_k2)
    basis = TCam(radius=r, theta=2.1, phi=1.0).basis()
    _, g = _port_grad(disp, tp, basis, "scan_remat")
    assert np.abs(g).max() > 0
    with pytest.raises(AssertionError, match="reached warp_screen"):
        _port_grad(disp, tp, basis, "scan")
