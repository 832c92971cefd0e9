"""The port's sharded renderers (``parallel/render.py``) and the two hooks
of ``sweep_composite`` they need (``out_cols``, ``term_gate``) against the
JAX package, on the CPU.

The renders run in 4 gloo ranks spawned once for the module
(``tests/torch_parallel_worker.py``, suite ``render``) on a 1 x 4 mesh;
JAX's run here on the root conftest's virtual CPU devices at space=4.
Tolerances: atol 2e-3 for every render, JAX's bar
(``tests/test_parallel.py``: a stripe's shifted b0 can flip a bf16
rounding, and a slab samples its last plane at the shader's clamp);
atol 3e-3 for the hooks alone, the bar of
``tests/test_torch_port_shearwarp.py``'s scan (bf16 resampling in two
libraries). Every rank of a render gets the same image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.data import brats as jbrats, synthetic as jsyn
from mri_raytracer_tpu.ops import shearwarp as jsw
from mri_raytracer_tpu.ops.raymarch_xla import blend_modalities
from mri_raytracer_tpu.parallel import mesh as jmesh, render as jrender
from mri_raytracer_tpu.render import params as jrp
from mri_raytracer_tpu.render.camera import OrbitalCamera as JCam
from mri_raytracer_tpu_torch.ops import shearwarp as tsw
from mri_raytracer_tpu_torch.render import params as trp
from mri_raytracer_tpu_torch.render.camera import OrbitalCamera as TCam
from torch_parallel_worker import Ranks

torch.set_num_threads(2)
# (shape, seed, theta, phi, screen size, out_res): tests/test_parallel.py's
# divisible stripe render, its non-divisible out_res (70 = 4 x 17.5) and
# its 64^3 volume at 128^2 at a near-diagonal pose.
STRIPES = {"s64": ((16, 16, 12), 2, 0.5, 1.1, 64, 64),
           "s70": ((16, 16, 12), 7, 0.9, 1.0, 64, 70),
           "s128": ((64, 64, 64), 11, 0.85, 0.85, 128, 128)}
SLAB_SHAPE, SLAB_SEED = (16, 16, 12), 4
THETAS = (0.5, 2.8)  # the second flips the sweep direction


def _display(shape, seed):
    mods, seg = jsyn.synthetic_case(shape, seed=seed)
    return (np.stack([jbrats.percentile_normalize(m) for m in mods]),
            seg.astype(np.int32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_parallel_render")
    inputs = {"slab/thetas": np.array(THETAS)}
    for case, (shape, seed, theta, phi, size, out_res) in STRIPES.items():
        inputs[f"{case}/mods"], inputs[f"{case}/seg"] = _display(shape, seed)
        inputs[f"{case}/pose"] = np.array([theta, phi, size, out_res])
    inputs["slab/mods"], inputs["slab/seg"] = _display(SLAB_SHAPE, SLAB_SEED)
    r = Ranks("render", tmp, inputs)
    yield r
    r.close()


def _same_on_every_rank(outs, key):
    for out in outs[1:]:
        np.testing.assert_array_equal(out[key], outs[0][key])


@pytest.mark.parametrize("case", sorted(STRIPES))
def test_stripe_render_matches_jax_and_one_device(ranks, case):
    shape, seed, theta, phi, size, out_res = STRIPES[case]
    mods, seg = _display(shape, seed)
    p = jrp.default_render_params(shape, show_seg=True)
    cam = JCam(radius=jrp.default_camera_radius(p, shape), theta=theta,
               phi=phi)
    render = jrender.build_sharded_renderer(
        jmesh.make_mesh(data=1, space=4), shape, size, size,
        out_res=out_res, has_seg=True)
    want = np.asarray(render(jnp.asarray(mods), jnp.asarray(seg), None,
                             cam.basis(), p))
    pt = trp.default_render_params(shape, show_seg=True)
    camt = TCam(radius=trp.default_camera_radius(pt, shape), theta=theta,
                phi=phi)
    single = tsw.render_brats(mods, seg, None, camt.basis(), pt, size, size,
                              out_res=out_res, device="cpu").numpy()
    outs = ranks.result()
    got = outs[0][f"{case}/img"]
    assert got.shape == (size, size, 3)
    np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_allclose(got, single, atol=2e-3)
    _same_on_every_rank(outs, f"{case}/img")


@pytest.mark.parametrize("theta", THETAS)
def test_slab_render_matches_jax_and_one_ungated_device(ranks, theta):
    """Slabs of the sweep axis over 'space', folded by the over operator,
    against JAX's volume-sharded renderer and the port's one-rank
    term_gate=False composite + warp."""
    mods, seg = _display(SLAB_SHAPE, SLAB_SEED)
    p = jrp.default_render_params(SLAB_SHAPE, show_seg=True)
    cam = JCam(radius=jrp.default_camera_radius(p, SLAB_SHAPE), theta=theta,
               phi=1.1)
    bv = jnp.asarray(cam.basis().pack())
    axis = jsw.dominant_axis(cam.basis())
    mixed = blend_modalities(jnp.asarray(mods), p.vol_enabled[:4],
                             p.vol_weight[:4])
    render = jrender.build_volume_sharded_renderer(
        jmesh.make_mesh(data=1, space=4), SLAB_SHAPE, 64, 64, axis,
        out_res=64, has_seg=True)
    want = np.asarray(render(jsw._perm_volume(mixed, axis),
                             jsw._perm_volume(jnp.asarray(seg), axis), bv,
                             p))
    outs = ranks.result()
    assert int(outs[0][f"slab/{theta}/axis"]) == axis
    got = outs[0][f"slab/{theta}/img"]
    np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_allclose(got, outs[0][f"slab/{theta}/single"],
                               atol=2e-3)
    _same_on_every_rank(outs, f"slab/{theta}/img")


def _scene(theta=0.7, phi=1.1, **kw):
    mods, seg = _display(SLAB_SHAPE, 3)
    out = []
    for rp, Cam, sw, arr, flags in (
            (jrp, JCam, jsw, jnp.asarray, (True, False)),
            (trp, TCam, tsw, torch.from_numpy, ())):
        p = rp.default_render_params(SLAB_SHAPE, show_seg=True, **kw)
        basis = Cam(radius=rp.default_camera_radius(p, SLAB_SHAPE),
                    theta=theta, phi=phi).basis()
        axis = sw.dominant_axis(basis)
        vols = sw.prepare_sweep_volumes(arr(mods), arr(seg), None, p, axis,
                                        *flags)
        geom = sw.sweep_geometry(basis, p, tuple(vols[0].shape), axis, 64)
        out.append((sw, vols, geom, p, axis))
    return out


def _stripe_geom(geom, j0, cols):
    return geom._replace(b0=geom.b0 + j0 * geom.db,
                         vmag=geom.vmag[:, j0:j0 + cols],
                         dt_map=geom.dt_map[:, j0:j0 + cols],
                         t_entry=geom.t_entry[:, j0:j0 + cols])


def test_out_cols_composites_a_column_stripe():
    """sweep_composite(out_cols=c) on a geometry shifted by j0 columns:
    the columns [j0, j0 + c) of the whole composite, and JAX's stripe."""
    j0, cols = 16, 24
    res = []
    for sw, vols, geom, p, axis in _scene():
        full = sw.sweep_composite(*vols, geom, p, axis, 64, 1)
        part = sw.sweep_composite(*vols, _stripe_geom(geom, j0, cols), p,
                                  axis, 64, 1, out_cols=cols)
        res.append([np.asarray(t) for t in full + part])
    (Cj, Tj, cj, tj), (Ct, Tt, ct, tt) = res
    assert ct.shape == (64, cols, 3) and tt.shape == (64, cols)
    np.testing.assert_allclose(ct, Ct[:, j0:j0 + cols], atol=3e-3)
    np.testing.assert_allclose(tt, Tt[:, j0:j0 + cols], atol=3e-3)
    np.testing.assert_allclose(ct, cj, atol=3e-3)
    np.testing.assert_allclose(tt, tj, atol=3e-3)


def test_term_gate_off_matches_jax():
    """term_gate=False against JAX's, on a scene dense enough that the
    gate ends rays (the two composites then differ)."""
    res = []
    for sw, vols, geom, p, axis in _scene(intensity_alpha=40.0):
        gated = sw.sweep_composite(*vols, geom, p, axis, 64, 1)
        open_ = sw.sweep_composite(*vols, geom, p, axis, 64, 1,
                                   term_gate=False)
        res.append([np.asarray(t) for t in gated + open_])
    (_, Tgj, Cj, Tj), (_, Tgt, Ct, Tt) = res
    np.testing.assert_allclose(Ct, Cj, atol=3e-3)
    np.testing.assert_allclose(Tt, Tj, atol=3e-3)
    # The gate was live: some rays stopped at T <= 0.01 with it and went
    # on past it without.
    assert (Tgt <= 0.01).any() and (Tt < Tgt).any()
