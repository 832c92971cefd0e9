"""The port's neural march (ops/neural_march.py) and K1b's plain version
against the JAX package, on the CPU.

Both sides get the same numpy scene, the same INR weights (converted by
``convert.inr_params_from_numpy``) and, where a comparison is about one
stage, the same geometry and field. Tolerances, each the JAX package's own
bar for the same comparison:
  * the separable first layer: atol/rtol 2e-4 (tests/test_neural_march.py:111);
  * predicted labels (``predict_field``, ``bake_labels``, K3's plain
    version through ``mlp_block``): mismatch fraction < 5e-3
    (tests/test_neural_march.py:248) — bf16 hidden states flip near-tie
    argmaxes;
  * K1b's plain version vs the Pallas kernel in interpret mode: atol 3e-3
    (PR 1's K1 bar: Pallas rounds its a-axis hat weights to bf16);
  * the scan frame vs JAX's with geom and field injected: atol 3e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.config import ModelConfig as JCfg
from mri_raytracer_tpu.data import brats as jbrats, synthetic as jsyn
from mri_raytracer_tpu.eval.inference import _predict_labels as j_predict
from mri_raytracer_tpu.models.api import build_model as jbuild
from mri_raytracer_tpu.ops import neural_march as jnm, shearwarp as jsw
from mri_raytracer_tpu.ops.pallas_composite import sweep_composite_pallas
from mri_raytracer_tpu.render import params as jrp
from mri_raytracer_tpu.render.camera import OrbitalCamera as JCam
from mri_raytracer_tpu_torch import convert
from mri_raytracer_tpu_torch.config import ModelConfig as TCfg
from mri_raytracer_tpu_torch.eval import inference as tinf
from mri_raytracer_tpu_torch.eval.metrics import psnr
from mri_raytracer_tpu_torch.models import features as tfeat
from mri_raytracer_tpu_torch.models.api import build_model as tbuild
from mri_raytracer_tpu_torch.ops import composite, neural_march as tnm
from mri_raytracer_tpu_torch.ops import shearwarp as tsw
from mri_raytracer_tpu_torch.render import params as trp
from mri_raytracer_tpu_torch.render.camera import OrbitalCamera as TCam
from mri_raytracer_tpu_torch.utils import profiling

torch.set_num_threads(2)
SHAPE = (24, 24, 20)
O, S = 128, 2
W = H = 96


@pytest.fixture(scope="module")
def scene():
    mods, seg = jsyn.synthetic_case(SHAPE, seed=2)
    disp = np.stack([jbrats.percentile_normalize(m) for m in mods])
    zsc = np.stack([jbrats.zscore_nonzero(m.copy()) for m in mods])
    return disp, zsc, seg.astype(np.int32)


def _models(cfg, seed=3, nudge=True):
    """(JAX model, JAX params, port model, port params) with the same
    weights; the logit bias nudged so several classes appear
    (tests/test_neural_march.py:176)."""
    jm = jbuild(cfg, num_modalities=4)
    jp = jm.init(jax.random.PRNGKey(seed))
    if nudge:
        jp[-1]["b"] = jp[-1]["b"] + jnp.array([0.0, 0.4, 0.5, 0.45])
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tm, tp = convert.inr_params_from_numpy(tree, dataclasses.asdict(cfg))
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def inr():
    return _models(JCfg(hidden_dims=(16, 16), fourier_freqs=4))


def _geom_t(g):
    """The port's SweepGeom holding the JAX geometry's values."""
    return tsw.SweepGeom(*(torch.as_tensor(np.array(x)) for x in g))


def _frame(scene, theta, phi, crop=False, **pkw):
    """Both packages' prepared volumes and one geometry (JAX's, copied)
    at a pose; ``crop``: a k slab plus an in-plane crop."""
    disp, zsc, seg = scene
    kw = dict(show_seg=True, show_pred=True, **pkw)
    pj = jrp.default_render_params(SHAPE, **kw)
    pt = trp.default_render_params(SHAPE, **kw)
    cam = dict(radius=jrp.default_camera_radius(pj, SHAPE), theta=theta,
               phi=phi)
    bj, bt = JCam(**cam).basis(), TCam(**cam).basis()
    axis = jsw.dominant_axis(bj)
    mj = jsw._perm_volume(jsw.blend_modalities(
        jnp.asarray(disp), pj.vol_enabled, pj.vol_weight), axis)
    mzj = jnp.stack([jsw._perm_volume(jnp.asarray(z), axis) for z in zsc])
    sj = jsw._perm_volume(jnp.asarray(seg), axis)
    crop_kw = {}
    if crop:
        nk, na, nb = mj.shape
        mj, sj = mj[3:nk - 5, 4:na - 2, 2:nb - 6], sj[3:nk - 5, 4:na - 2,
                                                      2:nb - 6]
        mzj = mzj[:, 3:nk - 5, 4:na - 2, 2:nb - 6]
        crop_kw = dict(z_offset=3, nk_global=nk, ab_offset=(4, 2),
                       inplane_global=(na, nb))
    gj = jsw.content_geometry(bj, pj, mj.shape, axis, O, W, H, **crop_kw)
    t = lambda a: torch.from_numpy(np.array(a))
    return dict(pj=pj, pt=pt, bj=bj, bt=bt, axis=axis, gj=gj, gt=_geom_t(gj),
                mj=mj, mzj=mzj, sj=sj, mt=t(mj), mzt=t(mzj), st=t(sj),
                z_offset=crop_kw.get("z_offset"),
                nk_global=crop_kw.get("nk_global"))


# tests/test_neural_march.py:80-112, both packages on one input
@pytest.mark.parametrize("inv_order", [(0, 1, 2), (1, 0, 2), (1, 2, 0)])
def test_separable_first_layer_matches_jax_and_dense(inv_order):
    K, M, Om = 4, 4, 9
    rng = np.random.default_rng(0)
    cfg = JCfg(hidden_dims=(16,), fourier_freqs=K)
    _, jp, _, tp = _models(cfg, seed=0, nudge=False)
    pos_an = rng.uniform(-1, 1, Om).astype(np.float32)
    pos_bn = rng.uniform(-1, 1, Om).astype(np.float32)
    z_n = np.float32(0.37)
    intens = rng.normal(0, 1, (Om, Om, M)).astype(np.float32)
    outs_j = jnm._separable_first_layer(jp, K, M, jnp.asarray(pos_an),
                                        jnp.asarray(pos_bn), jnp.float32(z_n),
                                        inv_order, Om)
    outs_t = tnm._separable_first_layer(tp, K, M, torch.from_numpy(pos_an),
                                        torch.from_numpy(pos_bn), z_n,
                                        inv_order, Om)
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=2e-4, atol=2e-4)
    # The port's rank-1 decomposition equals its dense first layer.
    row, col, const, W1_int = (t.detach() for t in outs_t)
    h_fast = row[:, None] + col[None, :] + const \
        + torch.from_numpy(intens) @ W1_int
    perm = (torch.full((Om, Om), float(z_n)),
            torch.from_numpy(pos_an)[:, None].expand(Om, Om),
            torch.from_numpy(pos_bn)[None, :].expand(Om, Om))
    xyz = torch.stack([perm[o] for o in inv_order], -1).reshape(-1, 3)
    x = tfeat.build_input(xyz, torch.from_numpy(intens).reshape(-1, M), K)
    h_ref = (x @ tp[0].W + tp[0].b).detach().reshape(Om, Om, 16)
    np.testing.assert_allclose(h_fast.numpy(), h_ref.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("theta,phi,kstride,crop", [
    (0.8, 1.1, 1, False), (0.8, 1.1, 2, False), (2.1, 0.5, 1, True),
    (4.0, 1.9, 3, True)])
def test_predict_field_matches_jax(scene, inr, theta, phi, kstride, crop):
    jm, jp, tm, tp = inr
    f = _frame(scene, theta, phi, crop)
    zoff = f["z_offset"]
    fj = np.asarray(jnm.predict_field(
        jm, jp, f["mzj"], f["gj"], f["pj"], f["axis"], O, S,
        z_offset=None if zoff is None else float(zoff),
        nk_global=f["nk_global"], block=8, kstride=kstride))
    ft = tnm.predict_field(tm, tp, f["mzt"], f["gt"], f["pt"], f["axis"], O,
                           S, z_offset=zoff, nk_global=f["nk_global"],
                           block=8, kstride=kstride)
    assert ft.dtype == torch.int32 and ft.shape == fj.shape
    assert fj.shape[0] == -(-(f["mt"].shape[0] + 1) // kstride)
    assert len(np.unique(fj)) >= 3  # several classes: a real comparison
    assert np.mean(ft.numpy() != fj) < 5e-3


def test_bake_labels_and_generic_path_match_jax(scene, inr):
    _, zsc, seg = scene
    jm, jp, tm, tp = inr
    baked_j = np.asarray(jnm.bake_labels(jm, jp, jnp.asarray(zsc)))
    baked_t = tnm.bake_labels(tm, tp, torch.from_numpy(zsc))
    assert baked_t.dtype == torch.int32 and baked_t.shape == zsc.shape[1:]
    assert np.mean(baked_t.numpy() != baked_j) < 5e-3
    gen_j = np.asarray(j_predict(jm, jp, jnp.asarray(zsc)))
    gen_t = tinf._predict_labels(tm, tp, torch.from_numpy(zsc), chunk=4096)
    assert gen_t.dtype == torch.int16
    assert np.mean(gen_t.numpy() != gen_j) < 5e-3
    pred, true = tinf.predict_volume(tm, tp, {"mods": zsc, "seg": seg},
                                     device="cpu")
    np.testing.assert_array_equal(pred, baked_t.numpy())
    np.testing.assert_array_equal(true, seg)
    # Non-separable models fall back to the generic float32 path.
    sj_m, sj_p, st_m, st_p = _models(JCfg(kind="siren", hidden_dims=(16,)),
                                     seed=4, nudge=False)
    assert not tnm.model_is_separable(st_m) and tnm.model_is_separable(tm)
    np.testing.assert_array_equal(
        tnm.bake_labels(st_m, st_p, torch.from_numpy(zsc)).numpy(),
        tinf._predict_labels(st_m, st_p, torch.from_numpy(zsc)).numpy())
    ref_s = np.asarray(j_predict(sj_m, sj_p, jnp.asarray(zsc)))
    assert np.mean(tnm.bake_labels(st_m, st_p, torch.from_numpy(zsc))
                   .numpy() != ref_s) < 5e-3


def _jax_block_labels(jp, K, intens, a_n, b_n, k_n, inv_order):
    """The JAX package's labels of one block of planes: predict_field's
    block_fn after its resample (neural_march.py:266-276)."""
    M = intens.shape[-1]
    row, col, const, W1_int = jnm._separable_first_layer_batched(
        jp, K, M, jnp.asarray(a_n), jnp.asarray(b_n), jnp.asarray(k_n),
        inv_order)
    h = jax.nn.relu(row[:, :, None, :] + col[:, None, :, :]
                    + const[:, None, None, :]
                    + jnp.dot(jnp.asarray(intens).astype(jnp.bfloat16),
                              W1_int.astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32)
                    ).astype(jnp.bfloat16)
    logits = jnm._mlp_tail(jp, h.reshape(-1, h.shape[-1]))
    return np.asarray(jnp.argmax(logits, -1)).reshape(intens.shape[:3])


# K3's plain version (what the wrapper runs for CPU tensors) against the
# JAX package at the widths of the reference's [16]x4 .. [256]x4: one block
# of 5 planes (not a multiple of the 16-plane block nor of K3's tiles) with
# rows and columns of different counts, and the voxel bake over 21 slices.
@pytest.mark.parametrize("width", [16, 64, 128, 256])
def test_mlp_block_plain_matches_jax(width):
    K, B, Oa, Ob = 6, 5, 20, 12
    jm, jp, tm, tp = _models(JCfg(hidden_dims=(width,) * 4, fourier_freqs=K),
                             seed=width)
    rng = np.random.default_rng(width)
    full = rng.normal(0, 1, (4, B, Oa, Ob)).astype(np.float32)
    a_n, b_n, k_n = (rng.uniform(-1, 1, shape).astype(np.float32)
                     for shape in ((B, Oa), (B, Ob), (B,)))
    inv_order = (1, 2, 0)
    want = _jax_block_labels(jp, K, np.moveaxis(full, 0, -1), a_n, b_n, k_n,
                             inv_order)
    got = tnm.mlp_block(tm, tp, torch.from_numpy(full).permute(1, 2, 3, 0),
                        torch.from_numpy(a_n), torch.from_numpy(b_n),
                        torch.from_numpy(k_n), inv_order)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, Oa, Ob)
    assert len(np.unique(want)) >= 2
    assert np.mean(got.numpy() != want) < 5e-3
    out = torch.full((B, Oa, Ob), -1, dtype=torch.int32)
    assert tnm.mlp_block(tm, tp, torch.from_numpy(full).permute(1, 2, 3, 0),
                         torch.from_numpy(a_n), torch.from_numpy(b_n),
                         torch.from_numpy(k_n), inv_order, out=out) is out
    assert torch.equal(out, got)


@pytest.mark.parametrize("width", [16, 64, 128, 256])
def test_bake_labels_matches_jax_by_width(width):
    jm, jp, tm, tp = _models(JCfg(hidden_dims=(width,) * 4, fourier_freqs=6),
                             seed=width + 1)
    modsz = np.random.default_rng(width).normal(
        0, 1, (4, 21, 18, 14)).astype(np.float32)
    baked_j = np.asarray(jnm.bake_labels(jm, jp, jnp.asarray(modsz)))
    baked_t = tnm.bake_labels(tm, tp, torch.from_numpy(modsz))
    assert baked_t.dtype == torch.int32 and baked_t.shape == modsz.shape[1:]
    assert len(np.unique(baked_j)) >= 2
    assert np.mean(baked_t.numpy() != baked_j) < 5e-3


def test_separable_mlp_checks():
    """The wrapper refuses what neither K3 nor its plain version takes on
    every device, and what K3 does not take before it looks for a card:
    meta tensors reach the kernel's checks without one."""
    _, _, tm, tp = _models(JCfg(hidden_dims=(32, 32), fourier_freqs=2))
    K, B, Oa, Ob = 2, 2, 3, 5
    x = torch.zeros((B, Oa, Ob, 4))
    a_n, b_n, k_n = torch.zeros(B, Oa), torch.zeros(B, Ob), torch.zeros(B)
    order = (0, 1, 2)
    with pytest.raises(TypeError):
        tnm.separable_mlp(tp, K, x.double(), a_n, b_n, k_n, order)
    with pytest.raises(ValueError, match="on meta"):
        tnm.separable_mlp(tp, K, x, a_n.to("meta"), b_n, k_n, order)
    with pytest.raises(ValueError, match="on meta"):
        tnm.separable_mlp(tp.to("meta"), K, x, a_n, b_n, k_n, order)
    with pytest.raises(ValueError):
        tnm.separable_mlp(tp, K, x, a_n, b_n[:, :4], k_n, order)
    with pytest.raises(ValueError):
        tnm.separable_mlp(tp, K, x, a_n, b_n, k_n, order,
                          out=torch.zeros((B, Oa, Ob), dtype=torch.int64))
    meta = [t.to("meta") for t in (x, a_n, b_n, k_n)]
    for dims, classes, match in [((20, 32), 4, "multiples of 16"),
                                 ((32, 272), 4, "multiples of 16"),
                                 ((32, 32), 9, "classes"),
                                 ((32, 32), 4, "no MLP kernel")]:
        tm2 = tbuild(TCfg(hidden_dims=dims, fourier_freqs=K,
                          num_classes=classes), num_modalities=4)
        tp2 = tm2.init(torch.Generator().manual_seed(0)).to("meta")
        err = RuntimeError if match == "no MLP kernel" else ValueError
        with pytest.raises(err, match=match):
            tnm.separable_mlp(tp2, K, *meta, order)
    # The plain version takes widths K3 does not.
    tm3 = tbuild(TCfg(hidden_dims=(20, 8), fourier_freqs=K), num_modalities=4)
    tp3 = tm3.init(torch.Generator().manual_seed(0))
    assert tnm.separable_mlp(tp3, K, x, a_n, b_n, k_n, order).shape == \
        (B, Oa, Ob)


def test_predict_field_counts_points_not_kernel_points_on_cpu(scene, inr):
    _, _, tm, tp = inr
    f = _frame(scene, 0.8, 1.1)
    profiling.reset_counters()
    launches = tnm.separable_mlp.launches
    ft = tnm.predict_field(tm, tp, f["mzt"], f["gt"], f["pt"], f["axis"], O,
                           S, block=8)
    c = profiling.counters()
    assert c["field.points"] == ft.numel()
    assert c.get("field.kernel_points", 0) == 0
    assert tnm.separable_mlp.launches == launches


@pytest.mark.parametrize("kstride", [1, 2])
def test_k1b_plain_matches_pallas(scene, inr, kstride):
    jm, jp, _, _ = inr
    f = _frame(scene, 0.8, 1.1)
    field = np.asarray(jnm.predict_field(jm, jp, f["mzj"], f["gj"], f["pj"],
                                         f["axis"], O, S, block=8,
                                         kstride=kstride))
    Cj, Tj = sweep_composite_pallas(
        f["mj"], f["sj"], None, f["gj"], f["pj"], f["axis"], O,
        use_gamma=False, use_clip=False, interpret=True,
        pred_field=jnp.asarray(field).astype(jnp.bfloat16), field_stride=S,
        field_kstride=kstride)
    Ct, Tt = composite.sweep_composite_fused(
        f["mt"], f["st"], None, f["gt"], f["pt"], f["axis"], O,
        use_gamma=False, use_clip=False, pred_field=torch.tensor(field),
        field_stride=S, field_kstride=kstride)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=3e-3)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=3e-3)
    # The field overlay is really there: without it the image changes.
    C0, _ = composite.sweep_composite_fused(
        f["mt"], f["st"], None, f["gt"], f["pt"], f["axis"], O,
        use_gamma=False, use_clip=False)
    assert float((Ct - C0).abs().max()) > 1e-2


def test_k1b_plain_counts_and_checks():
    """The plain version counts field taps with a shown label in [1, 8) only
    where the plane composites; the wrapper checks the field's layout."""
    K, Na, Op = 3, 4, 4
    t1b = torch.zeros((K, Na, 8), dtype=torch.bfloat16)
    pp = torch.zeros((K, 7))
    pp[:, 1] = pp[:, 3] = 1.0  # sc_a, sc_b: positions i and j
    pp[:, 4] = pp[:, 5] = 1.0  # lam, own
    pp[2, 5] = 0.0  # plane 2 owns nothing
    sc = torch.zeros(16)
    sc[0], sc[1], sc[3], sc[7] = 1.0, 0.5, 0.4, 1.0  # ww, wl, ia, show_pred
    sc[13], sc[14], sc[8], sc[9] = -1.0, 3.0, -1.0, 9.0  # a rows 0..3 inside
    lut = torch.as_tensor(trp.DEFAULT_LUT)
    m = torch.ones((8, 8))
    r = torch.full((8, 8), 3e38)
    field = torch.tensor([[0, 1, 9, 2]] * Op, dtype=torch.uint8)[None] \
        .repeat(2, 1, 1)  # (ceil(3 / 2), 4, 4)
    C, T, planes, n_lab = composite.composite_planes_plain(
        t1b, None, None, pp, sc, lut, m, m, r, False, False,
        pred_field=field, field_stride=2, field_kstride=2)
    # Rows 0..3 x 8 columns composite on planes 0 and 1; per plane half the
    # columns read label 1 or 2 (0 and 9 are transparent).
    assert int(planes.sum()) == 2 * 4 * 8 and n_lab.tolist() == [0, 2 * 4 * 4]
    assert bool((planes[:4] == 2).all()) and int(planes[4:].abs().sum()) == 0
    assert float(C[0, 2:4].sum()) > 0 and float(C[0, 0:2].sum()) == 0
    assert float(C[4:].abs().sum()) == 0  # rows past the a-mask: inactive
    args = (t1b, None, None, pp, sc, lut, m, m, r, False, False)
    with pytest.raises(ValueError):  # wrong row count for kstride 1
        composite.composite_planes(*args, pred_field=field, field_stride=2)
    with pytest.raises(ValueError):  # stride must divide O
        composite.composite_planes(*args, pred_field=field, field_stride=3,
                                   field_kstride=2)
    with pytest.raises(TypeError):
        composite.composite_planes(*args, pred_field=field.int(),
                                   field_stride=2, field_kstride=2)
    with pytest.raises(ValueError):  # exclusive with baked-pred rows
        composite.composite_planes(
            t1b, None, torch.zeros((K, Na, 8), dtype=torch.uint8), *args[3:],
            pred_field=field, field_stride=2, field_kstride=2)
    before = (composite.composite_planes.launches,
              composite.composite_planes.field_launches)
    Cw, Tw = composite.composite_planes(*args, pred_field=field,
                                        field_stride=2, field_kstride=2)
    assert (composite.composite_planes.launches,
            composite.composite_planes.field_launches) == before  # plain
    assert torch.equal(Cw, C) and torch.equal(Tw, T)


@pytest.mark.parametrize("theta,phi,kstride", [(0.8, 1.1, 1), (4.0, 1.9, 2)])
def test_scan_render_matches_jax(scene, inr, theta, phi, kstride):
    disp, zsc, seg = scene
    jm, jp, tm, tp = inr
    pj = jrp.default_render_params(SHAPE, show_seg=True, show_pred=True)
    pt = trp.default_render_params(SHAPE, show_seg=True, show_pred=True)
    cam = dict(radius=jrp.default_camera_radius(pj, SHAPE), theta=theta,
               phi=phi)
    bj, bt = JCam(**cam).basis(), TCam(**cam).basis()
    axis = jsw.dominant_axis(bj)
    mj = jsw._perm_volume(jnp.asarray(disp[0]), axis)
    mzj = jnp.stack([jsw._perm_volume(jnp.asarray(z), axis) for z in zsc])
    gj = jsw.sweep_geometry(bj, pj, mj.shape, axis, O, frustum_wh=(W, H))
    field = jnm.predict_field(jm, jp, mzj, gj, pj, axis, O, S, block=8,
                              kstride=kstride)
    img_j = np.asarray(jnm.render_brats_neural(
        jnp.asarray(disp), jnp.asarray(zsc), jnp.asarray(seg), jm, jp, bj, pj,
        W, H, out_res=O, pred_stride=S, pred_kstride=kstride, geom=gj,
        field=field))
    img_t = tnm.render_brats_neural(
        disp, zsc, seg, tm, tp, bt, pt, W, H, out_res=O, pred_stride=S,
        pred_kstride=kstride, geom=_geom_t(gj), field=np.asarray(field),
        device="cpu")
    assert img_t.shape == (H, W, 3)
    np.testing.assert_allclose(img_t.numpy(), img_j, atol=3e-3)
    # Its own field (geometry and labels computed by the port).
    img_own = tnm.render_brats_neural(disp, zsc, seg, tm, tp, bt, pt, W, H,
                                      out_res=O, pred_stride=S,
                                      pred_kstride=kstride, device="cpu")
    assert psnr(img_own, img_j) >= 40.0


def test_renderer_backends_on_cpu(scene, inr):
    disp, zsc, seg = scene
    _, _, tm, tp = inr
    p = trp.default_render_params(SHAPE, show_seg=True, show_pred=True)
    basis = TCam(radius=trp.default_camera_radius(p, SHAPE), theta=0.8,
                 phi=1.1).basis()
    kw = dict(width=64, height=64, sweep_res=128, pred_stride=2,
              device="cpu")
    assert tnm.NeuralBratsRenderer(disp, zsc, seg, tm, tp,
                                   **kw).backend == "scan"
    with pytest.raises(ValueError, match="pred_stride"):
        tnm.NeuralBratsRenderer(disp, zsc, seg, tm, tp,
                                **{**kw, "pred_stride": 3})
    with pytest.raises(ValueError):
        tnm.NeuralBratsRenderer(disp, zsc, seg, tm, tp, backend="pallas",
                                **kw)
    # set_params changes the frame, on every backend.
    _, _, _, tp2 = _models(JCfg(hidden_dims=(16, 16), fourier_freqs=4),
                           seed=5)
    for backend in ("scan", "rebake", "fused"):
        r = tnm.NeuralBratsRenderer(disp, zsc, seg, tm, tp, backend=backend,
                                    **kw)
        img1 = r.render(basis, p)
        assert img1.shape == (64, 64, 3) and bool(torch.isfinite(img1).all())
        r.set_params(tp2)
        img2 = r.render(basis, p)
        assert float((img1 - img2).abs().max()) > 1e-3, backend
    # The fused frame on CPU tensors (stage 1 + K1b's plain version) and
    # the scan over the same prepared frame and field agree.
    r = tnm.NeuralBratsRenderer(disp, zsc, seg, tm, tp, backend="fused", **kw)
    fr = r.sweep_frame(basis, p)
    field = tnm.frame_field(tm, tp, fr, 2)
    C = tnm._render_neural_fused(fr, tm, tp, 2, field=field)
    fused = tsw.warp_to_screen(C, fr.geom, fr.basis, fr.axis, 64, 64,
                               fr.p.bg_color)
    torch.testing.assert_close(fused, r.render(basis, p), atol=0, rtol=0)
    scan = tnm._render_neural_axis(fr, tm, tp, 64, 64, 2, field=field)
    np.testing.assert_allclose(fused.numpy(), scan.numpy(), atol=3e-3)


def test_constant_predictor_fused_matches_baked(scene):
    """A constant INR (bias only) renders as a baked constant prediction
    volume (tests/test_neural_march.py:38-52, there >= 45 dB)."""
    disp, zsc, _ = scene
    tm = tbuild(TCfg(hidden_dims=(8,), fourier_freqs=2), num_modalities=4)
    tp = tm.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for t in tp.parameters():
            t.zero_()
        tp[-1].b[2] = 10.0
    p = trp.default_render_params(SHAPE, show_seg=False, show_pred=True,
                                  step_size=1.8 / 24)
    basis = TCam(radius=trp.default_camera_radius(p, SHAPE), theta=0.5,
                 phi=1.2).basis()
    kw = dict(width=64, height=64, sweep_res=128, device="cpu")
    r = tnm.NeuralBratsRenderer(disp, zsc, None, tm, tp, backend="fused",
                                pred_stride=2, **kw)
    # At this size the 16-slice content crop is the whole volume, so the
    # fused field covers what the full-volume bake does.
    fr = r.sweep_frame(basis, p)
    assert fr.z_offset is None and fr.ab_offset is None
    assert tuple(fr.modsz_s.shape[1:]) == tuple(fr.mixed_s.shape)
    fused = r.render(basis, p)
    baked = tnm.NeuralBratsRenderer(disp, zsc, None, tm, tp,
                                    backend="rebake", **kw).render(basis, p)
    assert psnr(fused, baked) >= 45.0


def test_entry_points_need_a_card(scene, inr, monkeypatch):
    disp, zsc, seg = scene
    _, _, tm, tp = inr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = trp.default_render_params(SHAPE)
    basis = TCam(radius=2.0).basis()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnm.NeuralBratsRenderer(disp, zsc, seg, tm, tp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnm.render_brats_neural(disp, zsc, seg, tm, tp, basis, p, 8, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinf.predict_volume(tm, tp, {"mods": zsc, "seg": seg})
