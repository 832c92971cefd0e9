"""The port's ROI policy renderer (``ops/roi_policy.py``), its trilinear
helpers and window rays against the JAX package on the CPU, on the scene
of tests/test_roi_policy.py (``synthetic_case((32, 32, 28), seed=3)``,
intensity_alpha 1.0) at frames <= 48^2.

Tolerances:
  * packed / rows / nearest-row gathers, the corner packing, window rays,
    feature volumes, ROI projections, ROI corners: bit-equal; the mip's
    2x2x2 mean: 1 float32 ulp (1.2e-7, the sum's order);
  * apply_policy: within one bf16 ulp of the logits (the MLP runs in
    bfloat16 on both sides);
  * render_fixed (no bf16): 1e-5;
  * render_policy / render_policy_foveated: 1e-3 (measured <= 4e-5). JAX's
    jitted program rounds the bf16 MLP's sums once where its own eager ops
    and the port round after each op; the port matches eager JAX to 2e-7;
  * policy gradient with a float32 MLP on both sides (monkeypatched
    ``apply_policy`` dtype): 1e-3 of max|g| against jitted JAX (measured
    <= 5e-4, on a bias entry 1/2000 of the largest);
  * the bf16 MLP's backward, fed the port's cotangents at its outputs,
    against eager JAX's ``apply_policy`` VJP: W1 and W2 within 2^-7 max|g|
    (two bf16 ulps; measured equal); b1 and b2 within 2^-3 max|g|: JAX sums
    a broadcast bias's bf16 cotangent in bfloat16 (``reduce_sum`` on bf16
    in the transpose of the broadcast), the port in float32 (measured 0.06
    and 0.02 of max|g|);
  * five train_policy updates from the same ``init=``, float32 MLP,
    against jitted JAX: losses rtol 1e-2, params atol 1e-4 (against eager
    JAX with the bf16 MLP: 3e-5 measured at lr 1e-3).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.data import brats as jbrats, synthetic as jsyn
from mri_raytracer_tpu.ops import raymarch_xla as jrx
from mri_raytracer_tpu.ops import roi_policy as J
from mri_raytracer_tpu.ops import trilinear as jtri
from mri_raytracer_tpu.render import camera as jcam
from mri_raytracer_tpu.render import params as jrp
from mri_raytracer_tpu_torch import convert
from mri_raytracer_tpu_torch.ops import raymarch as trx
from mri_raytracer_tpu_torch.ops import roi_policy as T
from mri_raytracer_tpu_torch.ops import trilinear as ttri
from mri_raytracer_tpu_torch.render import camera as tcam

torch.set_num_threads(2)
JCFG, TCFG = J.PolicyConfig(), T.PolicyConfig()
IMG_TOL = dict(rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def scene():
    mods, seg = jsyn.synthetic_case((32, 32, 28), seed=3)
    mixed = np.stack([jbrats.percentile_normalize(m) for m in mods]) \
        .mean(0).astype(np.float32)
    feats = J.build_feature_volumes(mixed, seg)
    rows = J.pack_feature_rows(mixed, feats)
    pj = jrp.default_render_params(mixed.shape, show_seg=False)._replace(
        intensity_alpha=jnp.float32(1.0))
    radius = jrp.default_camera_radius(pj, mixed.shape)
    bvs = [np.asarray(jcam.OrbitalCamera(radius=radius, theta=th, phi=ph)
                      .basis().pack()) for th, ph in ((0.5, 1.1), (1.5, 0.9))]
    return {"mixed": mixed, "seg": seg, "feats": feats, "rows": rows,
            "pj": pj, "pt": convert.render_params_from_numpy(pj._asdict()),
            "bvs": bvs}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), **tol)


def _jst(sc, packed=False):
    vol = jnp.asarray(sc["mixed"])
    return (jtri.pack_trilinear_corners(vol) if packed else vol,
            jnp.asarray(sc["rows"]))


def _tst(sc, packed=False):
    vol = _t(sc["mixed"])
    return (ttri.pack_trilinear_corners(vol) if packed else vol,
            _t(sc["rows"]))


def _policies():
    docs = J.load_policy("docs/roi_policy.npz")
    s = (1.0 - JCFG.scale_min) / (JCFG.scale_max - JCFG.scale_min)
    const = {"W1": np.zeros((8, JCFG.hidden), np.float32),
             "b1": np.zeros(JCFG.hidden, np.float32),
             "W2": np.zeros((JCFG.hidden, 2), np.float32),
             "b2": np.array([np.log(s / (1 - s)), -30.0], np.float32)}
    return {"docs": {k: np.asarray(v) for k, v in docs.items()},
            "constant": const}


def _pair(pol_np):
    return ({k: jnp.asarray(v) for k, v in pol_np.items()},
            {k: _t(v) for k, v in pol_np.items()})


def test_trilinear_helpers_match_jax(scene):
    rng = np.random.default_rng(0)
    vol, rows = scene["mixed"], scene["rows"]
    pts = (rng.random((400, 3)) * (np.array(vol.shape) + 2) - 1.5) \
        .astype(np.float32)
    pts[:3] = [[0, 0, 0], [31, 31, 27], [30.5, 2.5, 26.5]]  # clip, .5 ties
    jp, tp = jtri.pack_trilinear_corners(jnp.asarray(vol)), \
        ttri.pack_trilinear_corners(_t(vol))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for jf, tf, v in ((jtri.trilinear_sample_packed,
                       ttri.trilinear_sample_packed, (jp, tp)),
                      (jtri.trilinear_sample_rows, ttri.trilinear_sample_rows,
                       (jnp.asarray(rows), _t(rows))),
                      (jtri.nearest_sample_rows, ttri.nearest_sample_rows,
                       (jnp.asarray(rows), _t(rows)))):
        np.testing.assert_array_equal(tf(v[1], _t(pts)).numpy(),
                                      np.asarray(jf(v[0], jnp.asarray(pts))))
    for shape in ((32, 32, 28), (31, 30, 27)):  # even and edge-padded
        sub = np.ascontiguousarray(vol[:shape[0], :shape[1], :shape[2]])
        _close(ttri.mip_downsample2(_t(sub)),
               jtri.mip_downsample2(jnp.asarray(sub)), rtol=0, atol=1.2e-7)


def test_packed_position_gradient_matches_jax(scene):
    """trilinear_sample_packed differentiates in the positions by autograd,
    as JAX's plain function does (the policy's gradient path)."""
    rng = np.random.default_rng(1)
    vol = scene["mixed"]
    pts = (rng.random((200, 3)) * (np.array(vol.shape) + 1) - 1.0) \
        .astype(np.float32)
    pts[0] = 0.0  # the clip's tie
    g = rng.normal(size=200).astype(np.float32)
    jp = jtri.pack_trilinear_corners(jnp.asarray(vol))
    jg = jax.grad(lambda q: jnp.sum(jtri.trilinear_sample_packed(jp, q) * g))(
        jnp.asarray(pts))
    tp = _t(pts).requires_grad_(True)
    (ttri.trilinear_sample_packed(ttri.pack_trilinear_corners(_t(vol)), tp)
     * _t(g)).sum().backward()
    _close(tp.grad, jg, rtol=1e-5, atol=1e-6)


def test_clip_ties_match_jax():
    """Differentiated clips tie as jnp.clip (half the gradient at a bound):
    the transfer function at v = 0 and v = 1 of the default window
    (wl 0.5, ww 1.0), and the trilinear corner clip at pts = 0. With
    torch.clamp the port would pass the whole gradient there."""
    v = np.array([0.0, 1.0, 0.3, -0.2, 1.4], np.float32)
    jg = jax.grad(lambda x: jnp.sum(jrx.transfer_function(
        x, 1.0, 0.5, 1.0)))(jnp.asarray(v))
    tv = _t(v).requires_grad_(True)
    trx.transfer_function(tv, torch.tensor(1.0), torch.tensor(0.5),
                          torch.tensor(1.0)).sum().backward()
    _close(tv.grad, jg, rtol=0, atol=0)
    assert float(jg[0]) == float(jg[1]) == 0.5  # the ties carry half
    vol = np.random.default_rng(2).random((5, 6, 4)).astype(np.float32)
    pts = np.array([[0.0, 0.0, 0.0], [0.0, 2.5, 1.5], [3.999, 4.999, 2.999],
                    [1.2, 3.3, 2.2]], np.float32)
    for jf, tf, jv, tvol in (
            (jtri.trilinear_sample_base, ttri.trilinear_sample_base,
             jnp.asarray(vol), _t(vol)),
            (jtri.trilinear_sample_packed, ttri.trilinear_sample_packed,
             jtri.pack_trilinear_corners(jnp.asarray(vol)),
             ttri.pack_trilinear_corners(_t(vol)))):
        jg = jax.grad(lambda q: jnp.sum(jf(jv, q)))(jnp.asarray(pts))
        tp = _t(pts).requires_grad_(True)
        tf(tvol, tp).sum().backward()
        _close(tp.grad, jg, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("x0,y0,w,h", [(16, 8, 32, 24), (0, 0, 64, 48),
                                       (40, 37, 24, 11)])
def test_window_rays_bit_equal(scene, x0, y0, w, h):
    """A window ray equals the full frame's ray of the same pixel bit for
    bit, with the origin as a number or as a 0-d tensor; and the port's
    window rays equal JAX's."""
    basis = convert.camera_from_packed(scene["bvs"][0])
    ro, rd = tcam.camera_rays(basis, 64, 48)
    for o in ((x0, y0), (torch.tensor(float(x0)), torch.tensor(float(y0)))):
        wo, wd = tcam.camera_rays_window(basis, 64, 48, *o, w, h)
        np.testing.assert_array_equal(wd.numpy(),
                                      rd[y0:y0 + h, x0:x0 + w].numpy())
        np.testing.assert_array_equal(wo.numpy(),
                                      ro[y0:y0 + h, x0:x0 + w].numpy())
    jb = jcam.unpack_basis(jnp.asarray(scene["bvs"][0]))
    _, jd = jcam.camera_rays_window(jb, 64, 48, x0, y0, w, h)
    np.testing.assert_array_equal(wd.numpy(), np.asarray(jd))


def test_feature_volumes_equal(scene):
    feats = T.build_feature_volumes(scene["mixed"], scene["seg"])
    for k, v in scene["feats"].items():
        np.testing.assert_array_equal(feats[k], v, err_msg=k)
    np.testing.assert_array_equal(
        T.pack_feature_rows(scene["mixed"], feats), scene["rows"])
    nf = T.build_feature_volumes(scene["mixed"], None)
    for k, v in J.build_feature_volumes(scene["mixed"], None).items():
        np.testing.assert_array_equal(nf[k], v, err_msg=k)
    _close(T.roi_world_corners(_t(feats["P"]), _t(feats["B"]), scene["pt"]),
           J.roi_world_corners(feats["P"], feats["B"], scene["pj"]),
           rtol=0, atol=0)


def test_init_and_apply_policy():
    pol = T.init_policy(torch.Generator().manual_seed(0))
    jpol = J.init_policy(jax.random.PRNGKey(0))
    for k in ("W1", "b1", "W2", "b2"):
        assert tuple(pol[k].shape) == jpol[k].shape
    # The pinned entries are exact; the random parts have JAX's scales.
    assert float(pol["W1"][7, 0]) == -50.0 and float(pol["b1"][0]) == 1.0
    np.testing.assert_array_equal(pol["W2"][0].numpy(), [0.0, 8.0, 0.0])
    np.testing.assert_array_equal(pol["b2"].numpy(), np.asarray(jpol["b2"]))
    np.testing.assert_array_equal(pol["b1"][1:].numpy(), 0.0)
    assert 0.01 < float(pol["W1"][:7].std()) < 0.04
    with pytest.raises(TypeError, match="torch.Generator"):
        T.init_policy(None)  # never the global generator
    feats = np.random.default_rng(1).normal(size=(2048, 8)).astype(np.float32)
    for name, pn in _policies().items():
        for n_out in (3, 2):
            if pn["W2"].shape[1] < n_out:
                continue
            pn = dict(pn, W2=pn["W2"][:, :n_out], b2=pn["b2"][:n_out])
            jp, tp = _pair(pn)
            js, jk, jl = J.apply_policy(jp, jnp.asarray(feats), JCFG)
            ts, tk, tl = T.apply_policy(tp, _t(feats), TCFG)
            # One bf16 ulp of a logit l moves sigmoid(l) by at most
            # s (1 - s) 2^(e - 7), e = floor(log2 |l|).
            for jo, to, span in ((js, ts, JCFG.scale_max - JCFG.scale_min),
                                 (jk, tk, 1.0)):
                s = (np.asarray(jo) - (JCFG.scale_min if span != 1.0
                                       else 0.0)) / span
                s = np.clip(s, 1e-7, 1 - 1e-7)
                logit = np.abs(np.log(s / (1 - s))) + 1e-30
                ulp = 2.0 ** (np.floor(np.log2(logit)) - 7)
                bound = span * s * (1 - s) * ulp + 1e-6
                assert np.all(np.abs(to.numpy() - np.asarray(jo)) <= bound)
            if n_out == 2:
                assert float(tl.abs().max()) == 0.0
            else:
                _close(tl, jl, rtol=0, atol=4.0 * 2 ** -7)


@pytest.mark.parametrize("packed", [False, True])
def test_render_fixed_matches_jax(scene, packed):
    bv = scene["bvs"][1]
    jv, tv = _jst(scene, packed)[0], _tst(scene, packed)[0]
    for block in (None, 16):  # 40 = 2 x 16 + 8 padded
        a, sa = J.render_fixed(jv, jnp.asarray(bv), scene["pj"], 48, 40, 40,
                               block=block)
        b, sb = T.render_fixed(tv, _t(bv), scene["pt"], 48, 40, 40,
                               block=block)
        _close(b, a, rtol=0, atol=1e-5)
        _close(sb, sa, rtol=1e-6, atol=0)


@pytest.mark.parametrize("pol,kw", [
    ("constant", dict(roi_clamp=False)),
    ("docs", dict()),
    ("docs", dict(probe_stride=3, rho_upsample=3, block=10)),
    ("docs", dict(probe_stride=3, lod=True)),
    ("constant", dict(probe_stride=3, rho_upsample=3, lod=True)),
])
def test_render_policy_matches_jax(scene, pol, kw):
    kw = dict(kw)
    lod = kw.pop("lod", False)
    jp, tp = _pair(_policies()[pol])
    if lod:
        kw_j = dict(kw, lod_vol=jtri.pack_trilinear_corners(
            jtri.mip_downsample2(jnp.asarray(scene["mixed"]))))
        kw_t = dict(kw, lod_vol=ttri.pack_trilinear_corners(
            ttri.mip_downsample2(_t(scene["mixed"]))))
    else:
        kw_j = kw_t = kw
    bv = scene["bvs"][0]
    a, sa = J.render_policy(jp, *_jst(scene, True), jnp.asarray(bv),
                            scene["pj"], 48, 42, 12, 32, JCFG, **kw_j)
    b, sb = T.render_policy(tp, *_tst(scene, True), _t(bv), scene["pt"],
                            48, 42, 12, 32, TCFG, **kw_t)
    assert b.shape == (42, 48, 3)
    _close(b, a, **IMG_TOL)
    for k in sa:
        _close(sb[k], sa[k], rtol=1e-3, atol=0)


def test_render_policy_rejects_bad_upsample(scene):
    tp = _pair(_policies()["docs"])[1]
    with pytest.raises(ValueError, match="must divide"):
        T.render_policy(tp, *_tst(scene), _t(scene["bvs"][0]), scene["pt"],
                        32, 32, 8, 16, probe_stride=4, rho_upsample=3)


@pytest.mark.parametrize("stride", [1, 4])
def test_render_policy_foveated(scene, stride):
    """The foveated frame against JAX's, and its ROI pixels (inside the
    feather) against the port's own full-resolution render at the bar of
    tests/test_roi_policy.py (the inset's products run over fewer rows,
    so a kernel may sum in another order: 8e-5 relative measured)."""
    jp, tp = _pair(_policies()["docs"])
    ru = 2 if stride > 1 else 1
    corners = J.roi_world_corners(scene["feats"]["P"], scene["feats"]["B"],
                                  scene["pj"])
    bv = scene["bvs"][0]
    a, sa = J.render_policy_foveated(jp, *_jst(scene, True), jnp.asarray(bv),
                                     scene["pj"], 64, 48, corners, 12, 32,
                                     probe_stride=stride, rho_upsample=ru,
                                     feather=4)
    b, sb = T.render_policy_foveated(tp, *_tst(scene, True), _t(bv),
                                     scene["pt"], 64, 48, _t(corners), 12,
                                     32, probe_stride=stride,
                                     rho_upsample=ru, feather=4)
    _close(b, a, **IMG_TOL)
    x0, y0, rw, rh = (int(v) for v in sb["rect"])
    assert (x0, y0, rw, rh) == tuple(int(v) for v in sa["rect"])
    assert x0 % max(2, stride) == 0 and y0 % max(2, stride) == 0
    for k in ("steps_per_ray", "mean_scale", "mean_skip", "expected_steps"):
        _close(sb[k], sa[k], rtol=1e-3, atol=0)
    full, _ = T.render_policy(tp, *_tst(scene, True), _t(bv), scene["pt"],
                              64, 48, 12, 32, probe_stride=stride,
                              rho_upsample=ru)
    inner = (slice(y0 + 4, y0 + rh - 4), slice(x0 + 4, x0 + rw - 4))
    _close(b[inner], full[inner], rtol=1e-4, atol=2e-4)


def test_project_roi_maps_equal(scene):
    P, B = scene["feats"]["P"], scene["feats"]["B"]
    bv = scene["bvs"][0]
    for a, b in zip(J.project_roi_maps(jnp.asarray(P), jnp.asarray(B),
                                       jnp.asarray(bv), scene["pj"], 40, 36),
                    T.project_roi_maps(_t(P), _t(B), _t(bv), scene["pt"],
                                       40, 36)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    w = T.roi_weight_map(_t(P[0, :4]), _t(B[0, :4]))
    _close(w, J.roi_weight_map(jnp.asarray(P[0, :4]), jnp.asarray(B[0, :4])),
           rtol=0, atol=0)


def _loss_case(scene):
    bv = scene["bvs"][0]
    ref = np.asarray(J.render_fixed(jnp.asarray(scene["mixed"]),
                                    jnp.asarray(bv), scene["pj"], 32, 32,
                                    96)[0])
    Pm, Bm = J.project_roi_maps(jnp.asarray(scene["feats"]["P"]),
                                jnp.asarray(scene["feats"]["B"]),
                                jnp.asarray(bv), scene["pj"], 32, 32)
    return bv, ref, np.asarray(J.roi_weight_map(Pm, Bm))


def _grads(scene, pol_np, lod):
    bv, ref, w = _loss_case(scene)
    jl = jtri.mip_downsample2(jnp.asarray(scene["mixed"])) if lod else None
    tl = ttri.mip_downsample2(_t(scene["mixed"])) if lod else None
    jp, tp = _pair(pol_np)
    f = lambda P: J.policy_loss(P, _jst(scene), jnp.asarray(bv),
                                jnp.asarray(ref), scene["pj"], 32, 32, 8, 16,
                                JCFG, 0.0, jnp.asarray(w), 2,
                                lod_vol=jl)[0]
    lj, gj = jax.value_and_grad(f)(jp)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    lt, _ = T.policy_loss(tp, _tst(scene), _t(bv), _t(ref), scene["pt"], 32,
                          32, 8, 16, TCFG, 0.0, _t(w), 2, lod_vol=tl)
    lt.backward()
    _close(lt, lj, rtol=1e-4, atol=0)
    return {k: (tp[k].grad.numpy(), np.asarray(gj[k])) for k in gj}


def _f32_mlp(monkeypatch):
    monkeypatch.setattr(J, "apply_policy", functools.partial(
        J.apply_policy, dtype=jnp.float32))
    monkeypatch.setattr(T, "apply_policy", functools.partial(
        T.apply_policy, dtype=torch.float32))


@pytest.mark.parametrize("lod", [False, True])
def test_policy_gradient_float32_mlp(scene, monkeypatch, lod):
    """With the MLP in float32 on both sides every step of the path is the
    same arithmetic: the gradient agrees with jitted JAX's at 1e-3 of
    max|g| (inverse CDF, packed positions, compositing adjoint, ROI clamps,
    the LOD level)."""
    _f32_mlp(monkeypatch)
    pn = J.load_policy("docs/roi_policy_lod.npz" if lod
                       else "docs/roi_policy.npz")
    for k, (got, want) in _grads(scene, {k: np.asarray(v)
                                         for k, v in pn.items()},
                                 lod).items():
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-3 * np.abs(want).max(), err_msg=k)


def test_policy_gradient_bf16_mlp(scene, monkeypatch):
    """The bf16 MLP's backward against JAX's: the port's policy_loss
    gradient equals its loss's cotangent at the MLP's outputs pulled back
    through JAX's ``apply_policy`` (``jax.vjp``, eager, so rounding after
    each op as the port does) on the same features: weights within 2^-7
    max|g|; biases within 2^-3 max|g| (JAX sums a bias's bf16 cotangent in
    bfloat16). The rest of the path is held above against jax.grad of
    policy_loss itself."""
    cap = {}
    orig = T.apply_policy

    def recorded(params, feats, cfg, dtype=torch.bfloat16):
        outs = orig(params, feats, cfg, dtype)
        for o in outs:
            o.retain_grad()
        cap["feats"], cap["outs"] = feats.detach(), outs
        return outs

    monkeypatch.setattr(T, "apply_policy", recorded)
    bv, ref, w = _loss_case(scene)
    jp, tp = _pair(_policies()["docs"])
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    loss, _ = T.policy_loss(tp, _tst(scene), _t(bv), _t(ref), scene["pt"],
                            32, 32, 8, 16, TCFG, 0.0, _t(w), 2)
    loss.backward()
    cots = tuple(jnp.asarray(_np_grad(o)) for o in cap["outs"])
    _, vjp = jax.vjp(lambda P: J.apply_policy(
        P, jnp.asarray(cap["feats"].numpy()), JCFG), jp)
    (gj,) = vjp(cots)
    for k in gj:
        want = np.asarray(gj[k])
        bar = 2.0 ** (-7 if k.startswith("W") else -3)
        np.testing.assert_allclose(tp[k].grad.numpy(), want, rtol=0,
                                   atol=bar * np.abs(want).max(), err_msg=k)
    assert np.abs(np.asarray(gj["W1"])).max() > 0.0


def _np_grad(t):
    return t.grad.numpy() if t.grad is not None \
        else np.zeros(t.shape, np.float32)


def test_train_policy_matches_jax(scene, monkeypatch):
    """Five AdamW updates (clip 1.0, warmup-cosine, weight decay 1e-4) from
    the same init, round robin over two views, against jitted JAX, the MLP
    in float32 on both sides (the bf16 gradient is held above)."""
    _f32_mlp(monkeypatch)
    init = {k: np.asarray(v) for k, v in
            J.init_policy(jax.random.PRNGKey(0)).items()}
    bvs = scene["bvs"]
    refs = [np.asarray(J.render_fixed(jnp.asarray(scene["mixed"]),
                                      jnp.asarray(v), scene["pj"], 32, 32,
                                      96)[0]) for v in bvs]
    kw = dict(n_coarse=8, n_fine=16, steps=5, lr=1e-3, probe_stride=2)
    jpol, jl, jsel = J.train_policy(
        jax.random.PRNGKey(0), _jst(scene), [jnp.asarray(v) for v in bvs],
        [jnp.asarray(r) for r in refs], scene["pj"], 32, 32,
        init={k: jnp.asarray(v) for k, v in init.items()}, **kw)
    tpol, tl, tsel = T.train_policy(
        None, _tst(scene), [_t(v) for v in bvs], [_t(r) for r in refs],
        scene["pt"], 32, 32, init={k: _t(v) for k, v in init.items()}, **kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    for k in init:
        _close(tpol[k], jpol[k], rtol=0, atol=1e-4)
        assert not tpol[k].requires_grad
    assert tsel == jsel


def test_train_policy_validation_selection(scene):
    """With validation views, training early-stops on the validation
    ROI-wPSNR and returns the best checkpoint (tests/test_roi_policy.py's
    check, on the port)."""
    bvs = [_t(v) for v in scene["bvs"]]
    refs = [T.render_fixed(_t(scene["mixed"]), v, scene["pt"], 32, 32,
                           96)[0] for v in bvs]
    pol, losses, sel = T.train_policy(
        torch.Generator().manual_seed(0), _tst(scene), bvs[:1], refs[:1],
        scene["pt"], 32, 32, n_coarse=8, n_fine=16, steps=12, lr=1e-3,
        val_views=bvs[1:], val_refs=refs[1:], eval_every=3, patience=2,
        val_budgets=(16,))
    assert sel["selected_step"] >= 3 and len(sel["val_wpsnr_curve"]) >= 2
    assert np.isfinite(losses).all() and sel["val_budgets"] == [16]
    img, _ = T.render_policy(pol, *_tst(scene), bvs[1], scene["pt"], 32, 32,
                             8, 16)
    q = -10.0 * np.log10(max(float(((img - refs[1]) ** 2).mean()), 1e-12))
    assert abs(q - sel["best_val_wpsnr"]) < 1e-3


def test_policy_files_cross_load(tmp_path):
    """The committed policies load in the port as in JAX; a policy the port
    saves loads in JAX's load_policy (and the other way), with the same
    meta file."""
    for name in ("roi_policy", "roi_policy_lod"):
        jp = J.load_policy(f"docs/{name}.npz")
        tp = T.load_policy(f"docs/{name}.npz")
        for k in jp:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    pol = T.init_policy(torch.Generator().manual_seed(3))
    T.save_policy(tmp_path / "t.npz", pol, meta={"x": 1})
    J.save_policy(tmp_path / "j.npz", {k: jnp.asarray(v.numpy())
                                       for k, v in pol.items()},
                  meta={"x": 1})
    back_j = J.load_policy(tmp_path / "t.npz")
    back_t = T.load_policy(tmp_path / "j.npz")
    for k in pol:
        np.testing.assert_array_equal(np.asarray(back_j[k]),
                                      back_t[k].numpy())
        np.testing.assert_allclose(back_t[k].numpy(), pol[k].numpy(),
                                   atol=1e-2)
    assert json.loads((tmp_path / "t_meta.json").read_text()) == \
        json.loads((tmp_path / "j_meta.json").read_text())


def test_convert_roi_policy():
    tree = {k: np.asarray(v) for k, v in
            J.init_policy(jax.random.PRNGKey(5)).items()}
    pol = convert.roi_policy_from_numpy(tree)
    back = convert.roi_policy_to_numpy(pol)
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k])
    with pytest.raises(ValueError, match="not a ROI policy"):
        convert.roi_policy_from_numpy({"W1": tree["W1"]})
