"""The port's CUDA kernels on the card, each held against its plain
PyTorch version on the same inputs. Every test here is marked ``cuda`` and
skips where no card is present (it decides inside the test).

This file imports no JAX, so it runs on a machine without it; the root
conftest imports JAX, so run it there with
``python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py``.

Tolerance 1e-3 (max abs): kernel and plain version read the same bf16
stage-1 rows and do the same float32 operations in the same order; the
compiler's fused multiply-adds and expf/powf/tanf may differ in the last
bits. The sweep_cuda vs sweep comparison, and the neural fused frame vs
the neural scan on the same field, use 3e-3, the bar between the fused
compositor and the scan (tests/test_pallas_composite.py)."""

import numpy as np
import pytest
import torch

from mri_raytracer_tpu_torch.config import ModelConfig
from mri_raytracer_tpu_torch.data.brats import (percentile_normalize,
                                                zscore_nonzero)
from mri_raytracer_tpu_torch.data.synthetic import synthetic_case
from mri_raytracer_tpu_torch.models.api import build_model
from mri_raytracer_tpu_torch.ops import composite, neural_march, warp
from mri_raytracer_tpu_torch.ops import shearwarp as sw
from mri_raytracer_tpu_torch.render import params as rp
from mri_raytracer_tpu_torch.render.brats import BratsRenderer
from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
from mri_raytracer_tpu_torch.utils import profiling

SHAPE = (40, 36, 32)
O = 128


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene():
    mods, seg = synthetic_case(SHAPE, seed=3)
    disp = np.stack([percentile_normalize(m) for m in mods])
    return disp, seg.astype(np.int32)


def _basis(p, theta, phi, dev):
    return OrbitalCamera(radius=rp.default_camera_radius(p, SHAPE),
                         theta=theta, phi=phi).basis(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("theta,phi,pred,gamma,near,crop", [
    (0.7, 1.1, False, 1.0, 0.0, False),
    (4.2, 2.2, True, 1.3, 0.0, False),
    (1.9, 0.4, True, 1.0, 0.5, True),
])
def test_k1_kernel_matches_plain(scene, theta, phi, pred, gamma, near, crop):
    dev = _card()
    disp, seg = scene
    p = rp.default_render_params(SHAPE, show_seg=True, show_pred=pred,
                                 gamma=gamma, near=near, device=dev)
    basis = _basis(p, theta, phi, dev)
    axis = sw.dominant_axis(basis)
    mixed, seg_s, _ = sw.prepare_sweep_volumes(
        torch.as_tensor(disp, device=dev), torch.as_tensor(seg, device=dev),
        None, p, axis)
    kw = {}
    if crop:  # k slab + in-plane crop: local clamp bounds outside [0, N)
        nk, na, nb = mixed.shape
        mixed = mixed[3:nk - 5, 4:na - 2, 2:nb - 6].contiguous()
        seg_s = seg_s[3:nk - 5, 4:na - 2, 2:nb - 6].contiguous()
        kw = dict(z_offset=3, nk_global=nk, ab_offset=(4, 2),
                  inplane_global=(na, nb))
    geom = sw.content_geometry(basis, p, tuple(mixed.shape), axis, O, 96, 80,
                               **kw)
    k1 = composite.stage1(mixed, seg_s, seg_s if pred else None, geom, p,
                          axis, O, kw.get("z_offset"), kw.get("nk_global"))
    flags = sw.static_flags(p)
    before = composite.composite_planes.launches
    Ck, Tk = composite.composite_planes(*k1, *flags)
    torch.cuda.synchronize()
    assert composite.composite_planes.launches == before + 1
    Cp, Tp, planes, _ = composite.composite_planes_plain(*k1, *flags)
    assert int(planes.sum()) > 0
    assert float((Ck - Cp).abs().max()) <= 1e-3
    assert float((Tk - Tp).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("theta,phi,gamma,near,crop", [
    (0.7, 1.1, 1.0, 0.0, False), (1.9, 0.4, 1.3, 0.5, True)])
def test_k1c_counter_matches_plain(scene, theta, phi, gamma, near, crop):
    """K1c: the kernel's executed-plane map equals the plain version's,
    and C and T with the counter on are bit-equal to those with it off."""
    dev = _card()
    disp, seg = scene
    p = rp.default_render_params(SHAPE, show_seg=True, gamma=gamma,
                                 near=near, device=dev)
    basis = _basis(p, theta, phi, dev)
    axis = sw.dominant_axis(basis)
    mixed, seg_s, _ = sw.prepare_sweep_volumes(
        torch.as_tensor(disp, device=dev), torch.as_tensor(seg, device=dev),
        None, p, axis)
    kw = {}
    if crop:
        nk, na, nb = mixed.shape
        mixed = mixed[3:nk - 5, 4:na - 2, 2:nb - 6].contiguous()
        seg_s = seg_s[3:nk - 5, 4:na - 2, 2:nb - 6].contiguous()
        kw = dict(z_offset=3, nk_global=nk, ab_offset=(4, 2),
                  inplane_global=(na, nb))
    geom = sw.content_geometry(basis, p, tuple(mixed.shape), axis, O, 96, 80,
                               **kw)
    k1 = composite.stage1(mixed, seg_s, None, geom, p, axis, O,
                          kw.get("z_offset"), kw.get("nk_global"))
    flags = sw.static_flags(p)
    before = (composite.composite_planes.launches,
              composite.composite_planes.count_launches)
    C0, T0 = composite.composite_planes(*k1, *flags)
    C1, T1, planes = composite.composite_planes(*k1, *flags,
                                                count_planes=True)
    torch.cuda.synchronize()
    assert (composite.composite_planes.launches,
            composite.composite_planes.count_launches) == \
        (before[0] + 2, before[1] + 1)
    assert planes.dtype == torch.int32 and planes.shape == (O, O)
    assert torch.equal(C0, C1) and torch.equal(T0, T1)
    ref = composite.composite_planes_plain(*k1, *flags).planes
    assert int(ref.sum()) > 0
    assert torch.equal(planes, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("stride,kstride,with_seg,crop", [
    (2, 1, True, False), (4, 2, False, False), (2, 2, True, True),
    (4, 1, False, True)])
def test_k1b_kernel_matches_plain(scene, stride, kstride, with_seg, crop):
    """K1b: the prediction field overlay, labels 0..9 (8 and 9 are
    transparent), at stride 2 and 4, every plane or every 2nd."""
    dev = _card()
    disp, seg = scene
    p = rp.default_render_params(SHAPE, show_seg=with_seg, show_pred=True,
                                 device=dev)
    basis = _basis(p, 2.1, 0.7, dev)
    axis = sw.dominant_axis(basis)
    mixed, seg_s, _ = sw.prepare_sweep_volumes(
        torch.as_tensor(disp, device=dev), torch.as_tensor(seg, device=dev),
        None, p, axis)
    kw = {}
    if crop:
        nk, na, nb = mixed.shape
        mixed = mixed[3:nk - 5, 4:na - 2, 2:nb - 6].contiguous()
        seg_s = seg_s[3:nk - 5, 4:na - 2, 2:nb - 6].contiguous()
        kw = dict(z_offset=3, nk_global=nk, ab_offset=(4, 2),
                  inplane_global=(na, nb))
    geom = sw.content_geometry(basis, p, tuple(mixed.shape), axis, O, 96, 80,
                               **kw)
    k1 = composite.stage1(mixed, seg_s if with_seg else None, None, geom, p,
                          axis, O, kw.get("z_offset"), kw.get("nk_global"))
    K = k1.t1b.shape[0]
    field = torch.randint(0, 10, (-(-K // kstride), O // stride, O // stride),
                          generator=torch.Generator(dev).manual_seed(1),
                          device=dev, dtype=torch.uint8)
    flags = sw.static_flags(p)
    fkw = dict(pred_field=field, field_stride=stride, field_kstride=kstride)
    before = composite.composite_planes.field_launches
    Ck, Tk = composite.composite_planes(*k1, *flags, **fkw)
    torch.cuda.synchronize()
    assert composite.composite_planes.field_launches == before + 1
    Cp, Tp, planes, n_labeled = composite.composite_planes_plain(
        *k1, *flags, **fkw)
    assert int(planes.sum()) > 0 and int(n_labeled[1]) > 0
    assert float((Ck - Cp).abs().max()) <= 1e-3
    assert float((Tk - Tp).abs().max()) <= 1e-3


# Where a tiled K1 can break: id -> theta, phi, O, crop, near, far, gamma,
# row overlays ('seg', or 'seg+pred' as in 'rebake'), field stride S and
# plane stride Kf (S None: no field).
TILED_CASES = {
    # O not a multiple of the 16 x 64 tile; O % 16 != 0 also turns the row
    # staging off (direct loads), and the field rows (Op = 60, 30) too.
    "ragged120-field2": (2.1, 0.7, 120, False, 0.0, 0.0, 1.0, "seg", 2, 1),
    "ragged120-field4-crop": (2.1, 0.7, 120, True, 0.0, 0.0, 1.0, "seg", 4,
                              2),
    "ragged120-rows": (4.2, 2.2, 120, False, 0.0, 0.0, 1.0, "seg", None, 1),
    # Ragged columns with staged rows (O % 16 == 0), fields direct.
    "ragged112-field2": (0.7, 1.1, 112, False, 0.0, 0.0, 1.0, "seg", 2, 1),
    "ragged96-rebake-crop-clip": (2.1, 0.7, 96, True, 0.3, 3.2, 1.0,
                                  "seg+pred", None, 1),
    # |sc_a| > 1: windows over the stage's capacity, direct loads; the
    # field (Op = 16) still staged.
    "direct-O32": (0.7, 1.1, 32, False, 0.0, 0.0, 1.0, "seg", None, 1),
    "direct-O32-field2": (0.7, 1.1, 32, False, 0.0, 0.0, 1.3, "seg", 2, 1),
    # Both row overlays at once, the 'rebake' case.
    "rebake": (4.2, 2.2, 128, False, 0.0, 0.0, 1.0, "seg+pred", None, 1),
    # The clip path with near > 0 on a crop whose clamp bounds lie outside
    # [0, N).
    "clip-near-far-crop": (1.9, 0.4, 128, True, 0.5, 3.2, 1.3, "seg", None,
                           1),
    # An axis-2 pose (the heaviest orbit poses sweep along axis 2), with a
    # staged field at stride 4.
    "axis2-field4": (4.2, 2.2, 128, False, 0.0, 0.0, 1.3, "seg", 4, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TILED_CASES))
def test_k1_tiled_kernel_edges(scene, case):
    """K1, K1b and K1c where the tiled kernel's culling, staging and
    direct-load paths meet the edges of their shapes: C and T within 1e-3
    of the plain version, the executed-plane map equal to the plain one,
    and C and T bit-equal with the counter on and off."""
    theta, phi, O_, crop, near, far, gamma, rows, S, Kf = TILED_CASES[case]
    dev = _card()
    disp, seg = scene
    p = rp.default_render_params(SHAPE, show_seg=True,
                                 show_pred=rows == "seg+pred" or bool(S),
                                 gamma=gamma, near=near, far=far, device=dev)
    basis = _basis(p, theta, phi, dev)
    axis = sw.dominant_axis(basis)
    pred = np.roll(seg, 3, axis=0) if rows == "seg+pred" else None
    mixed, seg_s, pred_s = sw.prepare_sweep_volumes(
        torch.as_tensor(disp, device=dev), torch.as_tensor(seg, device=dev),
        None if pred is None else torch.as_tensor(pred, device=dev), p, axis)
    kw = {}
    if crop:
        nk, na, nb = mixed.shape
        cut = (slice(3, nk - 5), slice(4, na - 2), slice(2, nb - 6))
        mixed, seg_s = mixed[cut].contiguous(), seg_s[cut].contiguous()
        pred_s = None if pred_s is None else pred_s[cut].contiguous()
        kw = dict(z_offset=3, nk_global=nk, ab_offset=(4, 2),
                  inplane_global=(na, nb))
    geom = sw.content_geometry(basis, p, tuple(mixed.shape), axis, O_, 96, 80,
                               **kw)
    k1 = composite.stage1(mixed, seg_s, pred_s, geom, p, axis, O_,
                          kw.get("z_offset"), kw.get("nk_global"))
    fkw = {}
    if S:
        K = k1.t1b.shape[0]
        field = torch.randint(0, 10, (-(-K // Kf), O_ // S, O_ // S),
                              generator=torch.Generator(dev).manual_seed(1),
                              device=dev, dtype=torch.uint8)
        fkw = dict(pred_field=field, field_stride=S, field_kstride=Kf)
    flags = sw.static_flags(p)
    before = (composite.composite_planes.launches,
              composite.composite_planes.field_launches,
              composite.composite_planes.count_launches)
    C0, T0 = composite.composite_planes(*k1, *flags, **fkw)
    C1, T1, planes = composite.composite_planes(*k1, *flags, **fkw,
                                                count_planes=True)
    torch.cuda.synchronize()
    assert (composite.composite_planes.launches,
            composite.composite_planes.field_launches,
            composite.composite_planes.count_launches) == \
        (before[0] + 2, before[1] + (2 if S else 0), before[2] + 1)
    ref = composite.composite_planes_plain(*k1, *flags, **fkw)
    assert int(ref.planes.sum()) > 0
    if S:
        assert int(ref.n_labeled[1]) > 0
    assert float((C0 - ref.C).abs().max()) <= 1e-3
    assert float((T0 - ref.T).abs().max()) <= 1e-3
    assert torch.equal(C0, C1) and torch.equal(T0, T1)
    assert torch.equal(planes, ref.planes)


@pytest.mark.cuda
def test_neural_fused_frame_matches_scan_and_counts():
    """NeuralBratsRenderer('auto') resolves to 'fused' on the card; its
    frame launches K1 and K2 once each and matches the plain scan over the
    same prepared frame and field."""
    dev = _card()
    mods, seg = synthetic_case(SHAPE, seed=3)
    disp = np.stack([percentile_normalize(m) for m in mods])
    zsc = np.stack([zscore_nonzero(m.copy()) for m in mods])
    model = build_model(ModelConfig(hidden_dims=(16, 16), fourier_freqs=4),
                        num_modalities=4)
    params = model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        params[-1].b += torch.tensor([0.0, 0.4, 0.5, 0.45])
    p = rp.default_render_params(SHAPE, show_seg=True, show_pred=True)
    basis = OrbitalCamera(radius=rp.default_camera_radius(p, SHAPE),
                          theta=0.85, phi=0.85).basis()
    r = neural_march.NeuralBratsRenderer(disp, zsc, seg, model, params,
                                         width=96, height=96, sweep_res=128,
                                         pred_stride=2)
    assert r.backend == "fused" and r.device.type == "cuda"
    k1, k2 = composite.composite_planes.launches, warp.warp_screen.launches
    img = r.render(basis, p)
    torch.cuda.synchronize()
    assert (composite.composite_planes.launches - k1,
            warp.warp_screen.launches - k2) == (1, 1)
    assert img.shape == (96, 96, 3) and bool(torch.isfinite(img).all())
    fr = r.sweep_frame(basis, p)
    field = neural_march.frame_field(model, r.params, fr, 2)
    C = neural_march._render_neural_fused(fr, model, r.params, 2,
                                          field=field)
    fused = sw.warp_to_screen(C, fr.geom, fr.basis, fr.axis, 96, 96,
                              fr.p.bg_color)
    scan = neural_march._render_neural_axis(fr, model, r.params, 96, 96, 2,
                                            field=field)
    assert float((fused - scan).abs().max()) <= 3e-3


def _mlp_case(dims, B, Oa, Ob, dev, seed=0):
    """An INR (6 harmonics, 4 intensities, 4 classes, the last bias nudged
    so several classes win) and one block of inputs: intensities in the
    resample's (M, B, Oa, Ob) buffer seen as (B, Oa, Ob, M), coordinates in
    [-1, 1]."""
    model = build_model(ModelConfig(hidden_dims=dims, fourier_freqs=6),
                        num_modalities=4)
    params = model.init(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        params[-1].b += torch.tensor([0.0, 0.4, 0.5, 0.45])
    g = torch.Generator().manual_seed(seed + 1)
    intens = torch.randn((4, B, Oa, Ob), generator=g).to(dev)
    coords = [(torch.rand(shape, generator=g) * 2 - 1).to(dev)
              for shape in ((B, Oa), (B, Ob), (B,))]
    return model, params.to(dev), intens.permute(1, 2, 3, 0), coords


# K3 against its plain version. The two sum in other orders (the tensor
# cores against the SIMT GEMM), so where a float32 sum lies at a bf16
# rounding boundary they round a hidden state to neighbouring bf16 values,
# one step (2^-8 to 2^-7 of it) apart; the logits move by that step times
# the weights downstream, and several states may differ along the tail
# (measured on the card: labels off at gaps of up to 6.1e-3 of the logits'
# scale). Labels must agree where the plain top-two logit gap exceeds 2^-5
# of the logits' largest magnitude, and overall but at most 1e-3 of the
# points; a wrong kernel parts at gaps of the logits' own size.
@pytest.mark.cuda
@pytest.mark.parametrize("dims,B,Oa,Ob,inv_order", [
    ((16,) * 4, 16, 256, 256, (0, 1, 2)),
    ((64,) * 4, 16, 256, 256, (1, 2, 0)),
    ((256,) * 4, 16, 256, 256, (1, 0, 2)),
    ((128,) * 4, 5, 40, 24, (0, 1, 2)),
    ((64, 32, 48), 3, 33, 70, (1, 2, 0)),
])
def test_k3_kernel_matches_plain(dims, B, Oa, Ob, inv_order):
    dev = _card()
    model, params, intens, (a_n, b_n, k_n) = _mlp_case(dims, B, Oa, Ob, dev)
    K = model.cfg.fourier_freqs
    n0 = neural_march.separable_mlp.launches
    with torch.no_grad():
        logits = neural_march.separable_logits_plain(params, K, intens, a_n,
                                                     b_n, k_n, inv_order)
        got = neural_march.separable_mlp(params, K, intens, a_n, b_n, k_n,
                                         inv_order)
    torch.cuda.synchronize()
    assert neural_march.separable_mlp.launches == n0 + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, Oa, Ob)
    want = logits.argmax(-1)
    top2 = logits.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    scale = float(logits.abs().max())
    off = got.long() != want
    worst = float(gap[off].max()) / scale if bool(off.any()) else 0.0
    assert worst <= 2 ** -5, f"a label off at a top-two gap {worst:.3e} x " \
        f"{scale:.3f}; {int(off.sum())} off"
    assert float(off.float().mean()) <= 1e-3
    assert len(torch.unique(want)) > 1


@pytest.mark.cuda
def test_k3_labels_every_field_point():
    """predict_field on the card labels every point through K3, one launch
    a block of planes: ``field.kernel_points`` equals ``field.points``."""
    dev = _card()
    mods, seg = synthetic_case(SHAPE, seed=3)
    disp = np.stack([percentile_normalize(m) for m in mods])
    zsc = np.stack([zscore_nonzero(m.copy()) for m in mods])
    model, params, *_ = _mlp_case((64,) * 4, 1, 1, 1, "cpu")
    p = rp.default_render_params(SHAPE, show_seg=True, show_pred=True)
    basis = OrbitalCamera(radius=rp.default_camera_radius(p, SHAPE),
                          theta=0.85, phi=0.85).basis()
    r = neural_march.NeuralBratsRenderer(disp, zsc, seg, model, params,
                                         width=96, height=96, sweep_res=128,
                                         pred_stride=2)
    fr = r.sweep_frame(basis, p)
    profiling.reset_counters()
    n0 = neural_march.separable_mlp.launches
    field = neural_march.frame_field(model, r.params, fr, 2, block=8)
    torch.cuda.synchronize()
    c = profiling.counters()
    assert c["field.kernel_points"] == c["field.points"] == field.numel()
    assert neural_march.separable_mlp.launches - n0 == -(-field.shape[0]
                                                         // 8)
    assert field.dtype == torch.int32 and int(field.min()) >= 0 \
        and int(field.max()) < 4


@pytest.mark.cuda
@pytest.mark.parametrize("theta,phi,width,height,o_res,radius,fov,c_offset", [
    (0.0, 1.5, 96, 80, O, 1.0, 55.0, 0),
    (1.6, 1.4, 96, 80, O, 1.0, 55.0, 0),
    (0.3, 0.1, 96, 80, O, 1.0, 55.0, 0),
    (3.9, 2.6, 96, 80, O, 1.0, 55.0, 0),
    (0.7, 1.1, 97, 61, O, 1.0, 55.0, 0),
    (1.2, 0.9, 100, 70, O, 1.0, 55.0, 0),
    (0.85, 0.85, 96, 80, 256, 1.0, 55.0, 0),
    (0.5, 1.0, 96, 80, O, 0.6, 100.0, 0),
    (0.3, 1.2, 97, 61, 2, 1.0, 55.0, 0),
    (0.7, 1.1, 96, 80, 127, 1.0, 55.0, 0),
    (0.6, 1.2, 96, 80, 127, 1.0, 55.0, 1),
], ids=["face", "side", "top", "back", "odd-97x61", "ragged-100x70",
        "diagonal-minified-O256", "eye-inside-behind", "O2", "odd-O127",
        "unaligned-C-O127"])
def test_k2_kernel_matches_plain(theta, phi, width, height, o_res, radius,
                                 fov, c_offset):
    """K2 against its plain version: max abs error <= 1e-3, and exactly the
    background wherever the plain version's pixel is off the intermediate
    (the kernel's maps round as PyTorch's; a culled tile or an invalid
    pixel loads nothing). The cases reach the scalar-store path (W % 4 !=
    0), ragged tiles, an intermediate larger than the screen (minified), a
    wide field of view from inside the volume with part of the screen at
    t_base <= 0 and rays near the plane's horizon, O = 2, an odd O, and a C
    that is a view 4 bytes into its storage."""
    dev = _card()
    p = rp.default_render_params(SHAPE, bg_color=(0.1, 0.0, 0.3), device=dev)
    basis = OrbitalCamera(
        radius=rp.default_camera_radius(p, SHAPE) * radius, theta=theta,
        phi=phi, fov_y=np.radians(fov), min_radius=0.01).basis(dev)
    axis = sw.dominant_axis(basis)
    dims = tuple(SHAPE[o] for o in sw._ORDER[axis])
    geom = sw.content_geometry(basis, p, dims, axis, o_res, width, height)
    s = sw.warp_scalars(geom, basis, p.bg_color)
    C = torch.rand(o_res * o_res * 3 + c_offset, device=dev,
                   generator=torch.Generator(dev).manual_seed(0))
    C = C[c_offset:].view(o_res, o_res, 3)
    before = warp.warp_screen.launches
    out = warp.warp_screen(C, s, axis, width, height)
    torch.cuda.synchronize()
    assert warp.warp_screen.launches == before + 1
    ref = warp.warp_screen_plain(C, s, axis, width, height)
    _, _, valid = warp.screen_maps(s, axis, o_res, width, height)
    assert out.shape == (height, width, 3)
    assert bool(valid.any()) and not bool(valid.all())
    assert float((out - ref).abs().max()) <= 1e-3
    assert torch.equal(out[~valid], ref[~valid])
    assert bool((out[~valid] == s[21:24]).all())
    if fov > 55.0:
        assert bool((_t_base(s, axis, width, height) <= 0).any())


def _t_base(s, axis, width, height):
    """(H, W): the ray parameter of each pixel's hit on the base plane, as
    ``warp.screen_maps`` computes it (the ray's sweep component dk from the
    packed camera's right, up and forward, axis ``axis``)."""
    f = 1.0 / torch.tan(0.5 * s[12])
    xs = (torch.arange(width, device=s.device) + 0.5) / width * 2.0 - 1.0
    ys = (torch.arange(height, device=s.device) + 0.5) / height * 2.0 - 1.0
    cx = (xs * (width / height) / f)[None, :]
    cy = (-ys / f)[:, None]
    dk = cx * s[3 + axis] + cy * s[6 + axis] + s[9 + axis]
    denom = torch.where(dk.abs() < 1e-6, torch.full_like(dk, 1e-6), dk)
    return (s[13] - s[14]) / denom


@pytest.mark.cuda
def test_sweep_cuda_frame_matches_scan_and_counts(scene):
    dev = _card()
    disp, seg = scene
    p = rp.default_render_params(SHAPE, show_seg=True)
    basis = OrbitalCamera(radius=rp.default_camera_radius(p, SHAPE),
                          theta=0.85, phi=0.85).basis()
    fused = BratsRenderer(disp, seg, None, width=96, height=96, sweep_res=128)
    assert fused.backend == "sweep_cuda" and fused.device.type == "cuda"
    scan = BratsRenderer(disp, seg, None, width=96, height=96, sweep_res=128,
                         backend="sweep", device=dev)
    k1, k2 = composite.composite_planes.launches, warp.warp_screen.launches
    img = fused.render(basis, p)
    torch.cuda.synchronize()
    assert (composite.composite_planes.launches - k1,
            warp.warp_screen.launches - k2) == (1, 1)
    ref = scan.render(basis, p)
    assert float((img - ref).abs().max()) <= 3e-3


@pytest.mark.cuda
def test_k2_stream_handle_is_the_current_stream():
    """K2 launches on the handle of ``warp.current_stream_handle``, which
    reads it through a private torch call: this CUDA build has that call,
    and it gives the current stream's handle, the default one and one
    entered by ``torch.cuda.stream``."""
    dev = _card()
    assert hasattr(torch._C, "_cuda_getCurrentRawStream"), torch.__version__
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    assert warp.current_stream_handle(index) == \
        torch.cuda.current_stream(index).cuda_stream
    side = torch.cuda.Stream(index)
    with torch.cuda.stream(side):
        assert warp.current_stream_handle(index) == side.cuda_stream


@pytest.mark.cuda
def test_wrappers_refuse_bad_cuda_input():
    dev = _card()
    C = torch.zeros((8, 8, 3), device=dev)
    s = torch.zeros(24, device=dev)
    with pytest.raises(ValueError):
        warp.warp_screen(C.transpose(0, 1), s, 0, 4, 4)
    with pytest.raises(ValueError):
        warp.warp_screen(C, s.cpu(), 0, 4, 4)
    model, params, intens, (a_n, b_n, k_n) = _mlp_case((64,) * 2, 2, 8, 8,
                                                       dev)
    K = model.cfg.fourier_freqs
    with torch.no_grad():
        with pytest.raises(ValueError):  # a column of a (B, Oa, 2) buffer
            neural_march.separable_mlp(params, K, intens, a_n,
                                       torch.zeros((2, 16), device=dev)[:, ::2],
                                       k_n, (0, 1, 2))
        with pytest.raises(ValueError):
            neural_march.separable_mlp(params, K, intens, a_n, b_n,
                                       k_n.cpu(), (0, 1, 2))
        _, wide, *_ = _mlp_case((272,), 1, 1, 1, dev)
        with pytest.raises(ValueError, match="multiples of 16"):
            neural_march.separable_mlp(wide, K, intens, a_n, b_n, k_n,
                                       (0, 1, 2))
    with pytest.raises(RuntimeError, match="no backward"):
        neural_march.separable_mlp(params, K, intens, a_n, b_n, k_n,
                                   (0, 1, 2))


@pytest.mark.cuda
def test_kernels_refuse_grad_and_scan_remat_trains(scene):
    """K1 and K2 have no backward: with grad enabled they refuse an input
    that requires grad (a frame through them would cut the graph without
    an error); under no_grad they render. 'scan_remat' warps with the
    plain gather on the card, so its gradient reaches the volume, equal to
    the unchecked sweep's."""
    dev = _card()
    disp, _ = scene
    p = rp.default_render_params(SHAPE, show_seg=False)
    basis = _basis(p, 0.6, 1.1, dev)
    mods = torch.tensor(disp, device=dev, requires_grad=True)
    for comp in ("scan", "fused"):
        with pytest.raises(RuntimeError, match="no backward"):
            sw.render_brats(mods, None, None, basis, p, 64, 64, out_res=O,
                            composite=comp, device=dev)
        with torch.no_grad():
            img = sw.render_brats(mods, None, None, basis, p, 64, 64,
                                  out_res=O, composite=comp, device=dev)
        assert bool(torch.isfinite(img).all())
    C = torch.zeros((8, 8, 3), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        warp.warp_screen(C, torch.zeros(24, device=dev), 0, 4, 4)

    probe = torch.cos(torch.arange(64.0, device=dev))[None, :]
    grads = []
    for remat in (True, False):
        m = torch.tensor(disp, device=dev, requires_grad=True)
        pd = p.to(dev)
        axis = sw.dominant_axis(basis)
        vols = sw.prepare_sweep_volumes(m, None, None, pd, axis)
        geom = sw.content_geometry(basis, pd, tuple(vols[0].shape), axis, O,
                                   64, 64)
        Cs, _ = sw.sweep_composite(*vols, geom, pd, axis, O, 1, False, False,
                                   remat=remat)
        img = sw.warp_to_screen(Cs, geom, basis, axis, 64, 64, pd.bg_color,
                                gather=True)
        (img[..., 0] * probe).sum().backward()
        grads.append(m.grad)
    assert float(grads[0].abs().max()) > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_roi_policy_frame_matches_cpu():
    """The ROI policy renderer (no kernel of its own: PyTorch on the card)
    against its CPU path on the same scene and the committed policy: the
    full-resolution policy frame, the foveated frame and B1, within 1e-3
    (cuBLAS and the CPU may round a bf16 product's sum differently, which
    moves a fine sample); then one training step's gradient on the card,
    finite and pointing where the CPU's does (cosine >= 0.99 over all the
    policy's parameters: a moved sample changes single terms of it)."""
    from mri_raytracer_tpu_torch.eval import roi_protocol
    from mri_raytracer_tpu_torch.ops import roi_policy

    dev = _card()
    out = {}
    for d in ("cpu", dev):
        sc = roi_protocol.build_scenes((32, 32, 28), device=d)[0]
        st = roi_protocol.scene_tuple(sc)
        p = sc["params"]
        pol = roi_policy.load_policy("docs/roi_policy.npz", device=d)
        bv = torch.as_tensor(roi_protocol.make_orbit_views(
            sc["radius"], 1)[0]).to(d)
        corners = torch.as_tensor(roi_policy.roi_world_corners(
            sc["P"], sc["B"], p), device=d)
        kw = dict(probe_stride=4, rho_upsample=2, block=16)
        with torch.no_grad():
            full, _ = roi_policy.render_policy(pol, *st, bv, p, 96, 64, 16,
                                               40, **kw)
            fov, _ = roi_policy.render_policy_foveated(
                pol, *st, bv, p, 96, 64, corners, 16, 40, **kw)
            b1, _ = roi_policy.render_fixed(st[0], bv, p, 96, 64, 40,
                                            block=16)
        with torch.no_grad():
            ref, _ = roi_policy.render_fixed(st[0], bv, p, 48, 48, 96)
        tp = {k: v.clone().requires_grad_(True) for k, v in pol.items()}
        loss, _ = roi_policy.policy_loss(tp, st, bv, ref, p, 48, 48, 12, 24,
                                         roi_policy.PolicyConfig(),
                                         probe_stride=3)
        loss.backward()
        out[str(d)] = (full, fov, b1, {k: v.grad for k, v in tp.items()})
    cpu, card = out["cpu"], out[str(dev)]
    for a, b in zip(cpu[:3], card[:3]):
        assert b.device.type == "cuda" and bool(torch.isfinite(b).all())
        assert float((a - b.cpu()).abs().max()) <= 1e-3
    g = torch.cat([card[3][k].cpu().reshape(-1) for k in sorted(card[3])])
    want = torch.cat([cpu[3][k].reshape(-1) for k in sorted(cpu[3])])
    assert bool(torch.isfinite(g).all()) and float(want.abs().max()) > 0
    assert float(torch.nn.functional.cosine_similarity(g, want, dim=0)) \
        >= 0.99


@pytest.mark.cuda
def test_secondary_renderers_match_cpu():
    """Each secondary renderer (no kernel of its own: PyTorch on the card)
    once on the card against its CPU path on the same inputs: the grid
    modes, the SDF frame, the noise frame with the pointer, the brute and
    BVH mesh frames and the hybrid frame with shadows and skip. Frames
    without a discrete decision (composite, MIP, SDF colours) within 1e-4;
    with one (iso hits, mesh hits, noise, shadows), decisions agree on
    >= 99.9% of pixels and the values within 1e-4 where they agree."""
    from mri_raytracer_tpu_torch.data.synthetic import synthetic_u8_volume
    from mri_raytracer_tpu_torch.ops import noise2d, sdf
    from mri_raytracer_tpu_torch.render import hybrid, mesh
    from mri_raytracer_tpu_torch.render.volume import GridVolumeRenderer

    dev = _card()
    vol8 = synthetic_u8_volume((40, 36, 32), seed=0)
    mods, seg = synthetic_case((40, 36, 32), seed=1)
    vol = np.stack([percentile_normalize(m) for m in mods]).mean(0)
    verts, tris = hybrid.extract_boundary_mesh(seg > 0)
    cam = OrbitalCamera(radius=3.0, theta=0.8, phi=1.1)

    def frames(d):
        g = GridVolumeRenderer(vol8, 64, 48, device=d)
        out = {m: g.render(cam.basis(), step_count=48.0, mode=m)
               for m in ("composite", "mip", "iso")}
        out["sdf"] = sdf.render_sdf(cam.basis(), sdf.default_sdf_params(),
                                    64, 48, device=d)
        out["noise"] = noise2d.render_noise_demo(64, 48, 0.4, (30.0, 20.0),
                                                 10.0, device=d)
        for m in ("brute", "bvh"):
            out[m] = mesh.MeshRenderer(verts, tris, 64, 48, mode=m,
                                       device=d).render(cam.basis())
        out["hybrid"] = hybrid.HybridRenderer(
            vol, seg > 0, 64, 48, max_steps=64, device=d).render(cam.basis())
        return {k: v.cpu() for k, v in out.items()}

    cpu, card = frames("cpu"), frames(dev)
    for k in cpu:
        diff = (cpu[k] - card[k]).abs().amax(-1)
        assert bool(torch.isfinite(card[k]).all()), k
        if k in ("composite", "mip", "sdf"):
            assert float(diff.max()) <= 1e-4, (k, float(diff.max()))
        else:
            assert float((diff <= 1e-4).float().mean()) >= 0.999, k
