"""The port's frame accounting against the JAX package, on the CPU: K1c's
executed-plane map (the plain version; the kernel is held to it in
tests/test_torch_port_cuda.py), ``render_prepared(echo=)``,
``BratsRenderer.executed_planes`` / ``frame_stats`` / ``warmup``, and
``utils.arith``.

Scene of tests/test_arith.py (24x24x20, seed 1, O = 128, seg on, no gamma,
no clip). The port counts per pixel the (pixel, plane) pairs that
composited; the Pallas kernel (interpret mode) counts per (tile_i x O)
tile the planes whose compute ran, so band by band the port's largest
count is bounded by the JAX tile count: an exact relation, no tolerance.
``frame_flops`` is compared for equality: both sides do the same float64
arithmetic on the same map."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.data import brats as jbrats, synthetic as jsyn
from mri_raytracer_tpu.ops import shearwarp as jsw
from mri_raytracer_tpu.ops.pallas_composite import sweep_composite_pallas
from mri_raytracer_tpu.render import params as jrp
from mri_raytracer_tpu.render.brats import BratsRenderer as JRenderer
from mri_raytracer_tpu.render.camera import OrbitalCamera as JCam
from mri_raytracer_tpu.utils import arith as jarith
from mri_raytracer_tpu_torch.ops import composite, shearwarp as tsw
from mri_raytracer_tpu_torch.render import params as trp
from mri_raytracer_tpu_torch.render.brats import BratsRenderer
from mri_raytracer_tpu_torch.render.camera import OrbitalCamera as TCam
from mri_raytracer_tpu_torch.utils import arith

torch.set_num_threads(2)
SHAPE = (24, 24, 20)
O = 128
TILE_I = 8


@pytest.fixture(scope="module")
def scene():
    mods, seg = jsyn.synthetic_case(SHAPE, seed=1)
    disp = np.stack([jbrats.percentile_normalize(m) for m in mods])
    return disp, seg.astype(np.int32)


def _cam_kw(theta, phi):
    p = jrp.default_render_params(SHAPE, show_seg=True)
    return dict(radius=jrp.default_camera_radius(p, SHAPE), theta=theta,
                phi=phi)


def _port_k1(scene, theta=0.7, phi=1.1):
    """Stage 1 at the test_arith pose (no crop), port side."""
    disp, seg = scene
    p = trp.default_render_params(SHAPE, show_seg=True)
    b = TCam(**_cam_kw(theta, phi)).basis()
    axis = tsw.dominant_axis(b)
    ms, ss, _ = tsw.prepare_sweep_volumes(torch.from_numpy(disp),
                                          torch.from_numpy(seg), None, p,
                                          axis)
    geom = tsw.sweep_geometry(b, p, tuple(ms.shape), axis, O)
    return composite.stage1(ms, ss, None, geom, p, axis, O), axis


@pytest.fixture(scope="module")
def plain(scene):
    k1, _ = _port_k1(scene)
    return k1, composite.composite_planes_plain(*k1, False, False)


def test_k1c_plain_map(plain):
    k1, out = plain
    K = k1.t1b.shape[0]
    assert out.planes.dtype == torch.int32 and out.planes.shape == (O, O)
    assert int(out.planes.min()) >= 0 and int(out.planes.max()) <= K
    assert int(out.planes.max()) > 0
    assert int(out.planes.sum()) == int(out.n_active) > 0
    # The wrapper's count (CPU tensors: the plain version) and the image:
    # C and T are the same with the count on and off.
    C0, T0 = composite.composite_planes(*k1, False, False)
    C1, T1, planes = composite.composite_planes(*k1, False, False,
                                                count_planes=True)
    assert torch.equal(planes, out.planes)
    assert torch.equal(C0, C1) and torch.equal(T0, T1)
    assert torch.equal(C0, out.C) and torch.equal(T0, out.T)


def test_k1c_bounded_by_jax_tile_counts(scene, plain):
    """Band by band (8-row tiles forced through vmem_budget): the port's
    largest per-pixel count <= the JAX band count <= K, and the port's
    total <= the JAX total."""
    disp, seg = scene
    p = jrp.default_render_params(SHAPE, show_seg=True)
    b = JCam(**_cam_kw(0.7, 1.1)).basis()
    axis = jsw.dominant_axis(b)
    mixed = jsw.blend_modalities(jnp.asarray(disp), p.vol_enabled,
                                 p.vol_weight)
    ms = jsw._perm_volume(mixed, axis)
    ss = jsw._perm_volume(jnp.asarray(seg), axis)
    geom = jsw.sweep_geometry(b, p, ms.shape, axis, O)
    Na = ms.shape[1]
    # _make_kernel's VMEM sizing (pallas_composite.py:425-440) with 8 rows:
    # 20 f32 (tile_i, O) planes plus the seg-fused stream buffers.
    budget = 20 * 4 * TILE_I * O + 2 * (2 * Na * O + 8 * 128) * 2
    _, counts = sweep_composite_pallas(ms, ss, None, geom, p, axis, O,
                                       use_gamma=False, use_clip=False,
                                       interpret=True, echo="planes",
                                       vmem_budget=budget)
    jmap = np.asarray(counts)
    k1, out = plain
    K = k1.t1b.shape[0]
    assert K == ms.shape[0] + 1
    tmap = out.planes.numpy()
    bands = jmap.reshape(O // TILE_I, TILE_I, O)
    # Each 8-row band is one tile, its count broadcast over the tile.
    assert (bands == bands[:, :1, :1]).all()
    jband = bands[:, 0, 0]
    tband = tmap.reshape(O // TILE_I, TILE_I * O).max(axis=1)
    assert (tband <= jband).all() and (jband <= K).all()
    assert tmap.sum(dtype=np.int64) <= jmap.sum(dtype=np.float64)
    assert (tband < jband).any()  # the per-pixel count is tighter


def test_frame_flops_match_jax(plain):
    k1, out = plain
    counts = out.planes.numpy()
    K, Na, _ = k1.t1b.shape
    stats = {"out_res": O, "planes": K, "Na": Na, "Nb": SHAPE[1], "axis": 2,
             "has_seg": True, "has_pred": False}
    jstats = dict(stats, warp_win=(112, 256))
    for m in (None, counts):
        got = arith.frame_flops(stats, 128, 128, executed_planes=m)
        want = jarith.frame_flops(jstats, 128, 128, executed_planes=m)
        for k in ("flops_stage1", "flops_stage2", "steps_per_ray_eff",
                  "steps_per_ray_max", "stage2_exact"):
            assert got[k] == want[k], k
        assert got["flops_warp"] == 0.0 and not got["warp_mxu"]
        assert got["flops_total"] == got["flops_stage1"] + got["flops_stage2"]
    # Exact stage 2 is bounded by the static count.
    exact = arith.frame_flops(stats, 128, 128, executed_planes=counts)
    assert exact["flops_stage2"] < arith.frame_flops(stats, 128,
                                                     128)["flops_stage2"]


@pytest.mark.parametrize("theta,phi", [(0.7, 1.1), (1.9, 0.4)])
def test_frame_stats_match_jax(scene, theta, phi):
    disp, seg = scene
    pj = jrp.default_render_params(SHAPE, show_seg=True)
    pt = trp.default_render_params(SHAPE, show_seg=True)
    rj = JRenderer(jnp.asarray(disp), jnp.asarray(seg), None, width=96,
                   height=80, backend="sweep")
    rt = BratsRenderer(disp, seg, None, width=96, height=80,
                       backend="sweep_cuda", device="cpu")
    sj = rj.frame_stats(JCam(**_cam_kw(theta, phi)).basis(), pj)
    st = rt.frame_stats(TCam(**_cam_kw(theta, phi)).basis(), pt)
    assert set(sj) - set(st) == {"warp_win"} and not set(st) - set(sj)
    assert {k: sj[k] for k in st} == st


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.4e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12)])
def test_peaks_and_mfu(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert arith.peak_flops() == peak
    assert arith.device_peaks().bf16 == peak
    out = arith.mfu(1e11, 100.0)
    assert out["tflops_per_s"] == pytest.approx(10.0)
    assert out["mfu"] == pytest.approx(1e13 / peak)
    assert out["peak_tflops"] == pytest.approx(peak / 1e12)


def test_unknown_card_warns(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    with pytest.warns(UserWarning, match="unknown card"):
        assert arith.peak_flops() == 989.4e12


def test_executed_planes_and_echo(scene):
    disp, seg = scene
    p = trp.default_render_params(SHAPE, show_seg=True)
    basis = TCam(**_cam_kw(0.85, 0.85)).basis()
    r = BratsRenderer(disp, seg, None, width=64, height=64,
                      backend="sweep_cuda", sweep_res=128, device="cpu")
    got = r.executed_planes(basis, p)
    fr = r.sweep_frame(basis, p)
    geom = tsw.content_geometry(fr.basis, fr.p, tuple(fr.mixed_s.shape),
                                fr.axis, fr.out_res, 64, 64, fr.z_offset,
                                fr.nk_global, fr.ab_offset, fr.inplane_global)
    k1 = composite.stage1(fr.mixed_s, fr.seg_s, fr.pred_s, geom, fr.p,
                          fr.axis, fr.out_res, fr.z_offset, fr.nk_global)
    want = composite.composite_planes_plain(*k1, fr.use_gamma,
                                            fr.use_clip).planes
    assert got.dtype == np.int32 and got.shape == (fr.out_res, fr.out_res)
    np.testing.assert_array_equal(got, want.numpy())
    assert got.max() > 0
    with pytest.raises(RuntimeError, match="sweep_cuda"):
        BratsRenderer(disp, seg, None, width=64, height=64, backend="sweep",
                      device="cpu").executed_planes(basis, p)
    frame = fr._asdict()
    del frame["extra_s"]
    with pytest.raises(ValueError, match="fused"):
        tsw.render_prepared(width=64, height=64, composite="scan",
                            echo="planes", **frame)


def test_warmup_prepares_every_axis(scene):
    disp, seg = scene
    p = trp.default_render_params(SHAPE, show_seg=True)
    r = BratsRenderer(disp, seg, None, width=32, height=32, sweep_res=128,
                      device="cpu")
    r.warmup(p)
    assert sorted({key[0] for key in r._prep_cache}) == [0, 1, 2]
