"""The plain reference against the port, on the CPU at a small case."""

from __future__ import annotations

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import case, harness, orbit
from benchmark.reference import frame as ref_frame
from benchmark.reference import geometry as ref_geom
from benchmark.systems import viewer
from benchmark.tests import tiny


def test_reference_imports_neither_the_port_nor_jax():
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "import benchmark.reference.geometry, benchmark.reference.frame,"
            " benchmark.reference.field;"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(tiny.REPO)],
                         capture_output=True, text=True, timeout=120,
                         check=True, cwd=str(tiny.REPO / "benchmark"))
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "mri_raytracer_tpu",
                      "mri_raytracer_tpu_torch"}


def test_case_from_draws_is_the_synthetic_generator():
    """Fed numpy's draws in ``synthetic_case``'s order, the torch copy
    gives the port's case."""
    from mri_raytracer_tpu_torch.data import synthetic

    shape, seed = (20, 18, 14), 7
    rng = np.random.default_rng(seed)
    k, ph = [], []
    for _ in range(case.N_WAVES):
        k.append(rng.normal(0, 2.0, size=3).astype(np.float32))
        ph.append(rng.uniform(0, 2 * np.pi))
    center = rng.uniform(-0.25, 0.25, size=3).astype(np.float32)
    noise = np.stack([rng.normal(0, 8.0, size=shape).astype(np.float32)
                      for _ in range(4)])
    mods, seg = case.case_from_draws(
        shape, torch.tensor(np.stack(k)), torch.tensor(ph, dtype=torch.float32),
        torch.tensor(center), torch.tensor(noise / 8.0) * 8.0)
    want_mods, want_seg = synthetic.synthetic_case(shape, seed=seed)
    np.testing.assert_array_equal(seg.numpy(), want_seg)
    np.testing.assert_allclose(mods.numpy(), want_mods, rtol=1e-4, atol=0.05)


def test_normalizations_are_the_viewers():
    from mri_raytracer_tpu_torch.data import brats

    x = np.random.default_rng(3).gamma(2.0, 300.0, size=(30, 20, 10)) \
        .astype(np.float32)
    x[:5] = 0.0
    t = torch.tensor(x)
    np.testing.assert_allclose(case.percentile_normalize(t).numpy(),
                               brats.percentile_normalize(x), atol=2e-6)
    np.testing.assert_allclose(case.zscore_nonzero(t).numpy(),
                               brats.zscore_nonzero(x.copy()), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("theta,phi", [(0.6, 1.2), (3.0, 2.7), (0.0, 0.05)])
def test_orbit_basis_is_the_cameras(theta, phi):
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera

    cam = OrbitalCamera(radius=2.2, theta=theta, phi=phi,
                        fov_y=math.radians(55.0))
    for got, want in zip(orbit.basis(theta, phi, 2.2, math.radians(55.0)),
                         (*cam.get_basis(), cam.fov_y)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_orbit_reflects_phi_and_starts_at_bench_pose():
    o = json.loads((tiny.REPO / "benchmark" / "traffic" /
                    "orbit1024.json").read_text())["orbit"]
    assert orbit.pose(o, 0) == pytest.approx((0.6, 1.2))
    phis = [orbit.pose(o, i)[1] for i in range(2000)]
    assert min(phis) >= o["phi_lo"] - 1e-12
    assert max(phis) <= o["phi_hi"] + 1e-12
    assert orbit.pose(o, 10) == pytest.approx((0.9, 1.3))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _cell(root, name):
    c = harness.cell(root, name)
    return c, c.system.build(c.config, c.traffic, 11, "cpu"), \
        c.system.reference(c.config, c.traffic, 11, "cpu")


@pytest.mark.parametrize("name", ["tiny.seg", "tiny.inr"])
def test_geometry_is_the_ports(root, name):
    """The frozen crop and sweep geometry equal the port's, bit for bit."""
    from mri_raytracer_tpu_torch.ops import shearwarp as sw

    c, sut, ref = _cell(root, name)
    brats = getattr(sut.renderer, "brats", sut.renderer)
    for i in (0, 9, 40, 77):
        cam = ref.cam(i)
        fr = brats.sweep_frame(sut.basis(cam), sut.params)
        geom = sw.content_geometry(fr.basis, fr.p, tuple(fr.mixed_s.shape),
                                   fr.axis, fr.out_res, sut.width,
                                   sut.height, fr.z_offset, fr.nk_global,
                                   fr.ab_offset, fr.inplane_global)
        rfr = ref_geom.frame_sweep(cam[3], c.config["shape"], ref.box, ref.p,
                                   max(sut.width, sut.height))
        rgeom = ref_geom.content_geometry(viewer.cam_tensors(cam, "cpu"),
                                          ref.p, rfr, sut.width, sut.height)
        assert (rfr.axis, rfr.out_res) == (fr.axis, fr.out_res)
        mixed_s, _, _ = ref.volumes(rfr)
        assert torch.equal(mixed_s, fr.mixed_s)
        for a, b in zip(rgeom, geom):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("name", ["tiny.seg", "tiny.inr"])
def test_reference_frame_is_the_ports(root, name):
    c, sut, ref = _cell(root, name)
    sut.warmup()
    for i in (0, 5, 31, 64, 90):
        cam = ref.cam(i)
        got = sut.serve(sut.request(i))
        want, info = ref.frame(cam)
        assert got.shape == (sut.height, sut.width, 3)
        assert float(np.abs(got - want.numpy()).max()) <= 1e-6
        assert info["n_active"] > 0


def test_controls_differ_from_the_stated_precision(root):
    c, _, ref = _cell(root, "tiny.inr")
    cam = ref.cam(3)
    stated, _ = ref.frame(cam)
    for variant in c.system.controls(c.config):
        lower, _ = ref.frame(cam, ref_frame.CONTROLS[variant])
        assert float((lower - stated).abs().mean()) > 1e-5, variant
