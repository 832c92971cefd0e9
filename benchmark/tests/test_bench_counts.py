"""The frozen count module against ``chip_smoke.py`` and the frame's
definition (CPU)."""

from __future__ import annotations

import math
import sys

import numpy as np
import pytest

from benchmark import counts
from benchmark.systems import viewer
from benchmark.tests import tiny

sys.path.insert(0, str(tiny.REPO))
import chip_smoke  # noqa: E402

# The bench pose's shapes (PERF.md's kernel table): K, Na, O at 1024^2.
K, NA, O = 225, 224, 896


def test_constants_are_chip_smokes():
    for name in ("K1_OPS_PLANE", "K1_OPS_NEAREST", "K1_OPS_LABEL",
                 "K2_OPS_PIXEL"):
        assert getattr(counts, name) == getattr(chip_smoke, name)


def test_peaks_are_the_ports_table():
    from mri_raytracer_tpu_torch.utils import arith

    assert {k: tuple(v) for k, v in counts.PEAKS.items()} == \
        {k: tuple(v) for k, v in arith._PEAKS.items()}
    assert counts.peaks_for("NVIDIA H100 80GB HBM3") == \
        counts.PEAKS["H100 80GB HBM3"]
    assert counts.peaks_for("NVIDIA A100-SXM4-80GB") is None


@pytest.mark.parametrize("nbytes,ops", [(3.2e7, 1e9), (1e6, 4e9), (0, 0)])
def test_bound_is_chip_smokes(nbytes, ops):
    peaks = counts.PEAKS["H100 80GB HBM3"]
    assert counts.bound(peaks, nbytes, ops, peaks.fp32) == \
        chip_smoke.bound(peaks, nbytes, ops, peaks.fp32)


def test_k1a_cost_is_chip_smokes_formula():
    # chip_smoke.py:755-765, K1a with the seg rows, at the bench pose.
    n_active, n_labeled = 123_456_789, 4_567_890
    t1b_numel = K * NA * O
    pp_numel = K * 7
    want_bytes = (t1b_numel * 2 + 1 * t1b_numel + pp_numel * 4
                  + (16 + 32) * 4 + 3 * O * O * 4 + 4 * O * O * 4)
    want_ops = (n_active * (chip_smoke.K1_OPS_PLANE
                            + chip_smoke.K1_OPS_NEAREST)
                + n_labeled * chip_smoke.K1_OPS_LABEL)
    assert counts.k1_cost(K, NA, O, 1, 0, n_active, n_labeled) == \
        (want_bytes, want_ops)


def test_k1b_cost_is_chip_smokes_formula():
    # chip_smoke.py:1103-1107, K1b: seg rows and the field at stride 4.
    n_active, n_seg, n_field = 98_765_432, 1_234_567, 7_654_321
    field_numel = K * (O // 4) ** 2
    want_bytes = (K * NA * O * 2 + K * NA * O + field_numel + K * 7 * 4
                  + (16 + 32) * 4 + 3 * O * O * 4 + 4 * O * O * 4)
    want_ops = (n_active * (chip_smoke.K1_OPS_PLANE
                            + chip_smoke.K1_OPS_NEAREST)
                + (n_seg + n_field) * chip_smoke.K1_OPS_LABEL)
    assert counts.k1_cost(K, NA, O, 1, field_numel, n_active,
                          n_seg + n_field) == (want_bytes, want_ops)


def test_k2_cost_is_chip_smokes_formula():
    # chip_smoke.py:808-811, at 1024^2.
    n_touched, W, H = 749_796, 1024, 1024
    assert counts.k2_cost(n_touched, W, H) == (
        n_touched * 3 * 4 + 24 * 4 + H * W * 3 * 4,
        H * W * chip_smoke.K2_OPS_PIXEL)


def test_inr_widths_and_macs():
    model = {"hidden_dims": [64, 64, 64, 64], "fourier_freqs": 6,
             "num_classes": 4}
    widths = counts.inr_widths(model, 4)
    assert widths == [43, 64, 64, 64, 64, 4]
    assert counts.mlp_macs(widths) == 43 * 64 + 3 * 64 * 64 + 64 * 4


def _brute_samples(cam, width, height, vol_min, voxel, box):
    """Per pixel-centre ray, the integer planes of the sweep axis whose
    crossing lies inside the box, counted one by one."""
    eye, right, up, fwd, fov = (np.asarray(c, np.float64) for c in cam)
    ax = int(np.argmax(np.abs(fwd)))
    f = 1.0 / math.tan(0.5 * float(fov))
    aspect = width / height
    lo = vol_min + voxel * np.array([b[0] for b in box], np.float64)
    hi = vol_min + voxel * np.array([b[1] for b in box], np.float64)
    total = 0
    for y in range(height):
        for x in range(width):
            u = (x + 0.5) / width * 2 - 1
            v = (y + 0.5) / height * 2 - 1
            d = (u * aspect / f) * right + (-v / f) * up + fwd
            for k in range(box[ax][0], box[ax][1] + 1):
                t = (vol_min[ax] + k * voxel[ax] - eye[ax]) / d[ax]
                if t <= 0:
                    continue
                p = eye + t * d
                others = [a for a in range(3) if a != ax]
                if all(lo[a] <= p[a] <= hi[a] for a in others):
                    total += 1
    return total


@pytest.mark.parametrize("theta,phi", [(0.6, 1.2), (2.0, 0.5), (4.1, 2.2),
                                       (0.0, math.pi / 2), (0.3, 0.12)])
def test_frame_samples_counts_the_planes_each_ray_crosses(theta, phi):
    voxel = np.array([0.0075, 0.0075, 0.0075])
    dims = np.array([24, 24, 16])
    vol_min = -0.5 * voxel * dims
    box = [(0, 24), (4, 20), (0, 16)]
    from benchmark import orbit

    cam = orbit.basis(theta, phi, 0.3, math.radians(55.0))
    got = counts.frame_samples(cam, 24, 18, vol_min, voxel, box)
    want = _brute_samples(cam, 24, 18, vol_min, voxel, box)
    assert want > 0
    assert got == want


def _reference(root, sweep_res):
    import json

    cfg = json.loads((root / "benchmark" / "configs" /
                      "tiny_brats_inr.json").read_text())
    cfg["sweep_res"] = sweep_res
    traffic = json.loads((root / "benchmark" / "traffic" /
                          "tiny.json").read_text())
    return viewer.Reference(cfg, traffic, 20260, "cpu")


def test_frame_mfu_does_not_change_with_the_intermediate_resolution(
        tmp_path):
    """At a fixed screen, crop and stride, the nominal work (so the least
    time and frame_mfu's numerator) is the same whatever the intermediate
    resolution the renderer picks, while the intermediate itself does
    change."""
    root = tiny.make_root(tmp_path)
    peaks = counts.PEAKS["H100 80GB HBM3"]
    refs = {r: _reference(root, r) for r in (None, 16, 96)}
    for i in (0, 7, 23):
        cam = refs[None].cam(i)
        works = {r: ref.work(cam) for r, ref in refs.items()}
        assert len(set(works.values())) == 1
        least = {counts.least_time(w, peaks) for w in works.values()}
        assert len(least) == 1 and least.pop() > 0.0
        outs = {refs[r].frame(cam)[1]["O"] for r in (16, 96)}
        assert len(outs) == 2
