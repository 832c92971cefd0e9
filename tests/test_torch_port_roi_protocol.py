"""The port's ROI evaluation protocol (``eval/roi_protocol.py``) and its CLI
(``apps/roi_policy_eval.py``) against the JAX package on the CPU.

Tolerances:
  * scene volumes (``build_scenes``, both suites at a small shape),
    packed volumes, feature rows, P, B, params, radius, views, orbits,
    ``median_ci``, ``psnr``, the reference cache's files: bit-equal; the
    mip's 2x2x2 mean: 1 float32 ulp (1.2e-7);
  * ``evaluate_success`` / ``anchor_sweep`` / ``write_report`` on the JAX
    package's measured sweeps (``docs/roi_results.json``): equal;
  * ``pareto_sweep`` on the scene of tests/test_roi_policy.py at 48 x 40:
    quality medians within 0.05 dB (PSNR / wPSNR) and 1e-4 (SSIM), steps
    rtol 1e-3: the policy images agree within 1e-3 (measured 4e-5; see
    tests/test_torch_port_roi_policy.py).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.data import brats as jbrats, synthetic as jsyn
from mri_raytracer_tpu.eval import roi_protocol as JP
from mri_raytracer_tpu.ops import roi_policy as J
from mri_raytracer_tpu.render import params as jrp
from mri_raytracer_tpu_torch import convert
from mri_raytracer_tpu_torch.apps import roi_policy_eval as app
from mri_raytracer_tpu_torch.eval import roi_protocol as TP
from mri_raytracer_tpu_torch.ops import roi_policy as T

torch.set_num_threads(2)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("suite", ["showcase", "adversarial"])
def test_build_scenes_bit_equal(suite):
    shape = (20, 18, 16)
    js = JP.build_scenes(shape, suite=suite)
    ts = TP.build_scenes(shape, suite=suite, device="cpu")
    assert [s["name"] for s in ts] == [s["name"] for s in js]
    for a, b in zip(js, ts):
        for k in ("mixed", "mixed_p", "feat_rows", "P", "B"):
            np.testing.assert_array_equal(_np(b[k]), _np(a[k]), err_msg=k)
        np.testing.assert_allclose(_np(b["mixed_p1"]), _np(a["mixed_p1"]),
                                   rtol=0, atol=1.2e-7)
        for f in b["params"]._fields:
            np.testing.assert_array_equal(_np(getattr(b["params"], f)),
                                          _np(getattr(a["params"], f)),
                                          err_msg=f)
        assert b["radius"] == a["radius"]
        assert b["mixed"].device.type == "cpu"


def test_views_and_statistics_equal():
    for held in (False, True):
        for a, b in zip(JP.make_views(1.7, held_out=held),
                        TP.make_views(1.7, held_out=held)):
            np.testing.assert_array_equal(b, a)
        jo = JP.make_orbit_views(2.1, 7, held_out=held)
        to = TP.make_orbit_views(2.1, 7, held_out=held)
        assert len(to) == 7
        for a, b in zip(jo, to):
            np.testing.assert_array_equal(b, a)
    xs = np.random.default_rng(0).normal(size=31)
    assert TP.median_ci(xs) == JP.median_ci(xs)
    assert TP.median_ci(xs, n_boot=50, seed=3) == \
        JP.median_ci(xs, n_boot=50, seed=3)
    for w in (96, 256, 720, 1920, 3840):
        s = JP.auto_probe_stride(w)
        assert TP.auto_probe_stride(w) == s
        assert TP.auto_rho_upsample(s) == JP.auto_rho_upsample(s)
    rng = np.random.default_rng(1)
    a, b = rng.random((6, 5, 3)), rng.random((6, 5, 3))
    w = rng.random((6, 5))
    assert TP.psnr(a, b) == JP.psnr(a, b)
    assert TP.psnr(a, b, w) == JP.psnr(a, b, w)
    assert TP._median_time(lambda: torch.zeros(3), 2, batches=2) > 0.0


def test_success_rule_and_report_equal(tmp_path):
    """The success rule, the anchor sweep and the markdown report on the JAX
    package's own 1080p sweeps (docs/roi_results.json)."""
    res = json.loads(open("docs/roi_results.json").read())
    for name, sweep in res["scenes"].items():
        for tb in (32, 64):
            assert TP.evaluate_success(sweep, tuned_budget=tb) == \
                JP.evaluate_success(sweep, tuned_budget=tb), name
        assert TP.anchor_sweep(sweep) == JP.anchor_sweep(sweep)
    no_pol = dict(res["scenes"]["tumor-a"],
                  policy=[dict(q, wpsnr=0.0) for q in
                          res["scenes"]["tumor-a"]["policy"]],
                  policy_fov=[])
    assert TP.evaluate_success(no_pol) == JP.evaluate_success(no_pol)
    for suite in ("showcase", "adversarial"):
        for lod_line in (None, "LOD line."):
            JP.write_report(res, tmp_path / "j.md", suite, lod_line)
            TP.write_report(res, tmp_path / "t.md", suite, lod_line)
            assert (tmp_path / "t.md").read_text() == \
                (tmp_path / "j.md").read_text()


@pytest.fixture(scope="module")
def scene():
    """The scene of tests/test_roi_policy.py, in both packages' forms."""
    mods, seg = jsyn.synthetic_case((32, 32, 28), seed=3)
    mixed = np.stack([jbrats.percentile_normalize(m) for m in mods]) \
        .mean(0).astype(np.float32)
    feats = J.build_feature_volumes(mixed, seg)
    pj = jrp.default_render_params(mixed.shape, show_seg=False)._replace(
        intensity_alpha=jnp.float32(1.0))
    rows = J.pack_feature_rows(mixed, feats)
    jsc = {"name": "t", "mixed": jnp.asarray(mixed),
           "feat_rows": jnp.asarray(rows), "P": jnp.asarray(feats["P"]),
           "B": jnp.asarray(feats["B"]), "params": pj,
           "radius": jrp.default_camera_radius(pj, mixed.shape)}
    tsc = {"name": "t", "mixed": torch.from_numpy(mixed),
           "feat_rows": torch.from_numpy(rows),
           "P": torch.from_numpy(feats["P"]),
           "B": torch.from_numpy(feats["B"]),
           "params": convert.render_params_from_numpy(pj._asdict()),
           "radius": jsc["radius"]}
    return jsc, tsc


def test_pareto_sweep_matches_jax(scene):
    jsc, tsc = scene
    pol = J.load_policy("docs/roi_policy.npz")
    tpol = T.load_policy("docs/roi_policy.npz")
    views = JP.make_views(jsc["radius"])[:2]
    kw = dict(budgets=[8, 16], width=48, height=40, ref_steps=64,
              n_frames=3, n_coarse=8, probe_stride=2, foveated=True)
    js = JP.pareto_sweep(pol, jsc, views, **kw)
    ts = TP.pareto_sweep(tpol, tsc, views, **kw)
    assert set(ts) == set(js)
    for k in ("budgets", "ref_steps", "width", "height", "quality_frames",
              "timing_frames", "probe_stride", "rho_upsample", "n_coarse",
              "block"):
        assert ts[k] == js[k], k
    for kind in ("baseline", "policy", "policy_fov"):
        for a, b in zip(js[kind], ts[kind]):
            assert b["n"] == a["n"] and b["ms"] > 0.0
            for m, tol in (("psnr", 0.05), ("wpsnr", 0.05), ("ssim", 1e-4)):
                assert abs(b[m] - a[m]) <= tol, (kind, m, a[m], b[m])
                assert np.allclose(b[m + "_ci"], a[m + "_ci"], rtol=0,
                                   atol=tol)
            assert np.isclose(b["steps"], a["steps"], rtol=1e-3)
    assert set(TP.evaluate_success(ts)) == set(JP.evaluate_success(js))


def test_reference_cache_shared(scene, tmp_path):
    """A reference frame cached by either package serves the other: the
    same file name (pose, volume content and transfer parameters) and the
    same array."""
    jsc, tsc = scene
    bv = JP.make_views(jsc["radius"])[1]
    ja = JP._render_ref(jsc, bv, jsc["params"], 24, 20, 32, None,
                        ref_cache=tmp_path / "j", tag="t")
    tb = TP._render_ref(tsc, bv, tsc["params"], 24, 20, 32, None,
                        ref_cache=tmp_path / "t", tag="t")
    jf, tf = sorted((tmp_path / "j").iterdir()), sorted(
        (tmp_path / "t").iterdir())
    assert [f.name for f in jf] == [f.name for f in tf] and len(jf) == 1
    np.testing.assert_allclose(np.load(tf[0]), np.load(jf[0]), rtol=0,
                               atol=1e-5)
    # Each reads the other's file back unchanged.
    jf[0].rename(tmp_path / "t" / jf[0].name)
    got = TP._render_ref(tsc, bv, tsc["params"], 24, 20, 32, None,
                         ref_cache=tmp_path / "t", tag="t")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tb.numpy(), np.asarray(ja), atol=1e-5)


def test_weight_map_and_metrics_match_jax(scene):
    jsc, tsc = scene
    bv = JP.make_views(jsc["radius"])[0]
    for w, h in ((45, 38), (48, 40)):  # not multiples of 4, and multiples
        jw = JP._wmap_for(jsc, jnp.asarray(bv), jsc["params"], w, h)
        tw = TP._wmap_for(tsc, torch.from_numpy(bv), tsc["params"], w, h)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    rng = np.random.default_rng(4)
    img = rng.random((40, 48, 3)).astype(np.float32)
    ref = np.clip(img + 0.01 * rng.normal(size=img.shape), 0, 1) \
        .astype(np.float32)
    a = JP._metrics_of(jnp.asarray(img), jnp.asarray(ref), jnp.asarray(jw))
    b = TP._metrics_of(torch.from_numpy(img), torch.from_numpy(ref), tw)
    np.testing.assert_allclose(b, a, rtol=1e-5)


def test_cli_tiny_cpu(tmp_path):
    """The protocol CLI end to end on the CPU at a tiny size: training, the
    sweep with held-out orbits, the LOD fine-tune and ablation, the report;
    its policy files load in JAX's load_policy."""
    out = tmp_path / "out"
    rc = app.main(["--cpu", "--shape", "16,16,12", "--width", "24",
                   "--height", "16", "--ref-steps", "32", "--budgets",
                   "8,12,16", "--train-steps", "3", "--train-res", "16",
                   "--quality-frames", "1", "--timing-frames", "3",
                   "--n-coarse", "6", "--block", "8", "--tuned-budget", "16",
                   "--out", str(out), "--ref-cache", str(tmp_path / "refs")])
    assert rc == 0
    res = json.loads((out / "roi_results.json").read_text())
    assert [v["scene"] for v in res["verdicts"]] == \
        ["tumor-a", "bonsai", "clouds", "noise", "tumor-b"]
    assert "lod_ablation" in res and res["resolution"] == [24, 16]
    assert res["device"] == "the CPU"
    assert (out / "ROI_RESULTS.md").read_text().startswith(
        "# ROI policy renderer")
    for name in ("roi_policy", "roi_policy_lod"):
        jp = J.load_policy(out / f"{name}.npz")
        assert jp["W2"].shape == (24, 3)
        assert json.loads((out / f"{name}_meta.json").read_text())["dims"] \
            == [8, 24, 3]
    assert len(list((tmp_path / "refs").iterdir())) > 0


def test_cli_needs_a_card(monkeypatch, tmp_path):
    """Without --cpu the CLI runs on the card, and exits 1 where there is
    none, before it builds or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert app.main(["--out", str(tmp_path / "o")]) == 1
    assert not (tmp_path / "o").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.build_scenes((8, 8, 8))
