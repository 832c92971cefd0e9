"""The port's script CLIs (``mri_raytracer_tpu_torch/apps/``, ports of
``scripts/*.py``) against the JAX package, on the CPU at tiny sizes.

A JAX script's ``main`` runs here only where it takes an output directory
(``roi_report.py --docs``) or writes nothing (``roi_occupancy_bound.py``);
where a script writes into the repo's ``docs/`` unconditionally, the JAX
package functions it calls (or its helpers, imported) stand in for it.
Nothing here writes into ``docs/``: every output goes under ``tmp_path``.
Tolerances:
  * the certification oracle: 1e-4 (the oracle bar of
    tests/test_torch_port_renderer.py), its neural frames 3e-3 (the mode-2
    scan bar of tests/test_torch_port_neural.py), per-pose PSNR 0.5 dB;
  * the BraTS orbit frames: 3e-3 (the renderer bar);
  * the occupancy bounds: rtol 1e-3;
  * the ROI report and experiments.csv: byte-equal.
Timings are not compared.
"""

import dataclasses
import importlib.util
import json
import pathlib
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mri_raytracer_tpu.config import ModelConfig as JCfg
from mri_raytracer_tpu.data import brats as jbrats, synthetic as jsyn
from mri_raytracer_tpu.eval.inference import predict_volume as jpredict
from mri_raytracer_tpu.io.checkpoint import inspect_npz as j_inspect
from mri_raytracer_tpu.models.api import build_model as jbuild
from mri_raytracer_tpu.ops import neural_march as jnm, raymarch_xla as jrx
from mri_raytracer_tpu.ops import shearwarp as jsw
from mri_raytracer_tpu.render import params as jrp
from mri_raytracer_tpu.render.brats import BratsRenderer as JRenderer
from mri_raytracer_tpu.render.camera import OrbitalCamera as JCam
from mri_raytracer_tpu_torch import convert
from mri_raytracer_tpu_torch.apps import (bench_neural_march,
                                          bench_roi_overhead,
                                          demo_end_to_end,
                                          full_geometry_smoke,
                                          neural_psnr_cert, orbit_video,
                                          read_npz, roi_occupancy_bound,
                                          roi_report, roi_retime,
                                          roi_showcase_figures)
from mri_raytracer_tpu_torch.eval.inference import predict_volume as tpredict
from mri_raytracer_tpu_torch.io.checkpoint import save_object
from mri_raytracer_tpu_torch.ops import neural_march as tnm, shearwarp as tsw
from mri_raytracer_tpu_torch.ops.neural_march import NeuralBratsRenderer

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
DOCS = REPO / "docs"
CPU = torch.device("cpu")


def _jax_script(name):
    """A JAX script as a module (its ``main`` unrun)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------- read_npz
def test_read_npz_lines_equal_jax(tmp_path, capsys):
    from mri_raytracer_tpu_torch.config import ModelConfig
    from mri_raytracer_tpu_torch.models.api import build_model

    cfg = ModelConfig(hidden_dims=(8,), fourier_freqs=1)
    params = build_model(cfg, 4).init(torch.Generator().manual_seed(0))
    ckpt = tmp_path / "inr.npz"
    save_object(params, ckpt, info={"model": dataclasses.asdict(cfg)})
    paths = [ckpt, DOCS / "roi_policy.npz"]
    assert read_npz.main([str(p) for p in paths]) == 0
    want = []
    for p in paths:
        want += [f"== {p}"] + ["  " + ln for ln in j_inspect(p)]
    assert capsys.readouterr().out.splitlines() == want
    assert read_npz.main([]) == 1  # the JAX script's usage exit


# ------------------------------------------------------------- roi_report
@pytest.mark.parametrize("suite,suffix", [("showcase", ""),
                                          ("adversarial", "_hard")])
def test_roi_report_byte_equal_to_jax(tmp_path, suite, suffix):
    src = f"roi_results{suffix}.json"
    jdocs, tdocs = tmp_path / "jax", tmp_path / "port_in"
    for d in (jdocs, tdocs):
        d.mkdir()
        shutil.copy(DOCS / src, d / src)
    md = "ROI_RESULTS_hard.md" if suffix else "ROI_RESULTS.md"
    assert _jax_script("roi_report").main(["--suite", suite, "--docs",
                                           str(jdocs)]) == 0
    out = tmp_path / "port_out"
    assert roi_report.main(["--suite", suite, "--docs", str(tdocs),
                            "--out", str(out)]) == 0
    assert (out / md).read_bytes() == (jdocs / md).read_bytes()
    assert sorted(p.name for p in tdocs.iterdir()) == [src]


# ---------------------------------------------------- roi_showcase_figures
@pytest.mark.parametrize("skip_frames", [True, False])
def test_roi_showcase_figures(tmp_path, skip_frames):
    res = json.loads((DOCS / "roi_results.json").read_text())
    scenes = [v["scene"] for v in res["verdicts"]]
    argv = ["--out", str(tmp_path), "--device", "cpu"]
    argv += ["--skip-frames"] if skip_frames else \
        ["--shape", "24,24,20", "--width", "32", "--ref-steps", "32"]
    assert roi_showcase_figures.main(argv) == 0
    # The committed experiments.csv is the JAX script's output for the
    # committed roi_results.json.
    assert (tmp_path / "experiments.csv").read_bytes() == \
        (DOCS / "experiments.csv").read_bytes()
    for s in scenes:
        assert (tmp_path / "img" / f"roi_pareto_{s}.png").stat().st_size
    frames = sorted((tmp_path / "img").glob("roi_frames_*.png"))
    if skip_frames:
        assert not frames
    else:
        from PIL import Image

        assert [f.name for f in frames] == sorted(
            f"roi_frames_{s}.png" for s in scenes)
        assert Image.open(frames[0]).size == (3 * 32 + 12, 32)
    if not skip_frames:
        return
    # The JAX script's own Pareto helper on the same sweep writes a PNG too.
    jfig = _jax_script("roi_showcase_figures")
    jfig.pareto_figure(scenes[0], res["scenes"][scenes[0]], res["verdicts"][0],
                       tmp_path / "jax_pareto.png")
    assert (tmp_path / "jax_pareto.png").stat().st_size


# -------------------------------------------------------- neural_psnr_cert
CERT_VOL, CERT_SIZE, CERT_STEPS = 24, 32, 64


@pytest.fixture(scope="module")
def cert_case():
    disp, zsc, seg = neural_psnr_cert.synthetic_inputs(CERT_VOL)
    cfg = JCfg(hidden_dims=(32, 32), fourier_freqs=6, num_classes=4)
    jm = jbuild(cfg, num_modalities=4)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tm, tp = convert.inr_params_from_numpy(tree, dataclasses.asdict(cfg))
    return disp, zsc, seg, jm, jp, tm, tp


def test_cert_inputs_match_jax(cert_case):
    disp, zsc, seg = cert_case[:3]
    mods, jseg = jsyn.synthetic_case((CERT_VOL,) * 3, seed=0)
    np.testing.assert_array_equal(
        disp, np.stack([jbrats.percentile_normalize(m) for m in mods]))
    np.testing.assert_array_equal(
        zsc, np.stack([jbrats.zscore_nonzero(m.copy()) for m in mods]))
    np.testing.assert_array_equal(seg, jseg)


def test_cert_images_match_jax(cert_case):
    """Two poses, the orbit pose at kstride 1 and diag-low at kstride 2."""
    disp, zsc, seg, jm, jp, tm, tp = cert_case
    V, S = (CERT_VOL,) * 3, CERT_SIZE
    poses = neural_psnr_cert.POSES[:1] + neural_psnr_cert.POSES[4:5]
    kstrides = {"orbit": 1, "diag-low": 2}
    pred_j, _ = jpredict(jm, jp, {"mods": zsc, "seg": seg})
    with torch.no_grad():
        pred_t, _ = tpredict(tm, tp, {"mods": zsc, "seg": seg}, device=CPU)
    assert np.mean(pred_t != pred_j) < 5e-3
    p_o, p_n = neural_psnr_cert.render_params(CERT_VOL)
    bases = neural_psnr_cert.pose_bases(CERT_VOL, poses)
    with torch.no_grad():
        # The same baked prediction on both sides, for the oracle bar.
        orc_t = neural_psnr_cert.oracle_images(
            disp, seg, np.asarray(pred_j, np.int32), bases, p_o, S,
            CERT_STEPS, CPU)
        own_t = neural_psnr_cert.oracle_images(
            disp, seg, pred_t.astype(np.int32), bases, p_o, S, CERT_STEPS,
            CPU)
        neu_t = {}
        for name, b in bases.items():
            r = NeuralBratsRenderer(disp, zsc, seg, tm, tp, width=S,
                                    height=S, pred_stride=4,
                                    pred_kstride=kstrides[name], device=CPU)
            neu_t.update(neural_psnr_cert.neural_images(r, {name: b}, p_n))
    # The JAX script's steps (scripts/neural_psnr_cert.py:113-150).
    pj = jrp.default_render_params(V, show_seg=True, show_pred=True)
    dt = float(np.min(np.asarray(pj.voxel_size)))
    pj_o = pj._replace(step_size=np.float32(dt), show_pred=np.float32(1.0))
    pj_n = pj._replace(show_pred=np.float32(1.0))
    for name, th, ph in poses:
        kstride = kstrides[name]
        b = JCam(radius=jrp.default_camera_radius(pj, V), theta=th,
                 phi=ph).basis()
        orc_j = np.clip(np.asarray(jrx.render_brats(
            jnp.asarray(disp), jnp.asarray(seg),
            jnp.asarray(pred_j.astype(np.int32)), b, pj_o, S, S,
            max_steps=CERT_STEPS)), 0.0, 1.0)
        np.testing.assert_allclose(orc_t[name], orc_j, atol=1e-4)
        # The neural frame on JAX's geometry and field (the scan bar of
        # tests/test_torch_port_neural.py), against JAX's scan run eagerly:
        # at this 24^3 / 32^2 size JAX's jitted scan parts from its own
        # eager ops by up to 0.09 at rays grazing the box, and the port
        # meets the eager ops to ~1e-7 (as tests/test_torch_port_fit_views.py
        # found for the shear-warp fit).
        axis = jsw.dominant_axis(b)
        mzj = jnp.stack([jsw._perm_volume(jnp.asarray(z), axis)
                         for z in zsc])
        gj = jsw.sweep_geometry(b, pj_n, V, axis, S, frustum_wh=(S, S))
        field = jnm.predict_field(jm, jp, mzj, gj, pj_n, axis, S, 4,
                                  kstride=kstride)
        with jax.disable_jit():
            neu_e = np.clip(np.asarray(jnm.render_brats_neural(
                jnp.asarray(disp), jnp.asarray(zsc), jnp.asarray(seg), jm,
                jp, b, pj_n, S, S, pred_stride=4, pred_kstride=kstride,
                geom=gj, field=field)), 0.0, 1.0)
        inj_t = tnm.render_brats_neural(
            disp, zsc, seg, tm, tp, bases[name], p_n, S, S, pred_stride=4,
            pred_kstride=kstride,
            geom=tsw.SweepGeom(*(torch.tensor(np.array(x)) for x in gj)),
            field=np.asarray(field), device=CPU).clamp(0, 1).numpy()
        np.testing.assert_allclose(inj_t, neu_e, atol=3e-3)
        # Each side's own pipeline (its prediction, oracle and neural
        # frame) gives the pose's PSNR within 0.5 dB.
        q_t = neural_psnr_cert.pose_psnr(neu_t[name], own_t[name])
        q_j = neural_psnr_cert.pose_psnr(neu_e, orc_j)
        assert abs(q_t - q_j) <= 0.5, (name, q_t, q_j)


def test_cert_main_exit_code_and_record(tmp_path, capsys):
    rc = neural_psnr_cert.main(["--cpu", "--vol", str(CERT_VOL), "--size",
                                str(CERT_SIZE), "--oracle-steps",
                                str(CERT_STEPS), "--train-steps", "3",
                                "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "neural_psnr_cert_trained.json")
                     .read_text())
    # The JAX script's record (scripts/neural_psnr_cert.py:125-163).
    assert set(rec) == {"config", "kstride", "overall_pass"}
    assert set(rec["config"]) == {"size", "vol", "hidden", "pred_stride",
                                  "oracle_steps", "train_steps"}
    assert set(rec["kstride"]) == {"1", "2"}
    for k in rec["kstride"].values():
        assert set(k) == set(json.loads((DOCS / "neural_psnr_cert.json")
                                        .read_text())["kstride"]["1"])
        assert set(k["per_pose"]) == {n for n, _, _ in neural_psnr_cert.POSES}
        assert k["pass_40db"] == (k["min_db"] >= 40.0)
    # Exit 1 exactly where a kstride misses the bar (its :180).
    assert rc == (0 if rec["overall_pass"] else 1)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "pass"}
    assert last["pass"] == rec["overall_pass"]


def test_cert_fit_lowers_the_loss(cert_case):
    """``--train-steps``: full-batch Adam on the labels' cross-entropy."""
    _, zsc, seg, _, _, tm, _ = cert_case
    from mri_raytracer_tpu_torch.config import ModelConfig
    from mri_raytracer_tpu_torch.models.api import build_model

    model = build_model(ModelConfig(hidden_dims=(16,), fourier_freqs=2), 4)
    params = model.init(torch.Generator().manual_seed(0))
    _, l1 = neural_psnr_cert.fit_labels(model, params, zsc, seg, 1, CPU,
                                        n_voxels=4096)
    _, l2 = neural_psnr_cert.fit_labels(model, params, zsc, seg, 30, CPU,
                                        n_voxels=4096)
    assert np.isfinite(l2) and l2 < l1


# ------------------------------------------------------------- orbit_video
def test_orbit_video_brats_matches_jax(tmp_path):
    res, n = 32, 3
    vol = (32, 32, 32)
    frames = orbit_video.brats_orbit_frames(res, n, CPU, vol=vol)
    # The JAX script's loop (scripts/orbit_video.py:98-117) at this volume.
    mods, seg = jsyn.synthetic_case(vol, seed=0)
    disp = np.stack([jbrats.percentile_normalize(m) for m in mods])
    p = jrp.default_render_params(vol, show_seg=True, show_pred=False)
    r = JRenderer(jnp.asarray(disp), jnp.asarray(seg.astype(np.int32)), None,
                  width=res, height=res)
    cam = JCam(radius=jrp.default_camera_radius(p, vol), theta=0.0, phi=1.1)
    for i in range(n):
        cam.orbit(2 * 3.14159 / n, 0.25 * np.sin(i / 6.0) / 8)
        np.testing.assert_allclose(frames[i],
                                   np.asarray(r.render(cam.basis(), p)),
                                   atol=3e-3)
    # The CLI at the script's 128^3 case: the GIF the JAX script writes
    # (img/brats_orbit.gif, scripts/orbit_video.py:117), --frames long.
    from PIL import Image

    assert orbit_video.main(["--cpu", "--which", "brats", "--res", "32",
                             "--frames", "2", "--out", str(tmp_path)]) == 0
    assert [str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*")
            if p.is_file()] == ["img/brats_orbit.gif"]
    gif = Image.open(tmp_path / "img" / "brats_orbit.gif")
    assert gif.n_frames == 2 and gif.size == (32, 32)


def test_orbit_video_roi(tmp_path):
    from PIL import Image

    assert orbit_video.main(["--cpu", "--which", "roi", "--res", "24",
                             "--frames", "2", "--out", str(tmp_path)]) == 0
    res = json.loads((DOCS / "roi_results.json").read_text())
    want = sorted(f"roi_orbit_{v['scene']}.gif" for v in res["verdicts"]
                  if v.get("counts_toward_bar", True))
    gifs = sorted((tmp_path / "img").glob("*.gif"))
    assert [g.name for g in gifs] == want
    im = Image.open(gifs[0])
    assert im.n_frames == 2 and im.size == (2 * 24 + 4, 24)


# ----------------------------------------------------- roi_occupancy_bound
def _bounds(text):
    """{scene: the five numbers of its line} from the printed report."""
    out = {}
    for ln in text.strip().splitlines():
        name, rest = ln.split(None, 1)
        out[name] = [float(x) for x in re.findall(r"\d+\.\d+", rest)]
    return out


def test_roi_occupancy_bound_matches_jax(monkeypatch, capsys):
    argv = ["--shape", "16,16,12", "--width", "32", "--height", "18",
            "--frames", "2"]
    mod = _jax_script("roi_occupancy_bound")
    monkeypatch.setattr(sys, "argv", ["roi_occupancy_bound.py"] + argv)
    mod.main()
    want = _bounds(capsys.readouterr().out)
    assert roi_occupancy_bound.main(argv + ["--device", "cpu"]) == 0
    got = _bounds(capsys.readouterr().out)
    assert got.keys() == want.keys() and len(got) == 5
    for name in want:
        assert len(got[name]) == len(want[name]) == 5
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3)


# ----------------------------------------------- benchmarks and pipelines
# The JSON keys the JAX scripts print (bench_neural_march.py:177-180,
# full_geometry_smoke.py:127-129).
NM_KEYS = {"metric", "value", "unit", "mlp_overhead_ms", "baked_fps",
           "plain_fps", "bake_seconds", "params", "rebake_ms", "size", "vol"}
FG_KEYS = {"metric", "value", "unit", "shape", "dataset_write_s",
           "load_all_cases_s", "train_s", "bake_s", "render_compile_s",
           "render_fps"}


@pytest.mark.parametrize("interleave", [False, True])
def test_bench_neural_march_runs(tmp_path, capsys, interleave):
    argv = ["--device", "cpu", "--vol", "16", "--size", "32", "--frames",
            "1", "--batches", "1", "--write-doc", "--out", str(tmp_path)]
    assert bench_neural_march.main(argv + (["--interleave"] if interleave
                                           else [])) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == NM_KEYS and rec["size"] == 32 and rec["vol"] == 16
    assert "mode 2 (fused neural march)" in \
        (tmp_path / "RESULTS_r2.md").read_text()


def test_batch_times_sync_once_a_batch(monkeypatch):
    """The CLIs' timer: a synced warm call, then batches of calls queued
    back to back with one sync each."""
    from mri_raytracer_tpu_torch.utils import profiling

    calls, syncs = [], []
    monkeypatch.setattr(profiling, "sync",
                        lambda x: syncs.append(len(calls)))

    def fn():
        calls.append(1)
        return torch.zeros(1)

    ts = profiling.batch_times(fn, 4, 3)
    assert len(ts) == 3 and min(ts) >= 0.0
    assert len(calls) == 13 and syncs == [1, 5, 9, 13]
    calls.clear()
    syncs.clear()
    assert len(profiling.batch_times(fn, 2, 1, warm=False)) == 1
    assert syncs == [2]
    assert profiling.median_time(fn, 1, 3) >= 0.0


def test_bench_roi_overhead_runs(capsys):
    assert bench_roi_overhead.main(
        ["--cpu", "--width", "40", "--height", "24", "--shape", "16,16,12",
         "--budgets", "8,16", "--n-coarse", "8", "--block", "8",
         "--frames", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[ovh] 40x24") and len(lines) == 3
    assert all("overhead" in ln for ln in lines[1:])


def _tiny_results(tmp_path):
    """docs/roi_results.json with tumor-a's sweep at 40 x 24, beside a copy
    of the policy, under tmp_path."""
    res = json.loads((DOCS / "roi_results.json").read_text())
    res["scenes"]["tumor-a"].update(width=40, height=24, quality_frames=2,
                                    ref_steps=16)
    d = tmp_path / "in"
    d.mkdir()
    (d / "roi_results.json").write_text(json.dumps(res))
    shutil.copy(DOCS / "roi_policy.npz", d / "roi_policy.npz")
    return d / "roi_results.json"


@pytest.mark.parametrize("dry_run", [True, False])
def test_roi_retime_runs(tmp_path, capsys, dry_run):
    src = _tiny_results(tmp_path)
    before = src.read_bytes()
    out = tmp_path / "out"
    argv = ["--cpu", "--results", str(src), "--shape", "16,16,12",
            "--scenes", "tumor-a", "--rounds", "2", "--block", "8",
            "--n-coarse", "8", "--out", str(out),
            "--ref-cache", str(tmp_path / "refs")]
    argv += ["--dry-run"] if dry_run else ["--requality"]
    assert roi_retime.main(argv) == 0
    text = capsys.readouterr().out
    assert "[retime] tumor-a" in text and "OVERALL" in text
    assert src.read_bytes() == before  # never over its input
    if dry_run:
        assert not out.exists()
        return
    rec = json.loads((out / "roi_results.json").read_text())
    v = next(v for v in rec["verdicts"] if v["scene"] == "tumor-a")
    assert v["timing_method"].startswith("interleaved A/B, 2 rounds")
    assert {"speedup_sequential", "speedup_ci", "policy_wpsnr_presweep",
            "policy_ssim_ci"} <= set(v)
    assert (out / "ROI_RESULTS.md").read_text().startswith("#")
    with pytest.raises(SystemExit, match="overwrite"):
        roi_retime.main(argv[:-1] + ["--out", str(src.parent)])


def test_demo_and_full_geometry_run(tmp_path):
    rec = demo_end_to_end.run_demo(
        tmp_path / "demo", CPU, num_cases=3, shape=(16, 16, 12), steps=4,
        hidden=(8,), global_batch=512, micro_batch=256, size=32,
        oracle_steps=48, fps_frames=1)
    assert rec["backend"] == "sweep" and np.isfinite(rec["psnr_db"])
    md = (tmp_path / "demo" / "RESULTS_r1.md").read_text()
    assert "vs exact oracle PSNR" in md and "backend sweep" in md
    for f in ("inr_overlay_sweep.png", "inr_overlay_oracle.png"):
        assert (tmp_path / "demo" / "renders" / f).stat().st_size
    fg, doc = full_geometry_smoke.run_smoke(
        tmp_path / "fg" / "data", tmp_path / "fg", 3, 32, 1, 3, CPU,
        shape=(16, 16, 12))
    assert set(fg) == FG_KEYS and fg["shape"] == [16, 16, 12]
    assert "| render orbit 32^2 |" in doc
    # The dataset is written only when missing.
    stamp = sorted(p.stat().st_mtime_ns
                   for p in (tmp_path / "fg" / "data").rglob("*.nii.gz"))
    full_geometry_smoke.run_smoke(tmp_path / "fg" / "data", tmp_path / "fg",
                                  1, 32, 1, 3, CPU, shape=(16, 16, 12))
    assert stamp == sorted(p.stat().st_mtime_ns for p in
                           (tmp_path / "fg" / "data").rglob("*.nii.gz"))


@pytest.mark.parametrize("app,argv", [
    (neural_psnr_cert, []), (bench_neural_march, []), (orbit_video, []),
    (demo_end_to_end, []), (full_geometry_smoke, []),
    (roi_showcase_figures, []), (bench_roi_overhead, []),
    (roi_retime, ["--dry-run"]), (roi_occupancy_bound, [])])
def test_clis_need_a_card_unless_asked(monkeypatch, tmp_path, app, argv):
    """Without --device cpu / --cpu the CLIs raise before any work when no
    card is present; none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if app is not roi_occupancy_bound and app is not bench_roi_overhead:
        argv = argv + ["--out", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app.main(argv)
    assert not any(tmp_path.rglob("*.nii.gz"))
