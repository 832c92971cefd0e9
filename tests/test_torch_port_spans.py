"""The port's spans and counters (``utils/profiling.py``) on the viewer's
path, on the CPU: the neural viewer ('fused': on CPU tensors stage 1, K1b's
and K2's plain versions) and the BraTS viewer ('sweep') at a tiny case."""

import json
import time

import numpy as np
import pytest
import torch

from mri_raytracer_tpu_torch.config import ModelConfig
from mri_raytracer_tpu_torch.data import brats as dbrats, synthetic
from mri_raytracer_tpu_torch.models.api import build_model
from mri_raytracer_tpu_torch.ops import neural_march as nm
from mri_raytracer_tpu_torch.render import params as rp
from mri_raytracer_tpu_torch.render.brats import BratsRenderer
from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
from mri_raytracer_tpu_torch.utils import profiling

torch.set_num_threads(2)
SHAPE = (24, 24, 20)
KW = dict(width=64, height=64, sweep_res=128, device="cpu")
STRIDE = 2
# The spans under one neural frame, by their parent.
NEURAL = {"sweep_frame": "frame", "prepare": "sweep_frame",
          "content_geometry": "frame", "predict_field": "frame",
          "predict_field.resample": "predict_field",
          "predict_field.mlp": "predict_field", "stage1": "frame",
          "k1": "frame", "k2": "frame", "present": "frame"}
# The BraTS viewer's 'sweep' backend composites by the plain scan, with
# neither stage 1 nor K1.
SWEEP = {"sweep_frame": "frame", "prepare": "sweep_frame",
         "content_geometry": "frame", "k2": "frame", "present": "frame"}


@pytest.fixture(scope="module")
def scene():
    mods, seg = synthetic.synthetic_case(SHAPE, seed=2)
    disp = np.stack([dbrats.percentile_normalize(m) for m in mods])
    zsc = np.stack([dbrats.zscore_nonzero(m.copy()) for m in mods])
    model = build_model(ModelConfig(hidden_dims=(16, 16), fourier_freqs=4),
                        num_modalities=4)
    params = model.init(torch.Generator().manual_seed(3))
    p = rp.default_render_params(SHAPE, show_seg=True, show_pred=True)
    return disp, zsc, seg.astype(np.int32), model, params, p


@pytest.fixture(autouse=True)
def _fresh_recorder():
    profiling.enable_spans(False)
    profiling.take_spans()
    profiling.reset_counters()
    yield
    profiling.enable_spans(False)
    profiling.take_spans()


def _renderer(scene, kind):
    disp, zsc, seg, model, params, _ = scene
    if kind == "sweep":
        return BratsRenderer(disp, seg, None, backend="sweep", **KW)
    return nm.NeuralBratsRenderer(disp, zsc, seg, model, params,
                                  backend=kind, pred_stride=STRIDE, **KW)


def _basis(scene, theta=0.8, phi=1.1):
    p = scene[-1]
    return OrbitalCamera(radius=rp.default_camera_radius(p, SHAPE),
                         theta=theta, phi=phi).basis()


def test_spans_off_record_nothing_and_read_no_clock(scene, monkeypatch):
    r = _renderer(scene, "fused")
    r.render_numpy(_basis(scene), scene[-1])  # builds the caches

    def refuse(*a, **k):
        raise AssertionError("called with the spans off")

    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_Span", refuse)
    assert profiling.span("k1") is profiling.span("k2")
    r.render_numpy(_basis(scene), scene[-1])
    assert profiling.take_spans() == []
    assert profiling.counters()["frames"] == 2


@pytest.mark.parametrize("kind,want", [("fused", NEURAL), ("sweep", SWEEP),
                                       ("rebake", SWEEP)])
def test_spans_nest_under_one_frame(scene, kind, want):
    r = _renderer(scene, kind)
    profiling.enable_spans(True)
    r.render_numpy(_basis(scene), scene[-1])
    spans = profiling.take_spans()
    frames = [s for s in spans if s.name == "frame"]
    assert len(frames) == 1 and frames[0].parent is None
    assert {s.frame for s in spans} == {frames[0].frame}
    assert frames[0].frame == profiling.counters()["frames"]
    assert {s.name: s.parent for s in spans if s.name != "frame"} == want
    f = frames[0]
    for s in spans:
        assert f.start_ns <= s.start_ns <= s.end_ns <= f.end_ns
    if kind == "fused":
        fr = r.sweep_frame(_basis(scene), scene[-1])
        blocks = -(-(fr.mixed_s.shape[0] + 1) // 16)
        for part in ("predict_field.resample", "predict_field.mlp"):
            assert sum(s.name == part for s in spans) == blocks


def test_self_ns_is_the_duration_less_the_union_of_the_children():
    S = profiling.Span
    spans = [S(1, "a", None, 0, 100), S(1, "b", "a", 10, 40),
             S(1, "c", "a", 30, 60), S(1, "d", "b", 12, 20),
             S(1, "e", "a", 80, 90), S(2, "f", "a", 0, 100)]
    assert profiling.self_ns(spans[0], spans) == 100 - 50 - 10
    assert profiling.self_ns(spans[1], spans) == 30 - 8
    assert profiling.self_ns(spans[4], spans) == 10


@pytest.mark.parametrize("kind", ["fused", "sweep"])
def test_frame_is_the_same_with_spans_on_and_off(scene, kind):
    r = _renderer(scene, kind)
    off = r.render_numpy(_basis(scene), scene[-1])
    profiling.enable_spans(True)
    on = r.render_numpy(_basis(scene), scene[-1])
    np.testing.assert_array_equal(on, off)
    assert profiling.take_spans()


def test_prepared_volumes_are_built_once_an_axis(scene):
    r = _renderer(scene, "sweep")
    p = scene[-1]
    r.warmup(p)
    assert profiling.counters()["sweep.prep_misses"] == 3
    assert profiling.counters()["sweep.param_uploads"] == 1
    axes = set()
    for i in range(12):
        b = _basis(scene, theta=0.6 + 0.45 * i, phi=0.1 + 0.25 * i)
        axes.add(r.frame_stats(b, p)["axis"])
        r.render(b, p)
    assert axes == {0, 1, 2}
    c = profiling.counters()
    assert c["sweep.prep_misses"] == 3 and c["sweep.param_uploads"] == 1
    assert c["frames"] == 15


def test_field_points_count_each_block(scene):
    r = _renderer(scene, "fused")
    b, p = _basis(scene), scene[-1]
    fr = r.sweep_frame(b, p)
    r.render(b, p)
    op = fr.out_res // STRIDE
    assert profiling.counters()["field.points"] == \
        (fr.mixed_s.shape[0] + 1) * op * op


def test_exported_trace_holds_each_span_inside_its_frame(scene, tmp_path):
    r = _renderer(scene, "fused")
    with profiling.trace(tmp_path):
        r.render_numpy(_basis(scene), scene[-1])
    assert profiling.span("k1") is profiling.span("k2")
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("ph") == "X"
           and str(e.get("name", "")).startswith(profiling.PREFIX)]
    names = {e["name"][len(profiling.PREFIX):] for e in ann}
    assert names == set(NEURAL) | {"frame"}
    frame = next(e for e in ann if e["name"] == "mrt.frame")
    t0, t1 = float(frame["ts"]), float(frame["ts"]) + float(frame["dur"])
    for e in ann:
        assert t0 <= float(e["ts"]) and \
            float(e["ts"]) + float(e["dur"]) <= t1 + 1e-3
    assert len(profiling.take_spans()) == len(ann)


def test_counters_and_frames_hold_across_threads():
    """Each thread's frames nest only their own spans, and no count is
    lost between threads."""
    import sys
    import threading

    def work():
        for _ in range(200):
            with profiling.frame():
                with profiling.span("a"):
                    profiling.count("x")

    profiling.enable_spans(True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    c = profiling.counters()
    assert c["x"] == 1600 and c["frames"] == 1600
    spans = profiling.take_spans()
    assert sorted(s.frame for s in spans if s.name == "frame") == \
        list(range(1, 1601))
    frame_of = {s.frame: s for s in spans if s.name == "frame"}
    for s in spans:
        if s.name == "a":
            f = frame_of[s.frame]
            assert s.parent == "frame"
            assert f.start_ns <= s.start_ns <= s.end_ns <= f.end_ns
