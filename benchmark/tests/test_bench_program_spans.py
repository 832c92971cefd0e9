"""The readers of the INR field's parts, the present copy and the field's
rate, on a known trace; the earlier readers read the same with these spans,
and with the program's own ``mrt.`` ranges, in the trace."""

from __future__ import annotations

import pytest

from benchmark import harness, trace as trace_mod
from benchmark.tests import tiny

EARLIER = ("launches_per_frame", "predict_field_ms", "stage1_ms",
           "k1_roofline", "k2_roofline", "device_idle", "frame_mfu")


def _chrome(parts: bool, program: bool):
    """Two traced frames. In each, ``predict_field`` launches one resample
    and one MLP kernel (inside their spans when ``parts``), then stage 1,
    K1, K2 and the present copy (inside ``present`` when ``parts``).
    ``program`` adds the program's own ``mrt.`` ranges over the same
    intervals."""
    ev = []

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                   "tid": 1, "args": args})

    def span(name, ts, dur, part=False):
        if parts or not part:
            x("user_annotation", "bench." + name, ts, dur)
        if program:
            x("user_annotation", "mrt." + name.replace("_resample",
                                                       ".resample")
              .replace("_mlp", ".mlp"), ts, dur)

    for j, t0 in enumerate((0.0, 2000.0)):
        span("frame", t0, 1900.0)
        span("predict_field", t0 + 10, 500.0)
        span("predict_field_resample", t0 + 20, 100.0, part=True)
        span("predict_field_mlp", t0 + 200, 300.0, part=True)
        span("stage1", t0 + 600, 100.0)
        span("k1", t0 + 800, 100.0)
        span("k2", t0 + 1000, 50.0)
        span("present", t0 + 1200, 300.0, part=True)
        x("cpu_op", "aten::bmm", t0 + 30, 30.0)
        for corr, at, name, start, dur in (
                (1, 40, "gemm", 60, 80),
                (2, 250, "clamp", 300, 120),
                (3, 610, "bmm", 620, 40),
                (4, 810, "composite_kernel<false,false>", 820, 200),
                (5, 1010, "warp_kernel<true>", 1030, 20),
                (6, 1250, "Memcpy DtoH", 1260, 150)):
            corr += 10 * j
            x("cuda_runtime", "cudaLaunchKernel", t0 + at, 5.0,
              correlation=corr)
            x("kernel" if "Memcpy" not in name else "gpu_memcpy", name,
              t0 + start, float(dur), correlation=corr)
    return {"traceEvents": ev}


def _trace(parts=True, program=False):
    return trace_mod.Trace(*trace_mod.parse(_chrome(parts, program)),
                           {0: 0.05}, {1: 0.01}, {0: 0.001, 1: 0.002},
                           {0: 0.01, 1: 0.01})


def _read(name, t):
    return harness.module(tiny.REPO, "metrics", name).read(t)


def test_parts_of_the_field_and_the_present_copy():
    t = _trace()
    assert _read("predict_field_resample_ms", t) == pytest.approx(0.080)
    assert _read("predict_field_mlp_ms", t) == pytest.approx(0.120)
    assert _read("present_ms", t) == pytest.approx(0.150)
    assert _read("predict_field_ms", t) == pytest.approx(0.200)
    bare = _trace(parts=False)
    for name in ("predict_field_resample_ms", "predict_field_mlp_ms",
                 "present_ms"):
        assert _read(name, bare) is None


def test_field_points_per_s_reads_the_programs_counters(monkeypatch):
    from mri_raytracer_tpu_torch.utils import profiling

    t = _trace()
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"frames": 4, "field.points": 8_000_000})
    # 2e6 points a frame over 200 us of field a frame.
    assert _read("field_points_per_s", t) == pytest.approx(1e10)
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert _read("field_points_per_s", t) is None
    monkeypatch.delattr(profiling, "counters")
    assert _read("field_points_per_s", t) is None


@pytest.mark.parametrize("parts,program", [(True, False), (False, True),
                                           (True, True)])
def test_earlier_readers_read_the_same(parts, program):
    base, t = _trace(parts=False), _trace(parts, program)
    for name in EARLIER:
        assert _read(name, t) == pytest.approx(_read(name, base)), name
    assert trace_mod.breakdown(t)["device_ops"] == \
        trace_mod.breakdown(base)["device_ops"]


def test_an_idle_gap_inside_the_mlp_is_named_by_its_span():
    gaps = dict(trace_mod.breakdown(_trace())["idle_gaps"])
    # From the MLP kernel's end (420) to stage 1's kernel (620).
    assert gaps["predict_field_mlp/python"] == pytest.approx(2 * 200e-6)
    bare = dict(trace_mod.breakdown(_trace(parts=False))["idle_gaps"])
    assert "predict_field_mlp/python" not in bare


def test_the_new_spans_wrap_the_programs_parts_and_come_off_again():
    from mri_raytracer_tpu_torch.ops import neural_march
    from mri_raytracer_tpu_torch.render import brats

    spans = trace_mod.load_spans(tiny.REPO)
    assert {"predict_field_resample", "predict_field_mlp",
            "present"} <= set(spans)
    orig = (neural_march.resample_block, neural_march.mlp_block,
            brats.present)
    with trace_mod.Wrapped(spans, lambda m: None):
        assert neural_march.resample_block.__wrapped__ is orig[0]
        assert neural_march.mlp_block.__wrapped__ is orig[1]
        assert brats.present.__wrapped__ is orig[2]
    assert (neural_march.resample_block, neural_march.mlp_block,
            brats.present) == orig
