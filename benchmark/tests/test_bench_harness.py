"""The harness on the CPU: files found by name, the result line, the
refusal without a card, the trace's reading."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, trace as trace_mod
from benchmark.tests import tiny

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_carries_only_the_contracts_keys(root, trace):
    result, _ = harness.run("tiny.seg", 2**31 + 11, 0.3, trace, root=root,
                            device="cpu", log_fn=lambda m: None)
    want = CONTRACT + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == want
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    for k, v in line["checks"].items():
        assert set(v) == {"value", "limit"}
    assert result["correct"] is True and result["attempted"] >= 1
    if not trace:
        assert set(result["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                          "setup_s"}
        assert all(set(m) == {"value", "unit"}
                   for m in result["metrics"].values())
    else:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "inr.orbit1024", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(tiny.REPO), env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names():
    fine = ["torch", "mri_raytracer_tpu_torch", "mri_raytracer_tpu_torch.ops",
            "mri_raytracer_tpux.y", "jaxtyping", "flaxen.z"]
    assert harness.forbidden_modules(fine) == []
    assert harness.forbidden_modules(fine + ["mri_raytracer_tpu.ops.x",
                                             "jax.numpy", "jaxlib", "flax"]) \
        == ["flax", "jax", "jaxlib", "mri_raytracer_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package(root):
    """The process that runs a cell (here on the CPU) loads neither."""
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "from benchmark import harness;"
            "harness.run('tiny.inr', 5, 0.2, True, root=harness.pathlib.Path("
            "sys.argv[2]), device='cpu', log_fn=lambda m: None);"
            "print(json.dumps(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code, str(tiny.REPO),
                          str(root)], capture_output=True, text=True,
                         timeout=600, cwd=str(tiny.REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


DROP_IN = '''
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import harness
for trace in (0, 1):
    r, _ = harness.run("tiny.new", 7, 0.3, bool(trace), root=harness.ROOT,
                       device="cpu", log_fn=lambda m: None)
    print(json.dumps(r))
'''


def test_new_config_traffic_and_metric_files_are_found_by_name(tmp_path):
    """Files dropped into a copy, with entries in its BENCHMARK.json, run
    without an edit to any file that was there."""
    root = tiny.make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "tiny_brats_seg.json").read_text())
    cfg["render"]["intensity_alpha"] = 0.6
    (b / "configs" / "tiny_new.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "tiny.json").read_text())
    traffic.update(width=40, height=32)
    (b / "traffic" / "tiny_wide.json").write_text(json.dumps(traffic))
    (b / "metrics" / "frames_traced.py").write_text(
        "def read(t):\n    return float(t.n_frames)\n")
    (b / "e2e" / "frames_done.py").write_text(
        "def read(w):\n    return float(len(w.times))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_new", "source": "test",
                            "file": "benchmark/configs/tiny_new.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.new", "config": "tiny_new",
                              "traffic": "tiny_wide", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "frames_traced", "unit": "frames",
                              "better": "higher", "source": "device_trace",
                              "layer": "Device", "moves": "frames_per_s"})
    spec["end_to_end"].append({"name": "frames_done", "unit": "frames",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "-c", DROP_IN, str(root)],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(root),
                         env=dict(os.environ, PYTHONPATH=str(tiny.REPO)))
    assert out.returncode == 0, out.stderr[-3000:]
    r0, r1 = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    assert r0["metrics"]["frames_done"]["value"] == r0["attempted"]
    assert r1["metrics"]["frames_traced"]["value"] >= 1
    assert r0["correct"] and r1["correct"]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_window_keeps_a_seeded_sample_and_the_slowest_frame():
    class Sut:
        def __init__(self):
            self.n = 0

        def request(self, i):
            return i

        def serve(self, i):
            if i == 13:
                import time
                time.sleep(0.02)
            return i

    a = harness.window(Sut(), 0.0, 4, 99, min_frames=60)
    b = harness.window(Sut(), 0.0, 4, 99, min_frames=60)
    assert len(a.times) == 60
    assert 13 in a.kept and len(a.kept) in (4, 5)
    assert set(a.kept) == set(b.kept)
    assert all(a.kept[i] == i for i in a.kept)


def _chrome():
    """Two traced frames; launches inside the spans by correlation."""
    ev = []

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                   "tid": 1, "args": args})

    for j, t0 in enumerate((0.0, 1000.0)):
        x("user_annotation", "bench.frame", t0, 900.0)
        x("user_annotation", "bench.stage1", t0 + 10, 100.0)
        x("user_annotation", "bench.k1", t0 + 200, 100.0)
        x("user_annotation", "bench.k2", t0 + 400, 50.0)
        x("cpu_op", "aten::bmm", t0 + 20, 30.0)
        for corr, at, name, start, dur in (
                (10 * j + 1, 25, "gemm", 60, 40),
                (10 * j + 2, 210, "composite_kernel<false,false>", 220, 200),
                (10 * j + 3, 410, "warp_kernel<true>", 430, 20),
                (10 * j + 4, 600, "Memcpy DtoH", 610, 100)):
            x("cuda_runtime", "cudaLaunchKernel", t0 + at, 5.0,
              correlation=corr)
            x("kernel" if "Memcpy" not in name else "gpu_memcpy", name,
              t0 + start, float(dur), correlation=corr)
    return {"traceEvents": ev}


def _load_metric(name):
    return harness.module(tiny.REPO, "metrics", name)


def test_trace_readers_on_a_known_trace():
    acts, frames, host, spans = trace_mod.parse(_chrome())
    assert len(frames) == 2 and len(acts) == 8
    assert [a.frame for a in acts] == [0, 0, 0, 0, 1, 1, 1, 1]
    assert acts[0].spans == ("stage1",) and acts[3].spans == ()
    t = trace_mod.Trace(acts, frames, host, spans, {0: 0.05}, {1: 0.01},
                        {0: 0.001, 1: 0.002}, {0: 0.01, 1: 0.01})
    read = lambda n: _load_metric(n).read(t)
    assert read("launches_per_frame") == 4.0
    assert read("stage1_ms") == pytest.approx(0.040)
    assert read("predict_field_ms") is None
    assert read("k1_roofline") == pytest.approx(100 * 0.05 / 0.2)
    assert read("k2_roofline") == pytest.approx(100 * 0.01 / 0.02)
    # Each frame keeps the device busy 360 us of the 10 ms it took in the
    # window.
    assert t.frame_busy_s(0) == pytest.approx(360e-6)
    assert read("device_idle") == pytest.approx(100 * (1 - 720e-6 / 0.02))
    assert read("frame_mfu") == pytest.approx(100 * 0.003 / 0.02)
    b = trace_mod.breakdown(t)
    assert b["device_ops"][0][0] == "composite_kernel<false,false>"
    assert b["device_ops"][0][1] == pytest.approx(400e-6)
    # Each gap is named by the innermost span and host operation under way
    # where it begins.
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"frame/python": 600e-6, "k2/python": 340e-6,
         "stage1/python": 240e-6})


def test_spans_wrap_the_layers_and_come_off_again():
    from mri_raytracer_tpu_torch.ops import composite, warp

    spans = trace_mod.load_spans(tiny.REPO)
    assert {"stage1", "k1", "k2", "predict_field", "content_geometry",
            "sweep_frame", "neural_sweep_frame"} <= set(spans)
    orig = (composite.stage1, composite.composite_planes, warp.warp_screen)
    with trace_mod.Wrapped(spans, lambda m: None):
        assert composite.stage1 is not orig[0]
        assert composite.composite_planes.launches == orig[1].launches
        assert warp.warp_screen.__wrapped__ is orig[2]
    assert (composite.stage1, composite.composite_planes,
            warp.warp_screen) == orig


def test_cache_dirs_lie_inside_the_checkout(tmp_path, monkeypatch):
    monkeypatch.delenv("TRITON_CACHE_DIR", raising=False)
    monkeypatch.delenv("TORCH_EXTENSIONS_DIR", raising=False)
    harness.cache_dirs(tmp_path)
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        assert os.environ[var].startswith(str(tmp_path))
