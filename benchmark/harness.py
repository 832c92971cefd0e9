"""One run of one cell: set-up, the measured window, the traced part, the
check against the reference, and the result line.

``run`` finds everything by name under ``root`` (the checkout): the cell in
``BENCHMARK.json``, its configuration ``benchmark/configs/<config>.json``,
its traffic ``benchmark/traffic/<traffic>.json``, the configuration's system
``benchmark/systems/<system>.py``, the end-to-end readers
``benchmark/e2e/<metric>.py``, the per-layer readers
``benchmark/metrics/<metric>.py`` and the spans ``benchmark/spans/*.json``.

The window is a closed loop with one client: frame ``i``'s arguments are
made (``request``), then its call (``serve``) is timed from its start to
its pixels on the host; the next frame starts when it returns, until
``seconds`` have passed. A sample of the frames drawn from the seed (a
reservoir over the whole window) and the slowest frame are kept and, once
the window has closed, the memory peak read and the program freed, held
against the reference (``check.py``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import pathlib
import random
import sys
import tempfile
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from benchmark import check, counts, trace as trace_mod

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mri_raytracer_tpu")
_T_IMPORT = time.perf_counter()
# How the harness samples a run, the same in every cell: window frames drawn
# from the seed for the check (the slowest frame is checked besides), window
# frames rendered again under the profiler in a traced run, and every how
# many traced frames the reference counts K1's and K2's work.
CHECK_FRAMES = 6
TRACE_FRAMES = 24
ROOFLINE_EVERY = 6


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def cache_dirs(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port builds its CUDA libraries into ``build/kernels/`` there."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name, whole, is JAX's
    or the JAX package's (the port's name begins with the JAX package's)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def module(root: pathlib.Path, kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` of the checkout at ``root``, loaded
    from its file (so that a file dropped into a copy is found)."""
    path = pathlib.Path(root) / "benchmark" / kind / f"{name}.py"
    key = f"benchmark.{kind}.{name}@{path}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None or not path.exists():
            raise FileNotFoundError(f"no {path}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


class Cell(NamedTuple):
    spec: Dict
    workload: Dict
    config: Dict
    traffic: Dict
    system: object


def cell(root: pathlib.Path, name: str) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = load_json(root / "benchmark" / "configs" / f"{wl['config']}.json")
    traffic = load_json(root / "benchmark" / "traffic" /
                        f"{wl['traffic']}.json")
    return Cell(spec, wl, cfg, traffic, module(root, "systems",
                                               cfg["system"]))


def metrics_for(spec: Dict, kind: str, workload: str) -> List[Dict]:
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


class Window(NamedTuple):
    """The measured window: each frame's (start, end) perf_counter
    seconds, the window's start and end, and the frames kept for the
    check, {frame index: output}."""

    times: List[Tuple[float, float]]
    start: float
    end: float
    kept: Dict[int, object]


def window(sut, seconds: float, n_check: int, seed: int,
           min_frames: int = 1) -> Window:
    rng = random.Random(int(seed) ^ 0x5EED)
    times: List[Tuple[float, float]] = []
    slots: List[Tuple[int, object]] = []
    slowest = (-1.0, -1, None)
    start = time.perf_counter()
    i = 0
    while True:
        args = sut.request(i)
        t0 = time.perf_counter()
        out = sut.serve(args)
        t1 = time.perf_counter()
        times.append((t0, t1))
        if i < n_check:
            slots.append((i, out))
        else:
            j = rng.randrange(i + 1)
            if j < n_check:
                slots[j] = (i, out)
        if t1 - t0 > slowest[0]:
            slowest = (t1 - t0, i, out)
        i += 1
        if t1 - start >= seconds and i >= min_frames:
            break
    kept = dict(slots)
    kept[slowest[1]] = slowest[2]
    return Window(times, start, times[-1][1], kept)


def traced_part(sut, idxs: List[int], spans: Dict, log_fn):
    """Renders the poses of window frames ``idxs`` under the profiler;
    returns ``trace.parse``'s activities, frames, host operations and
    spans."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        with trace_mod.Wrapped(spans, log_fn), profile(
                activities=acts,
                schedule=schedule(wait=1, warmup=1, active=len(idxs),
                                  repeat=1),
                on_trace_ready=lambda p: p.export_chrome_trace(str(path))
        ) as prof:
            for step in range(len(idxs) + 2):
                args = sut.request(idxs[max(0, step - 2)])
                with record_function(trace_mod.PREFIX + "frame"):
                    sut.serve(args)
                prof.step()
        chrome = load_json(path)
    return trace_mod.parse(chrome)


def run(name: str, seed: int, seconds: float, trace: bool,
        root: pathlib.Path = ROOT, device: Optional[str] = None,
        log_fn: Callable[[str], None] = log, make_sut=None,
        min_frames: int = 1,
        marks: Optional[Dict[str, float]] = None) -> Tuple[Dict, Dict]:
    """One run of cell ``name``; returns the result object (the contract's
    keys, ``checks`` last) and the run's details (set-up by part, frames
    checked, largest pixel difference, frames a 5 s), which go to standard
    error. ``make_sut`` (``control.py``, the tests) puts another system in
    the program's place; ``min_frames`` makes the window last that many
    frames at least; ``marks`` are the process's ages at points before the
    run (``run.py``), kept with the set-up's parts."""
    c = cell(root, name)
    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    setup = dict(marks or {}, process_age_at_run_s=process_age_s())
    t0 = time.perf_counter()
    if on_card:
        from mri_raytracer_tpu_torch.ops import kernels

        setup["kernels_built"] = sorted(kernels.build())
        setup["kernel_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sut = (make_sut or c.system.build)(c.config, c.traffic, seed, dev)
    setup["case_and_program_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sut.warmup()
    if on_card:
        torch.cuda.synchronize(dev)
    setup["warmup_s"] = time.perf_counter() - t0
    setup_s = process_age_s()
    w = window(sut, seconds, CHECK_FRAMES, seed, min_frames)
    n = len(w.times)
    log_fn(f"{name}: {n} frames in {w.end - w.start:.3f} s after "
           f"{setup_s:.3f} s of set-up ({setup})")
    if setup.get("kernels_built"):
        log_fn(f"this run built {setup['kernels_built']} in "
               f"{setup['kernel_build_s']:.3f} s (a checkout's first run): "
               f"setup_s {setup_s:.3f} holds it, "
               f"{setup_s - setup['kernel_build_s']:.3f} without it")
    if trace:
        N = min(TRACE_FRAMES, n)
        idxs = [j * n // N for j in range(N)]
        traced = traced_part(sut, idxs, trace_mod.load_spans(root), log_fn)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    sut.close()
    del sut
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ref = c.system.reference(c.config, c.traffic, seed, dev)
    numbers, failed = check_frames(c, ref, w, log_fn)
    dev_info = {"platform": "gpu" if on_card else dev.type,
                "kind": torch.cuda.get_device_name(dev) if on_card
                else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": check.verdict(numbers, c.config["limits"]),
              "attempted": n, "failed": failed}
    if not trace:
        result["metrics"] = {
            m["name"]: {"value": setup_s if m["name"] == "setup_s" else
                        module(root, "e2e", m["name"]).read(w),
                        "unit": m["unit"]}
            for m in metrics_for(c.spec, "end_to_end", name)}
        result["device"] = dev_info
    else:
        peaks = counts.peaks_for(dev_info["kind"]) if on_card else None
        t = trace_mod.Trace(*traced, *work_of(c, ref, w, idxs, peaks))
        result["metrics"] = {}
        for m in metrics_for(c.spec, "per_layer", name):
            v = module(root, "metrics", m["name"]).read(t) if t.frames \
                else None
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"] = dev_info
        if t.frames:
            dev_info["busy_s"] = sum(e - s for s, e in t.busy_intervals()) \
                * 1e-6
            dev_info["window_s"] = (t.window[1] - t.window[0]) * 1e-6
            result["breakdown"] = trace_mod.breakdown(t)
    ref.close()
    setup["check_s"] = time.perf_counter() - t0
    result["checks"] = {k: {"value": numbers[k],
                            "limit": c.config["limits"][k]}
                        for k in check.COMPARED}
    detail = {"setup": setup, "frames_checked": sorted(w.kept),
              "err_max": numbers["err_max"],
              "frames_per_5s": segments(w, 5.0)}
    return result, detail


def check_frames(c: Cell, ref, w: Window, log_fn) -> Tuple[Dict, int]:
    """The compared numbers over the kept frames, and how many of them
    fail the limits by themselves."""
    diffs, failed = [], 0
    for i in sorted(w.kept):
        img, info = ref.frame(ref.cam(i))
        d = check.frame_diff(w.kept[i], img)
        diffs.append(d)
        failed += check.frame_fails(d, c.config["limits"])
        log_fn(f"check frame {i}: axis {info['axis']}, K {info['K']}, O "
               f"{info['O']}, max {d['max']:.3e}, off {d['n_off']} of "
               f"{d['n_px']}" + (f", field classes {info['field_classes']}"
                                 if "field_classes" in info else ""))
    return check.summarize(diffs), failed


def work_of(c: Cell, ref, w: Window, idxs: List[int], peaks):
    """For the traced frames j (window frames ``idxs[j]``): the K1 and K2
    bounds in ms of every ``ROOFLINE_EVERY``-th, from the reference's
    counts of their work; the least time in s of each; and the time each
    took in the window."""
    k1b, k2b, least, spent = {}, {}, {}, {}
    for j, i in enumerate(idxs):
        spent[j] = w.times[i][1] - w.times[i][0]
        if peaks is None:
            continue
        cam = ref.cam(i)
        least[j] = counts.least_time(ref.work(cam), peaks)
        if j % ROOFLINE_EVERY:
            continue
        _, info = ref.frame(cam)
        nb, ops = counts.k1_cost(info["K"], info["Na"], info["O"],
                                 info["row_overlays"], info["field_numel"],
                                 info["n_active"], info["n_labeled"])
        k1b[j] = counts.bound(peaks, nb, ops, peaks.fp32)[0]
        nb, ops = counts.k2_cost(info["n_touched"], c.traffic["width"],
                                 c.traffic["height"])
        k2b[j] = counts.bound(peaks, nb, ops, peaks.fp32)[0]
    return k1b, k2b, least, spent


def segments(w: Window, span: float) -> List[int]:
    """Frames that ended in each ``span`` seconds of the window."""
    n = max(1, math.ceil((w.end - w.start) / span))
    out = [0] * n
    for _, t1 in w.times:
        out[min(n - 1, int((t1 - w.start) / span))] += 1
    return out


def checks_lines(result: Dict) -> List[str]:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in result["checks"].items()]
