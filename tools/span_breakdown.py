#!/usr/bin/env python3
"""The live-INR viewer's frame by the port's own spans and counters
(``mri_raytracer_tpu_torch/utils/profiling.py``), on one NVIDIA card.

    python3 tools/span_breakdown.py [--seed N] [--window W] [--rounds R]
        [--frames F] [--out DIR]

The viewer is the benchmark's ``inr.orbit1024`` cell (``benchmark/systems/
viewer.py``: the seeded case and INR at 1024², closed loop). First the host
time of an empty ``span``, off and on; then, after the viewer's warm-up,
four parts:

1. the cost of the spans: ``R`` rounds, each two closed-loop windows over
   the same ``W`` poses of the orbit (the next ``W`` in the next round),
   spans off then on, and on then off in the next round; each window's
   frames a second, and the counters over all the windows;
2. one frame rendered with the spans off and on: equal to the last bit;
3. host time a frame by span, total and self (the span less its children),
   over ``F`` poses spread over the windows' frames, rendered again with the
   spans on and no profiler;
4. the same poses under ``profiling.trace``: each device activity put down to
   the innermost span (and host operation) holding the call that launched it
   (CUPTI's correlation id), as device ms a frame by span and the kernels
   that take most of each span's time.

Prints one JSON object (and writes it to ``DIR/span_breakdown.json``) with
the card's name and power limit. Needs one CUDA card; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import bisect
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from mri_raytracer_tpu_torch.ops import kernels  # noqa: E402
from mri_raytracer_tpu_torch.utils import profiling  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def span_ns(n: int = 200_000):
    """Host ns an empty ``with profiling.span(...)`` costs, off and on,
    over an empty loop's."""
    out = {}
    for key, on in (("loop", None), ("off", False), ("on", True)):
        profiling.enable_spans(bool(on))
        t0 = time.perf_counter_ns()
        if on is None:
            for _ in range(n):
                pass
        else:
            for _ in range(n):
                with profiling.span("x"):
                    pass
        out[key] = (time.perf_counter_ns() - t0) / n
        profiling.take_spans()
    profiling.enable_spans(False)
    return {"off": out["off"] - out["loop"], "on": out["on"] - out["loop"]}


def window(sut, first: int, n: int) -> float:
    """Seconds frames ``first`` to ``first + n - 1`` take in a closed
    loop."""
    t0 = time.perf_counter()
    for i in range(first, first + n):
        sut.serve(sut.request(i))
    return time.perf_counter() - t0


def host_ms(spans, n_frames: int):
    """{name: [total, self]} host ms a frame."""
    by_frame = defaultdict(list)
    for s in spans:
        by_frame[s.frame].append(s)
    out = defaultdict(lambda: [0.0, 0.0])
    for group in by_frame.values():
        for s in group:
            out[s.name][0] += (s.end_ns - s.start_ns) * 1e-6 / n_frames
            out[s.name][1] += profiling.self_ns(s, group) * 1e-6 / n_frames
    return {k: [round(v[0], 4), round(v[1], 4)] for k, v in
            sorted(out.items(), key=lambda kv: -kv[1][0])}


def innermost(ivs, starts, ts):
    k = bisect.bisect_right(starts, ts)
    under = [iv for iv in ivs[max(0, k - 256):k] if iv[1] >= ts]
    return min(under, key=lambda iv: iv[1] - iv[0])[2] if under else None


def device_by_span(chrome, n_frames: int, top: int = 6):
    events = [e for e in chrome["traceEvents"] if e.get("ph") == "X"]
    ivs = lambda keep: sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in events if keep(e))
    spans = ivs(lambda e: e.get("cat") == "user_annotation"
                and str(e["name"]).startswith(profiling.PREFIX))
    ops = ivs(lambda e: e.get("cat") == "cpu_op")
    s_at, o_at = [s[0] for s in spans], [o[0] for o in ops]
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    by_span = defaultdict(float)
    by_kernel = defaultdict(lambda: defaultdict(float))
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts = launch.get(e.get("args", {}).get("correlation"))
        name = "unattributed" if ts is None else \
            (innermost(spans, s_at, ts) or "outside_spans")
        name = name[len(profiling.PREFIX):] if name.startswith(
            profiling.PREFIX) else name
        op = None if ts is None else innermost(ops, o_at, ts)
        ms = float(e["dur"]) * 1e-3 / n_frames
        by_span[name] += ms
        by_kernel[name][f"{e['name'][:70]} <- {op}"] += ms
    return ({k: round(v, 4) for k, v in sorted(by_span.items(),
                                                key=lambda kv: -kv[1])},
            {k: [[n, round(v, 4)] for n, v in sorted(
                d.items(), key=lambda kv: -kv[1])[:top]]
             for k, d in by_kernel.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2**31 + 16)
    ap.add_argument("--window", type=int, default=60)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--out", default=str(ROOT / "build" / "span_breakdown"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    res = {"card": card(), "torch": torch.__version__, "seed": args.seed,
           "span_ns": span_ns()}
    harness.cache_dirs(ROOT)
    kernels.build()
    c = harness.cell(ROOT, "inr.orbit1024")
    sut = c.system.build(c.config, c.traffic, args.seed, torch.device("cuda"))
    sut.warmup()
    torch.cuda.synchronize()

    before, cost, n = profiling.counters(), [], args.window
    for r in range(args.rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            profiling.enable_spans(on)
            dt = window(sut, r * n, n)
            cost.append({"round": r, "spans": on, "frames_per_s": n / dt,
                         "spans_a_frame": len(profiling.take_spans()) / n})
    profiling.enable_spans(False)
    i = args.rounds * n
    after = profiling.counters()
    res["cost"] = cost
    res["frames_per_s_median"] = {
        k: statistics.median(w["frames_per_s"] for w in cost
                             if w["spans"] == on)
        for k, on in (("off", False), ("on", True))}
    res["on_over_off_by_round"] = [
        cost[2 * r + (r % 2 == 0)]["frames_per_s"]
        / cost[2 * r + (r % 2 == 1)]["frames_per_s"]
        for r in range(args.rounds)]
    res["counters_over_windows"] = {k: after[k] - before.get(k, 0)
                                    for k in after}

    off = sut.serve(sut.request(7))
    profiling.enable_spans(True)
    on = sut.serve(sut.request(7))
    profiling.enable_spans(False)
    profiling.take_spans()
    res["same_frame_spans_on_and_off"] = bool((on == off).all())

    idxs = [j * i // args.frames for j in range(args.frames)]
    profiling.enable_spans(True)
    for j in idxs:
        sut.serve(sut.request(j))
    profiling.enable_spans(False)
    res["host_ms_total_self"] = host_ms(profiling.take_spans(), len(idxs))

    sut.serve(sut.request(idxs[0]))  # one frame outside the trace
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            for j in idxs:
                sut.serve(sut.request(j))
        chrome = json.loads((pathlib.Path(tmp) / "trace.json").read_text())
    profiling.take_spans()
    res["device_ms"], res["device_kernels"] = device_by_span(chrome,
                                                             len(idxs))
    res["counters"] = profiling.counters()
    sut.close()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "span_breakdown.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
