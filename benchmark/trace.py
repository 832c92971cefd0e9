"""The traced part of a ``--trace 1`` run and what the readers read.

After the measured window, the poses of ``harness.TRACE_FRAMES`` of its frames,
evenly spaced over it, are rendered again back to back under
``torch.profiler`` (after one frame to wait and one to warm the profiler).
The benchmark wraps the module attributes through which the renderer calls
each layer (``benchmark/spans/<span>.json``: module and attribute) in
``torch.profiler.record_function("bench.<span>")``, and each frame in
``bench.frame``; the wrappers are in place only for the traced part.

The profile is exported as a Chrome trace and read back into ``Trace``:
every device activity (kernel, copy, set) with the frame and the
benchmark spans whose host interval holds the runtime call that launched
it (matched by CUPTI's correlation id), and the host's frame intervals.
Readers (``benchmark/metrics/<name>.py``) take a ``Trace`` and return a
number or None.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import json
import pathlib
from typing import Dict, List, NamedTuple, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "bench."
# Device operations' names (C++ templates) are cut to this many characters
# in the breakdown.
NAME_CHARS = 160


class Activity(NamedTuple):
    name: str
    cat: str
    start: float  # us
    dur: float  # us
    frame: Optional[int]  # index among the traced frames
    spans: Tuple[str, ...]  # benchmark spans holding its launch, outer first


class Trace(NamedTuple):
    activities: List[Activity]
    frames: List[Tuple[float, float]]  # host (start, end) us of each frame
    host_ops: List[Tuple[float, float, str]]  # (start, end, name) us
    spans: List[Tuple[float, float, str]]  # benchmark spans, frames too
    # Per traced frame j (keys): the reference's K1 and K2 bounds in ms
    # where sampled, the frame's least time in s, and its measured time in
    # the window in s.
    k1_bound_ms: Dict[int, float]
    k2_bound_ms: Dict[int, float]
    least_s: Dict[int, float]
    window_frame_s: Dict[int, float]

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    @property
    def window(self) -> Tuple[float, float]:
        return self.frames[0][0], self.frames[-1][1]

    def in_span(self, span: str) -> List[Activity]:
        return [a for a in self.activities if span in a.spans]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the activities' intervals inside the window."""
        w0, w1 = self.window
        return _union((max(a.start, w0), min(a.start + a.dur, w1))
                      for a in self.activities)

    def frame_busy_s(self, j: int) -> float:
        """Seconds in which the device ran an activity that traced frame
        ``j`` launched (the union of their intervals)."""
        return sum(e - s for s, e in _union(
            (a.start, a.start + a.dur) for a in self.activities
            if a.frame == j)) * 1e-6


def _union(ivs) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(ivs):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def load_spans(root: pathlib.Path) -> Dict[str, Dict]:
    return {p.stem: json.loads(p.read_text())
            for p in sorted((root / "benchmark" / "spans").glob("*.json"))}


class Wrapped:
    """Wraps each span's attribute in ``record_function`` while entered."""

    def __init__(self, spans: Dict[str, Dict], log):
        self.spans, self.log = spans, log
        self.undo = []

    def __enter__(self):
        from torch.profiler import record_function

        for name, sp in self.spans.items():
            try:
                owner = importlib.import_module(sp["module"])
                *path, attr = sp["attr"].split(".")
                for part in path:
                    owner = getattr(owner, part)
                orig = getattr(owner, attr)
            except (ImportError, AttributeError) as exc:
                self.log(f"span {name}: {sp['module']}.{sp['attr']} not "
                         f"found ({exc}); not traced")
                continue

            def wrap(fn, label=PREFIX + name):
                @functools.wraps(fn)
                def inner(*args, **kwargs):
                    with record_function(label):
                        return fn(*args, **kwargs)
                return inner

            setattr(owner, attr, wrap(orig))
            self.undo.append((owner, attr, orig))
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self.undo):
            setattr(owner, attr, orig)
        self.undo.clear()
        return False


def parse(chrome: Dict) -> Tuple[list, list, list, list]:
    """Device activities with their frame and spans, the frame intervals,
    the host's operations and the benchmark spans, each (start, end, name),
    from an exported Chrome trace."""
    events = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"][len(PREFIX):], e.get("tid"))
                    for e in events if e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith(PREFIX)),
                   key=lambda s: (s[0], -s[1]))
    frames = [(s, e) for s, e, n, _ in spans if n == "frame"]
    layer_spans = [s for s in spans if s[2] != "frame"]

    def locate(ts: float, tid) -> Tuple[Optional[int], Tuple[str, ...]]:
        frame = next((j for j, (s, e) in enumerate(frames) if s <= ts <= e),
                     None)
        held = tuple(n for s, e, n, t in layer_spans
                     if s <= ts <= e and t == tid)
        return frame, held

    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (float(e["ts"]), e.get("tid"))
    acts = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        frame, held = (None, ())
        if corr in launch:
            frame, held = locate(*launch[corr])
        acts.append(Activity(e["name"], e["cat"], float(e["ts"]),
                             float(e["dur"]), frame, held))
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") == "cpu_op"]
    return acts, frames, host, [(s, e, n) for s, e, n, _ in spans]


def breakdown(t: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps of the device by what the host was doing (the innermost
    benchmark span and host operation under way when the gap began)."""
    by_op: Dict[str, float] = {}
    for a in t.activities:
        by_op[a.name] = by_op.get(a.name, 0.0) + a.dur * 1e-6
    busy = t.busy_intervals()
    w0, w1 = t.window
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((s, e))
    spans, ops = sorted(t.spans), sorted(t.host_ops)
    span_at, op_at = [iv[0] for iv in spans], [iv[0] for iv in ops]
    by_gap: Dict[str, float] = {}
    for s, e in gaps:
        label = "/".join((_innermost(spans, span_at, s) or "between_frames",
                          _innermost(ops, op_at, s) or "python"))
        by_gap[label] = by_gap.get(label, 0.0) + (e - s) * 1e-6
    rank = lambda d: [[k[:NAME_CHARS], v] for k, v in
                      sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_gap)}


def _innermost(ivs: List[Tuple[float, float, str]], starts: List[float],
               ts: float) -> Optional[str]:
    """The name of the shortest of the sorted intervals ``ivs`` (their
    ``starts``) that holds ``ts``. Host intervals nest, so the candidates
    began shortly before it."""
    k = bisect.bisect_right(starts, ts)
    under = [iv for iv in ivs[max(0, k - 64):k] if iv[1] >= ts]
    return min(under, key=lambda iv: iv[1] - iv[0])[2] if under else None
