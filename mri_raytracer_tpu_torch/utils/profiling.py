"""Tracing / profiling utilities (port of ``utils/profiling.py``).

  * ``FPSMeter`` — EMA of 1/frame-time (the reference viewer's overlay)
  * ``sync`` — wait for a tensor's device work
  * ``batch_times`` / ``median_time`` — batches of calls queued back to
    back, one ``sync`` a batch
  * ``span`` / ``frame`` — the renderers' spans, recorded in memory while
    ``enable_spans`` has them on (``take_spans``, ``self_ns``)
  * ``count`` — process-wide counters of repeated work (``counters``,
    ``reset_counters``), always on
  * ``trace`` — ``torch.profiler`` around a block with the spans on,
    exported as a Chrome trace

Spans and counters never read a device value or wait for the device, so a
frame stays free of host-device syncs with them on.
"""

from __future__ import annotations

import contextlib
import pathlib
import statistics
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch


class FPSMeter:
    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.fps = 0.0
        self._last: Optional[float] = None

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            inst = 1.0 / dt
            self.fps = inst if self.fps == 0.0 else \
                (1 - self.alpha) * self.fps + self.alpha * inst
        self._last = now
        return self.fps


def sync(x) -> None:
    """Wait for the work queued on a CUDA tensor's device; a CPU tensor
    (or anything else) is already done."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def batch_times(fn, frames: int, batches: int = 3, warm: bool = True
                ) -> List[float]:
    """Wall-clock seconds a call of ``fn`` (which returns a tensor), one
    entry a batch: after a synced warm call (unless ``warm`` is False),
    ``batches`` batches of ``frames`` calls are queued back to back, each
    batch ended by one ``sync`` and never a call."""
    if warm:
        sync(fn())
    ts = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(frames):
            out = fn()
        sync(out)
        ts.append((time.perf_counter() - t0) / frames)
    return ts


def median_time(fn, frames: int, batches: int = 3) -> float:
    """Median over ``batch_times``' batches: seconds a call of ``fn``."""
    return statistics.median(batch_times(fn, frames, batches))


# ------------------------------------------------------------------- spans
# Each renderer marks its layers with ``span`` and each frame with
# ``frame``. While spans are off (the default) ``span`` is one flag check
# that returns a shared no-op context: no allocation, no clock read, no
# profiler call. While on, each span is kept in memory with its frame and
# parent, and under a running ``torch.profiler`` it is also the range
# ``mrt.<name>`` of the profiler's trace, so the kernels and copies it
# launched can be put down to it.

PREFIX = "mrt."


class Span(NamedTuple):
    """One closed span, its times by ``time.perf_counter_ns``."""

    frame: Optional[int]  # id of the frame it ran in (``frame``), or None
    name: str
    parent: Optional[str]  # name of the span it ran inside, or None
    start_ns: int
    end_ns: int


class _Thread(threading.local):
    def __init__(self):
        self.open: List[str] = []  # names of the open spans, outer first
        self.depth = 0  # open ``frame`` scopes
        self.frame: Optional[int] = None  # id of the outermost one
        self.frame_span: Optional[_Span] = None


_on = False
_spans: List[Span] = []
_thread = _Thread()
_OFF = contextlib.nullcontext()
_counters: Dict[str, float] = {}
_counter_lock = threading.Lock()


class _Span:
    __slots__ = ("name", "parent", "frame", "start", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        th = _thread
        self.parent = th.open[-1] if th.open else None
        self.frame = th.frame
        th.open.append(self.name)
        self.annotation = None
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(
                PREFIX + self.name)
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _thread.open.pop()
        _spans.append(Span(self.frame, self.name, self.parent, self.start,
                           end))
        return False


def span(name: str):
    """Context of one layer's work, named ``name``, recorded while spans
    are on."""
    if not _on:
        return _OFF
    return _Span(name)


class _Frame:
    """``frame``'s context. It keeps its state in the thread, so one
    object serves every frame and a frame opened inside another (a
    renderer calling another's ``render``) is part of the outer one."""

    def __enter__(self):
        th = _thread
        th.depth += 1
        if th.depth == 1:
            th.frame = int(count("frames"))
            if _on:
                th.frame_span = _Span("frame").__enter__()
        return self

    def __exit__(self, *exc):
        th = _thread
        th.depth -= 1
        if th.depth == 0:
            if th.frame_span is not None:
                th.frame_span.__exit__(*exc)
                th.frame_span = None
            th.frame = None
        return False


_FRAME = _Frame()


def frame():
    """Context of one rendered frame: counts it in ``frames``, whose new
    value is the frame's id, and while spans are on records the span
    ``frame``, which every span inside it carries the id of."""
    return _FRAME


def enable_spans(on: bool = True) -> bool:
    """Turns the spans on or off; returns whether they were on."""
    global _on
    was, _on = _on, bool(on)
    return was


def take_spans() -> List[Span]:
    """The spans closed since the last call, in the order they closed."""
    global _spans
    out, _spans = _spans, []
    return out


def self_ns(s: Span, spans: Sequence[Span]) -> int:
    """``s``'s host time less the union of its children's intervals (the
    spans of ``spans`` opened directly inside it)."""
    kids = sorted((c.start_ns, c.end_ns) for c in spans
                  if c.parent == s.name and c.frame == s.frame
                  and c is not s and s.start_ns <= c.start_ns
                  and c.end_ns <= s.end_ns)
    covered, reach = 0, s.start_ns
    for a, b in kids:
        a = max(a, reach)
        if b > a:
            covered += b - a
            reach = b
    return s.end_ns - s.start_ns - covered


# ---------------------------------------------------------------- counters
# ``frames``: frames rendered (``frame``); ``sweep.prep_misses``: frames
# that built a sweep axis's prepared volumes; ``sweep.param_uploads``:
# frames that copied new render params to the device; ``kernels.builds``
# and ``kernels.build_s``: CUDA libraries compiled and the seconds it took;
# ``field.points``: INR evaluations of the live prediction field.


def count(name: str, n: float = 1) -> float:
    """Adds ``n`` to the counter ``name``; returns its new value."""
    with _counter_lock:
        v = _counters[name] = _counters.get(name, 0) + n
    return v


def counters() -> Dict[str, float]:
    """A copy of every counter."""
    with _counter_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counter_lock:
        _counters.clear()


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` over the block (host activities, and the card's
    when there is one) with the spans on, each span a ``mrt.<name>`` range
    holding what it launched; yields the profiler (``key_averages()``) and
    writes ``{log_dir}/trace.json``, a Chrome trace (chrome://tracing,
    Perfetto). The spans stay in memory for ``take_spans``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    was = enable_spans(True)
    try:
        with profile(activities=acts) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        enable_spans(was)
    prof.export_chrome_trace(str(out / "trace.json"))
