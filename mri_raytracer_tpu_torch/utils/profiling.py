"""Tracing / profiling utilities (port of ``utils/profiling.py``).

  * ``FPSMeter`` — EMA of 1/frame-time (the reference viewer's overlay)
  * ``sync`` — wait for a tensor's device work
  * ``batch_times`` / ``median_time`` — batches of calls queued back to
    back, one ``sync`` a batch
  * ``Timer`` / ``timed`` — wall-clock sections that end in ``sync``
  * ``trace`` — ``torch.profiler`` around a block, exported as a Chrome
    trace
  * ``RenderStats`` — steps/ray and composite-work counters
"""

from __future__ import annotations

import contextlib
import pathlib
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

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


@dataclass
class Timer:
    name: str = "section"
    times: List[float] = field(default_factory=list)

    @contextlib.contextmanager
    def __call__(self, out=None):
        t0 = time.perf_counter()
        yield
        if out is not None:
            sync(out)
        self.times.append(time.perf_counter() - t0)

    @property
    def mean_ms(self) -> float:
        return 1000.0 * sum(self.times) / max(len(self.times), 1)

    def report(self) -> str:
        return f"{self.name}: {self.mean_ms:.2f} ms over {len(self.times)} runs"


@contextlib.contextmanager
def timed(name: str = "section", out=None):
    t0 = time.perf_counter()
    yield
    if out is not None:
        sync(out)
    print(f"[timed] {name}: {(time.perf_counter() - t0) * 1000:.2f} ms")


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` over the block (host activities, and the card's
    when there is one); yields the profiler (``key_averages()``) and writes
    ``{log_dir}/trace.json``, a Chrome trace (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


@dataclass
class RenderStats:
    """Per-frame renderer work counters."""

    planes: int = 0
    rays: int = 0
    samples: int = 0

    @property
    def steps_per_ray(self) -> float:
        return self.samples / max(self.rays, 1)

    def to_dict(self) -> Dict[str, float]:
        return {"planes": self.planes, "rays": self.rays,
                "samples": self.samples, "steps_per_ray": self.steps_per_ray}
