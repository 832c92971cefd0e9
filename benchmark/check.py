"""The comparison that decides ``correct``.

Each checked frame that the timed path presented is held against the
reference's frame at the same pose, pixel by pixel, over the whole frame:

  * ``err_mean``: the mean absolute difference over every pixel and
    channel of the checked frames;
  * ``px_off_share``: the share of their pixels whose largest channel
    difference exceeds ``OFF`` (half a step of an 8-bit display).

A value that is not finite counts as off by 1, the whole range of a
channel (so every number stays finite in the result line). Both numbers have a
limit of their own in the configuration (``limits``), set from the
program's readings over many seeds and the control's (``control.py``);
``correct`` holds when each number is within its limit. ``err_max`` is
reported beside them and not compared: one INR label that flips at a near
tie moves a few pixels by up to ~0.01.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

OFF = 0.5 / 255.0
COMPARED = ("err_mean", "px_off_share")


def frame_diff(out: np.ndarray, ref: torch.Tensor) -> Dict[str, float]:
    """Sums over one frame: absolute difference, pixels off, pixels."""
    got = torch.as_tensor(np.asarray(out, np.float32), device=ref.device)
    if got.shape != ref.shape:
        raise ValueError(f"frame {tuple(got.shape)}, reference "
                         f"{tuple(ref.shape)}")
    d = (got - ref).abs()
    d = torch.where(torch.isfinite(d), d, torch.ones_like(d))
    per_px = d.amax(-1)
    return {"abs_sum": float(d.double().sum()), "n_values": d.numel(),
            "n_off": int((per_px > OFF).sum()), "n_px": per_px.numel(),
            "max": float(per_px.max())}


def summarize(diffs: List[Dict[str, float]]) -> Dict[str, float]:
    return {
        "err_mean": (sum(d["abs_sum"] for d in diffs)
                     / sum(d["n_values"] for d in diffs)),
        "px_off_share": (sum(d["n_off"] for d in diffs)
                         / sum(d["n_px"] for d in diffs)),
        "err_max": max(d["max"] for d in diffs),
        "frames": len(diffs),
    }


def frame_fails(d: Dict[str, float], limits: Dict[str, float]) -> bool:
    """One frame read by itself against the limits."""
    s = summarize([d])
    return any(not s[k] <= limits[k] for k in COMPARED)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return numbers["frames"] > 0 and all(numbers[k] <= limits[k]
                                         for k in COMPARED)
