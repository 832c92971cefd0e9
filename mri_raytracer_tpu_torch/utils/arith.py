"""Arithmetic accounting for the fused shear-warp frame: FLOPs per frame,
achieved TFLOP/s, MFU, steps per ray (port of ``utils/arith.py``).

What is counted (matrix FLOPs, the MFU convention), with the JAX package's
formulas, so that the same ``stats`` and executed-plane map give the same
FLOPs on both sides:
  * stage 1 — the b-axis resample products: one bilinear half for the
    intensity and one nearest half per overlay, each ``2*K*Na*Nb*O``;
    unconditional, so the static count is exact. (The port gathers the
    label rows by index instead of a one-hot product; the count keeps the
    JAX package's convention.)
  * stage 2 — the a-axis resample: ``2*Na`` per (pixel, plane) pair for
    the intensity and again per overlay. Gated by the content box, the
    gates and the T <= 0.01 exit, so the static ``K*O^2`` pairs are an
    UPPER BOUND; pass the exact map from ``BratsRenderer.executed_planes``
    (kernel K1c) to make it exact.
  * warp — zero: the port's warp (kernel K2) is a gather, no matrix
    product. This is the JAX package's own branch when its matrix warp does
    not run (``arith.py:121-124``).

Not counted: elementwise work (transfer function, exp, compositing, LUT)
and memory traffic. MFU here answers "how much of the tensor cores the
design uses", not "which unit is the bottleneck".
"""

from __future__ import annotations

import warnings
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch


class Peaks(NamedTuple):
    """Published dense peaks of one card (NVIDIA's data sheets)."""

    bf16: float  # FLOP/s, tensor cores, without sparsity
    fp32: float  # FLOP/s outside the tensor cores
    bytes: float  # device memory bytes/s


# Keyed on a substring of ``torch.cuda.get_device_name``. The rates assume
# the card's full power limit (700 W for the SXM part).
_PEAKS = {
    "H100 80GB HBM3": Peaks(bf16=989.4e12, fp32=67e12, bytes=3.35e12),  # SXM
    "H100 PCIe": Peaks(bf16=756e12, fp32=51e12, bytes=2.0e12),
    "H100 NVL": Peaks(bf16=835e12, fp32=60e12, bytes=3.9e12),
}
DEFAULT_NAME = "H100 80GB HBM3"


def device_peaks(device=None) -> Peaks:
    """Peaks of the card named by ``torch.cuda.get_device_name(device)``
    (default: the current card).

    An unrecognized name falls back to the H100 SXM peaks with a warning:
    an MFU computed against the wrong peak should be visibly flagged, not
    silently plausible."""
    name = torch.cuda.get_device_name(device)
    for key, peaks in _PEAKS.items():
        if key in name:
            return peaks
    warnings.warn(f"arith.device_peaks: unknown card {name!r}; falling back "
                  f"to the {DEFAULT_NAME} peaks "
                  f"({_PEAKS[DEFAULT_NAME].bf16 / 1e12:.1f} TFLOP/s bf16) — "
                  "MFU numbers will be wrong on this card", stacklevel=2)
    return _PEAKS[DEFAULT_NAME]


def peak_flops(device=None) -> float:
    """Dense bf16 tensor-core peak of the card, FLOP/s."""
    return device_peaks(device).bf16


def frame_flops(stats: Dict, width: int, height: int,
                executed_planes: Optional[np.ndarray] = None) -> Dict:
    """Matrix FLOPs of one fused shear-warp frame.

    ``stats``: ``BratsRenderer.frame_stats(basis, params)``.
    ``executed_planes``: optional (out_res, out_res) map from
    ``BratsRenderer.executed_planes``; with it stage 2 is exact,
    ``2*Na*(1+n_ov)*sum(map)``. ``width``/``height`` are kept for the JAX
    signature: they sized the JAX package's matrix warp, and the port's
    warp has none."""
    O = stats["out_res"]
    K = stats["planes"]
    Na = stats["Na"]
    Nb = stats["Nb"]
    n_ov = int(stats["has_seg"]) + int(stats["has_pred"])

    stage1 = 2.0 * K * Na * Nb * O * (1 + n_ov)

    per_dot = 2.0 * Na * (1 + n_ov)
    if executed_planes is not None:
        executed_planes = np.asarray(executed_planes)
        stage2 = per_dot * float(executed_planes.sum(dtype=np.float64))
        steps_eff = float(executed_planes.mean(dtype=np.float64))
    else:
        stage2 = per_dot * K * float(O) * O
        steps_eff = float(K)

    return {
        "flops_stage1": stage1,
        "flops_stage2": stage2,
        "flops_warp": 0.0,
        "flops_total": stage1 + stage2,
        "stage2_exact": executed_planes is not None,
        "warp_mxu": False,
        "steps_per_ray_max": float(K),
        "steps_per_ray_eff": steps_eff,
    }


def mfu(flops_per_frame: float, fps: float, device=None) -> Dict:
    """Achieved TFLOP/s and model FLOP utilization against the card's dense
    bf16 peak."""
    achieved = flops_per_frame * fps
    peak = peak_flops(device)
    return {
        "tflops_per_s": achieved / 1e12,
        "mfu": achieved / peak,
        "peak_tflops": peak / 1e12,
    }
