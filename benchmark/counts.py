"""The yardstick's operations, bytes and peaks.

Frozen here so that a change to the program cannot change what it is
measured against:

  * ``PEAKS``: the published dense peaks of the cards, copied from the
    port's ``utils/arith._PEAKS`` (NVIDIA's data sheets; the rates assume
    the card's full power limit, 700 W for the SXM part).
  * ``bound``, ``k1_cost``, ``k2_cost``: ``chip_smoke.py``'s kernel bound
    and its K1 / K2 byte and operation counts (``chip_smoke.py:505-511,
    755-812``), on the inputs of the frame that was timed: each input byte
    read once and each output byte written once, and the fp32 operations
    per (pixel, plane) pair that composites, per shown label tap and per
    screen pixel.
  * ``frame_work``: the nominal work of one frame from the frame's
    definition (screen, content crop, pose, field stride), never from the
    port's intermediate choices (its intermediate resolution, its dense
    hat-weight products): the MLP's FLOPs at the field points, the
    compositing operations at the samples the screen's rays take, and the
    bytes of the cropped volumes read once and of the frame written once.
    ``least_time`` is the largest of the three times on the card's peaks.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch


class Peaks(NamedTuple):
    bf16: float  # FLOP/s, tensor cores, dense
    fp32: float  # FLOP/s outside the tensor cores
    bytes: float  # device memory bytes/s


# Keyed on a substring of ``torch.cuda.get_device_name``.
PEAKS = {
    "H100 80GB HBM3": Peaks(bf16=989.4e12, fp32=67e12, bytes=3.35e12),  # SXM
    "H100 PCIe": Peaks(bf16=756e12, fp32=51e12, bytes=2.0e12),
    "H100 NVL": Peaks(bf16=835e12, fp32=60e12, bytes=3.9e12),
}

# fp32 operations (chip_smoke.py:416-426): per (pixel, plane) pair that
# composites (gate, entry correction, 2-tap lerp, transfer, alpha with its
# expf, colour and T update); per such pair when an overlay is on, the
# nearest label row (clamp, round); per overlay tap whose label is in
# [1, 8) (alpha with its expf, three colour sums, T update); per screen
# pixel of the warp (ray, base-plane hit, maps, clamps, weights, 3
# channels).
K1_OPS_PLANE = 40
K1_OPS_NEAREST = 3
K1_OPS_LABEL = 14
K2_OPS_PIXEL = 60


def peaks_for(device_name: str) -> Optional[Peaks]:
    """The card's peaks, or None for a card not in the table (no rate is
    then worked out against a guess)."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


def bound(peaks: Peaks, nbytes: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes = nbytes / peaks.bytes * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_cost(K: int, Na: int, O: int, row_overlays: int, field_numel: int,
            n_active: int, n_labeled: int):
    """K1's (bytes, fp32 operations) on one frame's inputs: stage 1's bf16
    rows (K, Na, O), ``row_overlays`` uint8 label rows of the same shape,
    the uint8 field (K1b), the (K, 7) plane table, the scalars and LUT,
    C and T written, vmag, dt_map and r_map read; ``n_active`` (pixel,
    plane) pairs that composite and ``n_labeled`` shown label taps."""
    overlays = row_overlays + (1 if field_numel else 0)
    nbytes = (K * Na * O * 2 + row_overlays * K * Na * O + field_numel
              + K * 7 * 4 + (16 + 32) * 4 + 3 * O * O * 4 + 4 * O * O * 4)
    ops = (n_active * (K1_OPS_PLANE + (K1_OPS_NEAREST if overlays else 0))
           + n_labeled * K1_OPS_LABEL)
    return nbytes, ops


def k2_cost(n_touched: int, width: int, height: int):
    """K2's (bytes, fp32 operations): the intermediate pixels that some
    valid screen pixel's four corners touch, the 24 scalars, the frame."""
    return (n_touched * 3 * 4 + 24 * 4 + height * width * 3 * 4,
            height * width * K2_OPS_PIXEL)


def mlp_macs(widths: Sequence[int]) -> int:
    """Multiply-adds of one point through dense layers of these widths
    (input first, output last)."""
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def inr_widths(model: Dict, n_modalities: int) -> list:
    """[input, hidden..., classes] of the INR: 3 coordinates, 2K
    harmonics of each, the modalities; the first layer unfactored."""
    k = model["fourier_freqs"]
    return [3 + 3 * 2 * k + n_modalities, *model["hidden_dims"],
            model["num_classes"]]


def frame_samples(cam, width: int, height: int, vol_min, voxel,
                  crop_box, device="cpu") -> float:
    """Sum over the (height x width) pixel-centre rays of the planes of
    the sweep axis (the view direction's largest component) that each ray
    crosses inside the content crop ``crop_box`` ((lo, hi) voxel indices
    per axis x, y, z; the planes are its integer slices lo..hi). ``cam``:
    (eye, right, up, forward, fov_y) as numbers."""
    eye, right, up, fwd, fov_y = cam
    f64 = torch.float64
    t = lambda v: torch.as_tensor(list(map(float, v)), dtype=f64,
                                  device=device)
    eye, right, up, fwd = t(eye), t(right), t(up), t(fwd)
    vol_min, voxel = t(vol_min), t(voxel)
    axis = int(torch.argmax(torch.abs(fwd)))
    f = 1.0 / math.tan(0.5 * float(fov_y))
    aspect = width / max(1.0, float(height))
    xs = (torch.arange(width, dtype=f64, device=device) + 0.5) / width \
        * 2.0 - 1.0
    ys = (torch.arange(height, dtype=f64, device=device) + 0.5) / height \
        * 2.0 - 1.0
    cx = (xs * aspect / f)[None, :, None]
    cy = (-ys / f)[:, None, None]
    d = cx * right + cy * up + fwd  # (H, W, 3)
    lo = vol_min + voxel * t([c[0] for c in crop_box])
    hi = vol_min + voxel * t([c[1] for c in crop_box])
    safe = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t0 = (lo - eye) / safe
    t1 = (hi - eye) / safe
    t_in = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
    t_out = torch.maximum(t0, t1).amin(-1)
    k_in = (eye[axis] + t_in * d[..., axis] - vol_min[axis]) / voxel[axis]
    k_out = (eye[axis] + t_out * d[..., axis] - vol_min[axis]) / voxel[axis]
    k_lo, k_hi = crop_box[axis]
    a = torch.clamp(torch.minimum(k_in, k_out), k_lo, k_hi)
    b = torch.clamp(torch.maximum(k_in, k_out), k_lo, k_hi)
    # A ray that enters or leaves through a face of the sweep axis lies on
    # that face's plane: it crosses it, whatever the last bit says.
    n = torch.floor(b + 1e-9) - torch.ceil(a - 1e-9) + 1.0
    n = torch.where(t_out > t_in, torch.clamp(n, min=0.0),
                    torch.zeros_like(n))
    return float(n.sum())


class FrameWork(NamedTuple):
    samples: float  # (ray, plane) pairs inside the content crop
    mlp_flops: float
    comp_ops: float
    nbytes: float


def frame_work(samples: float, width: int, height: int, crop_voxels: int,
               overlays: int, field_stride: Optional[int] = None,
               model: Optional[Dict] = None, n_modalities: int = 4,
               ) -> FrameWork:
    """The frame's nominal work at ``samples`` ray-plane pairs
    (``frame_samples``): with an INR, ``samples / stride^2`` field points
    through its dense layers, 2 FLOPs a multiply-add; the compositing's
    fp32 operations a sample (the intensity's, and each overlay's nearest
    label and its compositing); the bytes of the cropped volumes as the
    configuration gives them (the float32 display intensity, uint8 labels,
    and for the INR its float32 modalities) read once, and the float32 RGB
    frame written once."""
    mlp = 0.0
    vol_bytes = 4 + (1 if overlays else 0)
    if model is not None:
        mlp = 2.0 * mlp_macs(inr_widths(model, n_modalities)) * samples \
            / float(field_stride) ** 2
        vol_bytes += 4 * n_modalities
    comp = samples * (K1_OPS_PLANE
                      + overlays * (K1_OPS_NEAREST + K1_OPS_LABEL))
    return FrameWork(samples, mlp, comp,
                     float(crop_voxels) * vol_bytes + width * height * 3 * 4)


def least_time(work: FrameWork, peaks: Peaks) -> float:
    """Seconds: the largest of the MLP's FLOPs on the bf16 tensor cores,
    the compositing on the fp32 units and the bytes on device memory."""
    return max(work.mlp_flops / peaks.bf16, work.comp_ops / peaks.fp32,
               work.nbytes / peaks.bytes)
