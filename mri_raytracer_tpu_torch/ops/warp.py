"""Kernel K2: homography warp of the composited intermediate to screen.

Replaces ``mri_raytracer_tpu/ops/pallas_warp.py::_make_warp_kernel``
(launched by ``warp_pallas_exec``, ``pallas_warp.py:222``). The TPU kernel
streamed a fixed source window per 32x32 tile and interpolated with hat
matmuls, behind a host footprint ladder and a fit check with a gather
fallback. On Hopper a gather is cheap, so ``csrc/warp.cu`` computes each
pixel's source position from the camera and the sweep scalars and reads its
4 bilinear corners — no window, no ladder, no fallback: 32 x 8 screen tiles
on a persistent grid, a warp over an 8 x 4 patch with 2 pixels a thread
down its column, their loads issued together, the warp's rows written as
float4s through shared memory, and no loads for a pixel off the
intermediate. It is bound by bytes: the intermediate read once and the frame
written once.

``warp_screen`` runs the kernel for CUDA tensors and ``warp_screen_plain``
(the gather warp of ``shearwarp.py:733-780, 808-809``) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from mri_raytracer_tpu_torch.ops import kernels
from mri_raytracer_tpu_torch.utils import profiling

_EPS = 1e-6
_ORDER = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}
_F32 = torch.float32
# Layout of the (24,) scalar vector ``s``: the packed camera (eye, right,
# up, forward, fov_y), then the sweep scalars w_base, e (permuted k, a, b),
# a0, da, b0, db, then the background colour.
N_SCALARS = 24
_CAM, _WB, _E, _A0, _DA, _B0, _DB, _BG = 0, 13, 14, 17, 18, 19, 20, 21
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_void_p)


def _perm(v: torch.Tensor, axis: int) -> torch.Tensor:
    o = _ORDER[axis]
    return torch.stack([v[o[0]], v[o[1]], v[o[2]]])


def screen_maps(s: torch.Tensor, axis: int, O: int, width: int, height: int):
    """Per screen pixel: intermediate coordinates (i_map, j_map), clamped
    to [0, O-1], and whether the pixel's ray hits the intermediate plane
    in front of the eye inside it (``valid``). The ray normalization
    cancels in ``e + t_base * d``, so unnormalized directions are used."""
    dev = s.device
    f = 1.0 / torch.tan(0.5 * s[_CAM + 12])
    aspect = width / max(1.0, float(height))
    xs = (torch.arange(width, dtype=_F32, device=dev) + 0.5) / width * 2.0 - 1.0
    ys = (torch.arange(height, dtype=_F32, device=dev) + 0.5) / height * 2.0 - 1.0
    cx = (xs * aspect / f)[None, :]  # (1, W)
    cy = (-ys / f)[:, None]  # (H, 1)
    R = _perm(s[_CAM + 3:_CAM + 6], axis)
    U = _perm(s[_CAM + 6:_CAM + 9], axis)
    F = _perm(s[_CAM + 9:_CAM + 12], axis)
    e = s[_E:_E + 3]
    dk = cx * R[0] + cy * U[0] + F[0]  # (H, W)
    da_ = cx * R[1] + cy * U[1] + F[1]
    db_ = cx * R[2] + cy * U[2] + F[2]
    denom = torch.where(torch.abs(dk) < _EPS, torch.full_like(dk, _EPS), dk)
    t_base = (s[_WB] - e[0]) / denom
    hit_a = e[1] + t_base * da_
    hit_b = e[2] + t_base * db_
    i_map = (hit_a - s[_A0]) / s[_DA]
    j_map = (hit_b - s[_B0]) / s[_DB]
    valid = (t_base > 0.0) & (i_map >= 0.0) & (i_map <= O - 1) & \
            (j_map >= 0.0) & (j_map <= O - 1)
    # Clamp before warping: invalid pixels are masked to the background.
    i_map = torch.clamp(i_map, 0.0, O - 1.0)
    j_map = torch.clamp(j_map, 0.0, O - 1.0)
    return i_map, j_map, valid


def bilinear_gather(C: torch.Tensor, i_map: torch.Tensor,
                    j_map: torch.Tensor) -> torch.Tensor:
    """(O, O, 3) sampled bilinearly at (i_map, j_map) -> (..., 3); the
    base corner is clipped to O-2 so the far corner stays in range."""
    O = C.shape[0]
    i0 = torch.clamp(torch.floor(i_map).long(), 0, O - 2)
    j0 = torch.clamp(torch.floor(j_map).long(), 0, O - 2)
    fi = torch.clamp(i_map - i0.to(_F32), 0.0, 1.0)[..., None]
    fj = torch.clamp(j_map - j0.to(_F32), 0.0, 1.0)[..., None]
    flat = C.reshape(O * O, 3)
    base = i0 * O + j0
    q00 = flat[base]
    q01 = flat[base + 1]
    q10 = flat[base + O]
    q11 = flat[base + O + 1]
    w00 = (1 - fi) * (1 - fj)
    w01 = (1 - fi) * fj
    w10 = fi * (1 - fj)
    w11 = fi * fj
    return q00 * w00 + q01 * w01 + q10 * w10 + q11 * w11


def warp_screen_plain(C: torch.Tensor, s: torch.Tensor, axis: int,
                      width: int, height: int) -> torch.Tensor:
    """Plain PyTorch version of K2 (the gather warp)."""
    i_map, j_map, valid = screen_maps(s, axis, C.shape[0], width, height)
    out = bilinear_gather(C, i_map, j_map)
    out = torch.where(valid[..., None], out, 0.0)
    return s[_BG:_BG + 3] + out


def warp_screen(C: torch.Tensor, s: torch.Tensor, axis: int, width: int,
                height: int) -> torch.Tensor:
    """(O, O, 3) intermediate + (24,) scalars -> (height, width, 3) frame.
    Launches K2 for CUDA tensors, runs the plain version for CPU tensors.
    K2 has no backward: on the card it refuses inputs that require grad
    while grad is enabled."""
    with profiling.span("k2"):
        if C.dim() != 3 or C.shape[0] != C.shape[1] or C.shape[2] != 3 \
                or C.shape[0] < 2:
            raise ValueError("C must be (O, O, 3) with O >= 2, got "
                             f"{tuple(C.shape)}")
        if s.shape != (N_SCALARS,):
            raise ValueError(f"s must be ({N_SCALARS},), got {tuple(s.shape)}")
        if C.device != s.device:
            raise ValueError(f"C on {C.device} but s on {s.device}")
        if C.dtype != _F32 or s.dtype != _F32:
            raise TypeError("C and s must be float32")
        if axis not in _ORDER:
            raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
        if C.device.type == "cpu":
            return warp_screen_plain(C, s, axis, width, height)
        if C.device.type != "cuda":
            raise RuntimeError(f"no warp for device {C.device}")
        kernels.refuse_grad("warp_screen (kernel K2)", C, s)
        if not (C.is_contiguous() and s.is_contiguous()):
            raise ValueError("C and s must be contiguous")
        index = C.device.index
        if index == torch.cuda.current_device():
            out = _launch(C, s, axis, width, height, index)
        else:
            with torch.cuda.device(index):
                out = _launch(C, s, axis, width, height, index)
        warp_screen.launches += 1
        return out


def current_stream_handle(index: int) -> int:
    """The raw ``cudaStream_t`` of device ``index``'s current stream, as an
    int. ``torch._C._cuda_getCurrentRawStream`` reads it without building
    the Python Stream object of ``torch.cuda.current_stream()``, which costs
    a third of the wrapper's host time (``tools/k2_ablation.py``; checked
    on torch 2.11.0+cu128). It is a private call: where a torch build lacks
    it, the public one is used, and ``tests/test_torch_port_cuda.py`` holds
    the two equal on the card."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(index).cuda_stream
    return raw(index)


def _launch(C, s, axis, width, height, index):
    # The frame call sets K2's pace once the kernel is short, so the host
    # work is kept to the least: the entry is bound once, and new_empty
    # takes dtype and device from C.
    fn = kernels.function("warp", "mrt_warp", _ARGTYPES)
    out = C.new_empty((height, width, 3))
    err = fn(C.data_ptr(), s.data_ptr(), out.data_ptr(), C.shape[0], height,
             width, axis, width / max(1.0, float(height)),
             current_stream_handle(index))
    if err != 0:
        raise RuntimeError(f"warp kernel launch failed: cudaError {err}")
    return out


warp_screen.launches = 0
