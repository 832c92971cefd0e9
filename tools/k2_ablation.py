#!/usr/bin/env python3
"""K2 (``mri_raytracer_tpu_torch/csrc/warp.cu``) against variants of itself
on one NVIDIA card: which part of the tiled design buys what.

    python3 tools/k2_ablation.py [--variants first_port,scalar_store,...]

Each variant is the kernel's source with one edit (``VARIANTS`` below;
'first_port' is the first port's kernel, one thread per pixel on rows of
256, whole), built by ``nvcc`` with the port's flags into
``build/k2_ablation/`` and launched through the same C entry (``mrt_warp``)
on the same intermediate and scalars as the unedited kernel ('base'): the
1024^2 bench frame of ``chip_smoke.py`` (256^3 synthetic case, seed 0, seg
overlay; C from K1) at each of its six poses (``chip_smoke.POSES``, those of
``bench.py``). Every variant's frame is held against base's (max abs error printed; no
edit changes a pixel's arithmetic) and base's against the plain version.
Each variant's kernel is renamed ``warp_kernel_<variant>``, so one
torch.profiler trace per pose and L2 state holds every variant's launches,
in turns, ROUNDS rounds of REPS; the median kernel time is printed with the
card's name and power limit, in three L2 states: 'dirty' (a 256 MB buffer
overwritten before each launch, as ``chip_smoke.py`` times K2: the L2 is
full of dirty lines, so each line K2 brings in writes one back), 'clean'
(the buffer only read: the L2 holds no dirty line) and 'warm' (back to
back: C and the frame's lines from the launch before are in L2). Beside
them, PyTorch's ``fill_`` of the frame: what writing its 12.6 MB alone
takes. Last, each variant's time over base's at every pose, by L2 state:
the least, the geometric mean and the most of the six ratios. Needs one
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "mri_raytracer_tpu_torch" / "csrc" / "warp.cu"
OUT = ROOT / "build" / "k2_ablation"
ROUNDS, REPS = 6, 8
VOL, WIDTH = (256, 256, 256), 1024
MODES = ("dirty", "clean", "warm")

# The first port's K2 (one thread per screen pixel, blocks of 256 pixels of
# one row, three scalar stores, the scalars read from global memory by every
# pixel), with the same C entry.
FIRST_PORT_SOURCE = r"""
#include <cstddef>
#include <cuda_runtime.h>
namespace {
constexpr int kThreads = 256;
__global__ void __launch_bounds__(kThreads)
    warp_kernel(const float* __restrict__ C, const float* __restrict__ s,
                float* __restrict__ out, int O, int H, int W, int axis,
                float aspect) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const int o0 = axis;
  const int o1 = axis == 0 ? 1 : 0;
  const int o2 = axis == 2 ? 1 : 2;
  const float* R = s + 3;
  const float* U = s + 6;
  const float* F = s + 9;
  const float f = 1.f / tanf(0.5f * s[12]);
  const float xs = ((float)x + 0.5f) / (float)W * 2.f - 1.f;
  const float ys = ((float)y + 0.5f) / (float)H * 2.f - 1.f;
  const float cx = xs * aspect / f;
  const float cy = -ys / f;
  const float dk = cx * R[o0] + cy * U[o0] + F[o0];
  const float da = cx * R[o1] + cy * U[o1] + F[o1];
  const float db = cx * R[o2] + cy * U[o2] + F[o2];
  const float denom = fabsf(dk) < 1e-6f ? 1e-6f : dk;
  const float t_base = (s[13] - s[14]) / denom;
  const float hit_a = s[15] + t_base * da;
  const float hit_b = s[16] + t_base * db;
  float i_map = (hit_a - s[17]) / s[18];
  float j_map = (hit_b - s[19]) / s[20];
  const float top = (float)(O - 1);
  const bool valid = t_base > 0.f && i_map >= 0.f && i_map <= top &&
                     j_map >= 0.f && j_map <= top;
  i_map = fminf(fmaxf(i_map, 0.f), top);
  j_map = fminf(fmaxf(j_map, 0.f), top);
  const int i0 = min(max((int)floorf(i_map), 0), O - 2);
  const int j0 = min(max((int)floorf(j_map), 0), O - 2);
  const float fi = fminf(fmaxf(i_map - (float)i0, 0.f), 1.f);
  const float fj = fminf(fmaxf(j_map - (float)j0, 0.f), 1.f);
  const float w00 = (1.f - fi) * (1.f - fj);
  const float w01 = (1.f - fi) * fj;
  const float w10 = fi * (1.f - fj);
  const float w11 = fi * fj;
  const float* q00 = C + ((size_t)i0 * O + j0) * 3;
  const float* q10 = q00 + (size_t)O * 3;
  float* o = out + ((size_t)y * W + x) * 3;
  for (int c = 0; c < 3; ++c) {
    const float v =
        q00[c] * w00 + q00[3 + c] * w01 + q10[c] * w10 + q10[3 + c] * w11;
    o[c] = s[21 + c] + (valid ? v : 0.f);
  }
}
}  // namespace
extern "C" int mrt_warp(const void* C, const void* s, void* out, int O,
                        int H, int W, int axis, float aspect, void* stream) {
  const dim3 block(kThreads);
  const dim3 grid((W + kThreads - 1) / kThreads, H);
  warp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)C, (const float*)s, (float*)out, O, H, W, axis, aspect);
  return (int)cudaGetLastError();
}
"""

# The warp's rows leave shared memory as one bulk copy (cp.async.bulk, the
# TMA's 1-D form) a row instead of float4 stores of consecutive lanes.
_FLOAT4_STORES = """    const int n4 = min(kWarpW, W - xw) * 3 / 4;
    const float4* b4 = reinterpret_cast<const float4*>(buf);
#pragma unroll
    for (int f = lane; f < kWarpRows * kRow4; f += 32) {
      const int r = f / kRow4, col = f % kRow4;
      if (col < n4 && yw + r < H)
        reinterpret_cast<float4*>(out + ((size_t)(yw + r) * W + xw) * 3)[col] =
            b4[f];
    }
"""
_BULK_STORES = """    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane < kWarpRows && yw + lane < H) {
      const unsigned bytes = min(kWarpW, W - xw) * 12;
      const unsigned src =
          (unsigned)__cvta_generic_to_shared(buf + lane * kWarpW * 3);
      float* dst = out + ((size_t)(yw + lane) * W + xw) * 3;
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
          :: "l"(dst), "r"(src), "r"(bytes) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
"""
_STORE_CALL = ("    store_rows<kWide>(out, s_rows[warp], W, H, xw, yw, lx, ly, "
               "v);")


def _shape(w=32, h=8, pix=2, warp_w=8):
    edits = []
    for name, old, new in (("kTileW", 32, w), ("kTileH", 8, h),
                           ("kPix", 2, pix), ("kWarpW", 8, warp_w)):
        if new != old:
            edits.append((f"constexpr int {name} = {old};",
                          f"constexpr int {name} = {new};"))
    return edits


# name: (what it tests, [(old text, new text), ...] or the whole source);
# each old text must occur exactly once in the source. The diagnostics
# change the frame: they only show what a part of the kernel costs.
VARIANTS = {
    "base": ("the kernel as it is", []),
    "first_port": ("the first port's kernel: a pixel a thread, rows of 256, "
            "scalar stores", FIRST_PORT_SOURCE),
    "warp32": ("a warp's patch 32 x 1 (a screen row) instead of 8 x 4",
               _shape(warp_w=32)),
    "warp16": ("a warp's patch 16 x 2", _shape(warp_w=16)),
    "scalar_store": ("each channel stored alone by its lane (no shared-"
                     "memory pass)", [("const bool wide =\n      W % 4 == 0 &&",
                                       "const bool wide =\n      false &&")]),
    "bulk_store": ("the warp's rows leave shared memory by cp.async.bulk, "
                   "one a row", [(_FLOAT4_STORES, _BULK_STORES)]),
    "pix1": ("1 pixel a thread (32 x 4 tiles)", _shape(h=4, pix=1)),
    "pix4": ("4 pixels a thread (32 x 16 tiles)", _shape(h=16, pix=4)),
    "pix8": ("8 pixels a thread (32 x 32 tiles)", _shape(h=32, pix=8)),
    "tile16x16": ("16 x 16 tiles, 2 x 2 warps", _shape(w=16, h=16)),
    "tile64x8": ("64 x 8 tiles, 8 warps (256 threads)", _shape(w=64)),
    "tile32x16": ("32 x 16 tiles, 8 warps (256 threads)", _shape(h=16)),
    "tile16x8": ("16 x 8 tiles, 2 warps (64 threads)", _shape(w=16)),
    "lb1": ("no register cap (1 block of 128 threads an SM guaranteed)",
            [("constexpr int kMinBlocks = 6;",
              "constexpr int kMinBlocks = 1;")]),
    "lb8": ("at most 64 registers (8 blocks of 128 threads an SM)",
            [("constexpr int kMinBlocks = 6;",
              "constexpr int kMinBlocks = 8;")]),
    "one_tile": ("one tile a block (a grid of every tile, not persistent)",
                 [("const int grid = tiles < n ? tiles : n;",
                   "const int grid = tiles;")]),
    "no_loads": ("diagnostic: no corner loads (every pixel blends zeros)",
                 [("      if (valid[p]) {",
                   "      if (valid[p] && O < 0) {")]),
    "no_stores": ("diagnostic: the frame is computed but not stored",
                  [(_STORE_CALL, "    if (v[0] == -1234.5f)\n  "
                    + _STORE_CALL)]),
    "bg_only": ("diagnostic: every pixel stores the background (no maps, no "
                "loads)", [("    // Maps, corner offsets and weights of the "
                            "thread's pixels.\n",
                            "    if (O > 0) {\n      float v[3 * kPix];\n"
                            "      for (int e = 0; e < 3 * kPix; ++e) "
                            "v[e] = fr.bg[e % 3];\n      store_rows<kWide>("
                            "out, s_rows[warp], W, H, xw, yw, lx, ly, v);\n"
                            "      continue;\n    }\n")]),
    "empty": ("diagnostic: every block returns at once (the launch alone)",
              [("  const Frame fr = load_frame(",
                "  if (O > 0) return;\n  const Frame fr = load_frame(")]),
}


def build(names, nvcc, flags):
    """Compile every variant at once; returns {name: library path}."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    jobs = {}
    for name in names:
        edit = VARIANTS[name][1]
        text = src
        if isinstance(edit, str):
            text = edit
        else:
            for old, new in edit:
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {old!r} occurs "
                                       f"{text.count(old)} times")
                text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text.replace("warp_kernel", f"warp_kernel_{name}"))
        so = OUT / f"lib{name}.so"
        log = open(OUT / f"{name}.log", "w")
        jobs[name] = (subprocess.Popen([nvcc, *flags, "-o", str(so), str(cu)],
                                       stdout=log, stderr=subprocess.STDOUT),
                      so, log)
    libs = {}
    for name, (proc, so, log) in jobs.items():
        rc = proc.wait(timeout=900)
        log.close()
        text = (OUT / f"{name}.log").read_text()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {' | '.join(regs)}", flush=True)
        libs[name] = so
    return libs


def kernel_times(torch, names, launch, flush):
    """{variant: [kernel ms, ...]} from one torch.profiler trace of ROUNDS
    rounds, in turns, of REPS launches of each variant, ``flush`` before
    each launch (the flush's own kernel is not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ROUNDS):
            for name in names:
                for _ in range(REPS):
                    flush()
                    launch(name)
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        m = re.search(r"warp_kernel_(\w+?)[<(]", e.name)
        if e.device_type == DeviceType.CUDA and m:
            times.setdefault(m.group(1), []).append(
                e.time_range.elapsed_us() / 1e3)
    return times


def op_times(torch, fn, flush):
    """[ms, ...] of the device kernels of ROUNDS * REPS calls of ``fn``, each
    after ``flush`` (whose own kernels are told apart by profiling it
    alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(body):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    flush_names = {e.name for e in trace(flush)}

    def body():
        for _ in range(ROUNDS * REPS):
            flush()
            fn()

    return [e.time_range.elapsed_us() / 1e3 for e in trace(body)
            if e.name not in flush_names]


def first_port_wrapper(torch, warp, C, s, axis, width, height):
    """The first port's ``warp_screen`` for CUDA tensors, as it was per call
    (its checks, the module import and the entry's binding on every call,
    the device context entered on every call), launching the same kernel."""
    if C.dim() != 3 or C.shape[0] != C.shape[1] or C.shape[2] != 3 \
            or C.shape[0] < 2:
        raise ValueError("C")
    if s.shape != (warp.N_SCALARS,):
        raise ValueError("s")
    if C.device != s.device:
        raise ValueError("device")
    if C.dtype != torch.float32 or s.dtype != torch.float32:
        raise TypeError("dtype")
    if axis not in (0, 1, 2):
        raise ValueError("axis")
    if C.device.type != "cuda":
        raise RuntimeError("device")
    if not (C.is_contiguous() and s.is_contiguous()):
        raise ValueError("contiguous")
    from mri_raytracer_tpu_torch.ops import kernels

    fn = kernels.function("warp", "mrt_warp", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p])
    out = torch.empty((height, width, 3), dtype=torch.float32, device=C.device)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        err = fn(C.data_ptr(), s.data_ptr(), out.data_ptr(), C.shape[0],
                 height, width, axis, width / max(1.0, float(height)), stream)
    if err != 0:
        raise RuntimeError(f"warp kernel launch failed: cudaError {err}")
    return out


def event_ms(torch, fn, n):
    """Mean ms of ``n`` back-to-back calls of ``fn`` by CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def bind(so):
    fn = ctypes.CDLL(str(so)).mrt_warp
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import POSES
    from mri_raytracer_tpu_torch import env
    from mri_raytracer_tpu_torch.data.brats import percentile_normalize
    from mri_raytracer_tpu_torch.data.synthetic import synthetic_case
    from mri_raytracer_tpu_torch.ops import composite, kernels, shearwarp, warp
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.brats import BratsRenderer
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    names = ["base"] + [n for n in ap.parse_args().variants.split(",")
                        if n != "base"]
    card = f"{torch.cuda.get_device_name(0)} [{env.power_limit()}]"
    t0 = time.perf_counter()
    libs = build(names, env.nvcc_path(), kernels.NVCC_FLAGS)
    print(f"[build] {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    fns = {name: bind(so) for name, so in libs.items()}

    raw, seg = synthetic_case(VOL, seed=0)
    mods = np.stack([percentile_normalize(m) for m in raw])
    p = rp.default_render_params(VOL, show_seg=True, show_pred=False)
    renderer = BratsRenderer(mods, seg.astype(np.int32), None, width=WIDTH,
                             height=WIDTH)
    radius = rp.default_camera_radius(p, VOL)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flushes = {"dirty": flush.bitwise_not_, "clean": lambda: flush.max(),
               "warm": lambda: None}
    med = {}
    for pose, th, ph in POSES:
        fr = renderer.sweep_frame(
            OrbitalCamera(radius=radius, theta=th, phi=ph).basis(), p)
        geom = shearwarp.content_geometry(
            fr.basis, fr.p, tuple(fr.mixed_s.shape), fr.axis, fr.out_res,
            WIDTH, WIDTH, fr.z_offset, fr.nk_global, fr.ab_offset,
            fr.inplane_global)
        k1 = composite.stage1(fr.mixed_s, fr.seg_s, fr.pred_s, geom, fr.p,
                              fr.axis, fr.out_res, fr.z_offset, fr.nk_global)
        C, _ = composite.composite_planes(*k1, fr.use_gamma, fr.use_clip)
        s = shearwarp.warp_scalars(geom, fr.basis, fr.p.bg_color)
        O = C.shape[0]
        out = torch.empty((WIDTH, WIDTH, 3), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def launch(fn):
            err = fn(C.data_ptr(), s.data_ptr(), out.data_ptr(), O, WIDTH,
                     WIDTH, fr.axis, 1.0, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError {err}")

        _, _, valid = warp.screen_maps(s, fr.axis, O, WIDTH, WIDTH)
        plain = warp.warp_screen_plain(C, s, fr.axis, WIDTH, WIDTH)
        errs = {}
        for name in names:
            out.fill_(float("nan"))
            launch(fns[name])
            torch.cuda.synchronize()
            if name == "base":
                ref = out.clone()
                bg_ok = bool((out[~valid] == s[21:24]).all())
                print(f"[ablation] pose {pose}: axis {fr.axis}, O={O}, valid "
                      f"pixels {float(valid.float().mean()):.4f}; base vs "
                      f"plain max abs {float((out - plain).abs().max()):.2e},"
                      f" off-intermediate pixels == bg: {bg_ok}", flush=True)
            errs[name] = float((out - ref).abs().max())
        for mode in MODES:
            times = kernel_times(torch, names, lambda n: launch(fns[n]),
                                 flushes[mode])
            for name in names:
                if not times.get(name):
                    raise RuntimeError(f"no kernel record of {name} ({mode})")
                med[(pose, name, mode)] = statistics.median(times[name])
        fill = [statistics.median(op_times(torch, lambda: out.fill_(0.5),
                                           flushes[m])) for m in MODES]
        print(f"[ablation] pose {pose}: median kernel time of {ROUNDS * REPS}"
              f" launches (ms; x base) dirty / clean / warm L2, on {card}; "
              f"the frame's fill_ alone {fill[0]:.4f} / {fill[1]:.4f} / "
              f"{fill[2]:.4f}", flush=True)
        for name in names:
            cells = " / ".join(
                f"{med[(pose, name, m)]:.4f} "
                f"({med[(pose, name, m)] / med[(pose, 'base', m)]:.3f}x)"
                for m in MODES)
            print(f"[ablation]   {name:13s} {cells}; max|frame - base| "
                  f"{errs[name]:.2e}; {VARIANTS[name][0]}", flush=True)
        if pose == POSES[0][0]:
            args = (C, s, fr.axis, WIDTH, WIDTH)
    poses = [pose for pose, _, _ in POSES]
    print(f"[ablation] over the {len(poses)} poses, time / base's (least, "
          f"geometric mean, most) dirty / clean / warm L2, on {card}",
          flush=True)
    for name in names:
        cells = []
        for m in MODES:
            r = [med[(q, name, m)] / med[(q, "base", m)] for q in poses]
            gm = statistics.geometric_mean(r)
            cells.append(f"{min(r):.3f} {gm:.3f} {max(r):.3f}")
        print(f"[ablation]   {name:13s} " + " / ".join(cells), flush=True)
    # The wrapper's host path, the kernel as it is: back-to-back calls by
    # CUDA events (warm L2), in turns, through warp_screen and through the
    # first port's wrapper code.
    ev = {"warp_screen": [], "the first port's wrapper": []}
    for _ in range(ROUNDS):
        ev["warp_screen"].append(event_ms(
            torch, lambda: warp.warp_screen(*args), 200))
        ev["the first port's wrapper"].append(event_ms(
            torch, lambda: first_port_wrapper(torch, warp, *args), 200))
    print("[ablation] host path at the start pose, back to back by CUDA "
          "events (median of " + str(ROUNDS) + " runs of 200 calls): "
          + "; ".join(f"{k} {statistics.median(v):.4f} ms"
                      for k, v in ev.items()) + f", on {card}", flush=True)
    # Where a call's host time goes: host clock over 2000 calls of each
    # piece of the wrapper (the launch pieces end in one synchronize; where
    # the kernel is the slower side, the launch queue paces them).
    C, s, axis, w, h = args
    out = torch.empty((h, w, 3), device="cuda")
    raw = fns["base"]
    stream = torch.cuda.current_stream().cuda_stream
    pieces = {
        "warp_screen": lambda: warp.warp_screen(*args),
        "the first port's wrapper":
            lambda: first_port_wrapper(torch, warp, *args),
        "torch.empty of the frame": lambda: torch.empty(
            (h, w, 3), dtype=torch.float32, device=C.device),
        "C.new_empty of the frame": lambda: C.new_empty((h, w, 3)),
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "_cuda_getCurrentRawStream":
            lambda: torch._C._cuda_getCurrentRawStream(C.device.index),
        "ctypes launch alone": lambda: raw(
            C.data_ptr(), s.data_ptr(), out.data_ptr(), C.shape[0], h, w,
            axis, 1.0, stream),
        "3 x data_ptr()": lambda: (C.data_ptr(), s.data_ptr(),
                                   out.data_ptr()),
    }
    host = {}
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        torch.cuda.synchronize()
        host[name] = (time.perf_counter() - t0) / 2000 * 1e3
    print("[ablation] host clock per call (mean of 2000): " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in host.items()) + f", on {card}",
        flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
