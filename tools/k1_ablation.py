#!/usr/bin/env python3
"""K1 (``mri_raytracer_tpu_torch/csrc/composite.cu``) against variants of
itself on one NVIDIA card: which part of the tiled design buys what, and
which of its constants hold it back.

    python3 tools/k1_ablation.py [--variants no_cull,no_exit,...]

Each variant is the kernel's source with one edit (``VARIANTS`` below),
built by ``nvcc`` with the port's flags into ``build/k1_ablation/``,
launched through the same C entry (``mrt_composite``) on the same stage-1
inputs as the unedited kernel ('base'): the 1024^2 bench frame of
``chip_smoke.py`` (256^3 synthetic case, seed 0, seg overlay) at its start
pose and at its heaviest accounting pose, and at the start pose also with a
stride-4 field of random labels (K1b). Every variant's C and T are held
against base's (max abs error printed; the ablations change no pixel's
arithmetic). Times are CUDA events around single launches, each after a
256 MB buffer is overwritten (a cold L2; the flush is outside the events),
in turns over all variants, ROUNDS rounds; the median is printed with the
card's name and power limit. Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "mri_raytracer_tpu_torch" / "csrc" / "composite.cu"
OUT = ROOT / "build" / "k1_ablation"
ROUNDS, REPS = 5, 4
VOL, WIDTH = (256, 256, 256), 1024
# Frames into chip_smoke.py's timed orbit of its heaviest accounting pose.
HEAVY_K, WARMUP = 23, 15
# Label shares of chip_smoke.py's INR field at the neural start pose
# (ModelConfig(), seed 0, nudged last bias), for K1b's field here.
FIELD_SHARES = (0.1333, 0.2268, 0.2275, 0.4123)

# name: (what it tests, [(old text, new text), ...]); each old text must
# occur exactly once in the source.
VARIANTS = {
    "base": ("the kernel as it is", []),
    "no_cull": ("every plane in the run list (no per-tile culling)",
                [("    s_run[m] = ok;", "    s_run[m] = 1;")]),
    "no_exit": ("no tile-wide exit (pixels still skip at T <= 0.01)",
                [("if (!__syncthreads_or(alive)) break;",
                  "(void)__syncthreads_or(alive);")]),
    "no_stage": ("no shared-memory staging: every plane loads directly",
                 [("const bool rows_staged =\n      (O & 15) == 0",
                   "const bool rows_staged = false &&\n      (O & 15) == 0")]),
    "lb3": ("__launch_bounds__(256, 3): at most 85 registers a thread",
            [("void __launch_bounds__(kThreads, 2) composite_kernel",
              "void __launch_bounds__(kThreads, 3) composite_kernel")]),
    "stages2": ("a 2-stage ring", [("constexpr int kStages = 4;",
                                   "constexpr int kStages = 2;")]),
    "stages6": ("a 6-stage ring", [("constexpr int kStages = 4;",
                                   "constexpr int kStages = 6;")]),
    "rows_select": ("the seg overlay straight-line with selects, as the "
                    "field's", [("overlay(lab_seg, 1.f, show_seg, "
                                "std::false_type{})",
                                "overlay(lab_seg, 1.f, show_seg, "
                                "std::true_type{})")]),
    "field_branch": ("the field overlay behind each pixel's label test, as "
                     "the rows'", [("overlay(lab_pred, 1.5f, show_pred, "
                                    "std::true_type{})",
                                    "overlay(lab_pred, 1.5f, show_pred, "
                                    "std::false_type{})")]),
    "tile8": ("8 x 64 tiles, 2 pixels a thread, 4 blocks per SM",
              [("constexpr int kTileI = 16;", "constexpr int kTileI = 8;"),
               ("constexpr int kWinRows = kTileI + 2;",
                "constexpr int kWinRows = 18;"),
               ("void __launch_bounds__(kThreads, 2) composite_kernel",
                "void __launch_bounds__(kThreads, 4) composite_kernel")]),
    "tile8_lb3": ("8 x 64 tiles, 2 pixels a thread, 3 blocks per SM",
                  [("constexpr int kTileI = 16;", "constexpr int kTileI = 8;"),
                   ("constexpr int kWinRows = kTileI + 2;",
                    "constexpr int kWinRows = 18;"),
                   ("void __launch_bounds__(kThreads, 2) composite_kernel",
                    "void __launch_bounds__(kThreads, 3) composite_kernel")]),
    "tile32": ("32 x 64 tiles of 512 threads, 4 pixels a thread, 1 block "
               "per SM (over 48 KB of shared memory)",
               [("constexpr int kTileI = 16;", "constexpr int kTileI = 32;"),
                ("constexpr int kThreads = 256;",
                 "constexpr int kThreads = 512;"),
                ("void __launch_bounds__(kThreads, 2) composite_kernel",
                 "void __launch_bounds__(kThreads, 1) composite_kernel")]),
}


def build(names, nvcc, flags):
    """Compile every variant at once; returns {name: library path}."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    jobs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][1]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} occurs "
                                   f"{text.count(old)} times")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
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


def bind(so):
    fn = ctypes.CDLL(str(so)).mrt_composite
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mri_raytracer_tpu_torch import env
    from mri_raytracer_tpu_torch.data.brats import percentile_normalize
    from mri_raytracer_tpu_torch.data.synthetic import synthetic_case
    from mri_raytracer_tpu_torch.ops import composite, kernels, shearwarp
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
    p = rp.default_render_params(VOL, show_seg=True, show_pred=True)
    renderer = BratsRenderer(mods, seg.astype(np.int32), None, width=WIDTH,
                             height=WIDTH)
    radius = rp.default_camera_radius(p, VOL)
    poses = {"start": (0.6, 1.2),
             f"heavy k={HEAVY_K}": (0.6 + 0.03 * (WARMUP + HEAVY_K),
                                    1.2 + 0.01 * HEAVY_K)}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for pose, (th, ph) in poses.items():
        fr = renderer.sweep_frame(
            OrbitalCamera(radius=radius, theta=th, phi=ph).basis(), p)
        geom = shearwarp.content_geometry(
            fr.basis, fr.p, tuple(fr.mixed_s.shape), fr.axis, fr.out_res,
            WIDTH, WIDTH, fr.z_offset, fr.nk_global, fr.ab_offset,
            fr.inplane_global)
        k1 = composite.stage1(fr.mixed_s, fr.seg_s, fr.pred_s, geom, fr.p,
                              fr.axis, fr.out_res, fr.z_offset, fr.nk_global)
        K, Na, O = k1.t1b.shape
        lut8 = shearwarp._label_table(k1.lut).float().contiguous()
        C = torch.empty((O, O, 3), device="cuda")
        T = torch.empty((O, O), device="cuda")
        planes = torch.empty((O, O), dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        seg_ptr = k1.seg_rows.data_ptr()
        # K1b at the start pose: the seg rows and a stride-4 field of
        # labels drawn with FIELD_SHARES (seed 0).
        S = 4
        field = torch.multinomial(
            torch.tensor(FIELD_SHARES, device="cuda"), K * (O // S) ** 2,
            replacement=True,
            generator=torch.Generator(device="cuda").manual_seed(0)
        ).to(torch.uint8).reshape(K, O // S, O // S)

        def launch(fn, mode):
            err = fn(k1.t1b.data_ptr(), seg_ptr, None,
                     field.data_ptr() if mode == "field" else None,
                     k1.pp.data_ptr(), k1.scalars.data_ptr(), lut8.data_ptr(),
                     k1.vmag.data_ptr(), k1.dt_map.data_ptr(),
                     k1.r_map.data_ptr(), C.data_ptr(), T.data_ptr(),
                     planes.data_ptr() if mode == "counter" else None, K, Na,
                     O, S, 1, O // S, int(fr.use_gamma), int(fr.use_clip),
                     stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError {err}")

        runs = [(n, "rows") for n in names] + [("base", "counter")]
        if pose == "start":
            runs += [(n, "field") for n in names]
        ref, errs = {}, {}
        for name, mode in runs:
            launch(fns[name], mode)
            torch.cuda.synchronize()
            key = "field" if mode == "field" else "rows"
            if name == "base" and key not in ref:
                ref[key] = (C.clone(), T.clone())
            errs[(name, mode)] = max(float((C - ref[key][0]).abs().max()),
                                     float((T - ref[key][1]).abs().max()))
        times = {r: [] for r in runs}
        for _ in range(ROUNDS):
            for name, mode in runs:
                for _ in range(REPS):
                    flush.bitwise_not_()
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    launch(fns[name], mode)
                    b.record()
                    b.synchronize()
                    times[(name, mode)].append(a.elapsed_time(b))
        print(f"[ablation] pose {pose}: axis {fr.axis}, K={K}, Na={Na}, "
              f"O={O}, on {card}", flush=True)
        for name, mode in runs:
            ms = statistics.median(times[(name, mode)])
            base_ms = statistics.median(
                times[("base", "field" if mode == "field" else "rows")])
            label = {"rows": name, "counter": "base + counter (K1c)",
                     "field": f"{name} + field (K1b)"}[mode]
            print(f"[ablation]   {label:30s} {ms:.4f} ms median of "
                  f"{ROUNDS * REPS} cold-L2 launches ({ms / base_ms:.3f}x "
                  f"base), max|C, T - base| {errs[(name, mode)]:.2e}; "
                  f"{VARIANTS[name][0] if mode == 'rows' else ''}",
                  flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
