"""The ROI policy renderer's per-frame overhead against the fixed-step
baseline at protocol scale, 1920 x 1080 (port of
``scripts/bench_roi_overhead.py``).

    python -m mri_raytracer_tpu_torch.apps.bench_roi_overhead

Rows, per budget n: ``fixed@n`` (``render_fixed``), ``policy@n``
(``render_policy`` with an initial policy), and their difference. Each
time is the middle of three batches of ``--frames`` back-to-back frames,
one sync a batch (``utils/profiling.median_time``, as
``eval/roi_protocol.pareto_sweep``).
Runs on the card unless ``--cpu`` is given; no kernel of the port.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="ROI policy overhead at 1080p "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--shape", default="96,96,80")
    ap.add_argument("--budgets", default="32,48,64")
    ap.add_argument("--n-coarse", type=int, default=48)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    return ap


def timed_ms(fn, frames: int) -> float:
    """The middle of three batches' ms a frame (after a synced warm
    call)."""
    from mri_raytracer_tpu_torch.utils.profiling import median_time

    return 1e3 * median_time(fn, frames, 3)


def overhead_rows(sc, pol, bv, W: int, H: int, budgets, n_coarse: int,
                  block: int, stride: int, frames: int) -> list:
    """[(n, fixed ms, policy ms)] on scene ``sc`` at pose ``bv``."""
    from mri_raytracer_tpu_torch.eval import roi_protocol
    from mri_raytracer_tpu_torch.ops import roi_policy

    p = sc["params"]
    mixed, rows = roi_protocol.scene_tuple(sc)
    out = []
    for n in budgets:
        ms_fix = timed_ms(lambda: roi_policy.render_fixed(
            mixed, bv, p, W, H, n, block=block)[0], frames)
        ms_pol = timed_ms(lambda: roi_policy.render_policy(
            pol, mixed, rows, bv, p, W, H, n_coarse, n,
            probe_stride=stride, block=block)[0], frames)
        out.append((n, ms_fix, ms_pol))
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from mri_raytracer_tpu_torch.env import resolve_device
    from mri_raytracer_tpu_torch.eval import roi_protocol
    from mri_raytracer_tpu_torch.ops import roi_policy

    dev = resolve_device("cpu" if args.cpu else "cuda")
    shape = tuple(int(x) for x in args.shape.split(","))
    budgets = [int(x) for x in args.budgets.split(",")]
    stride = roi_protocol.auto_probe_stride(args.width)
    sc = roi_protocol.build_scenes(shape, suite="showcase",
                                   device=dev)[0]  # tumor-a
    pol = roi_policy.init_policy(torch.Generator().manual_seed(0),
                                 device=dev)
    bv = torch.as_tensor(roi_protocol.make_orbit_views(sc["radius"], 30)[7],
                         device=dev)
    W, H = args.width, args.height
    print(f"[ovh] {W}x{H} vol={shape} stride={stride} n_coarse="
          f"{args.n_coarse} block={args.block} device={dev}")
    with torch.no_grad():
        for n, ms_fix, ms_pol in overhead_rows(
                sc, pol, bv, W, H, budgets, args.n_coarse, args.block,
                stride, args.frames):
            print(f"[ovh] n={n:3d}  fixed {ms_fix:7.2f} ms   "
                  f"policy {ms_pol:7.2f} ms   overhead "
                  f"{ms_pol - ms_fix:+6.2f} ms "
                  f"({100 * (ms_pol / ms_fix - 1):+.1f}%)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
