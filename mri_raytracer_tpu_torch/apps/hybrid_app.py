"""Cooperative hybrid renderer app (port of ``apps/hybrid_app.py``;
reference ``docs/Approach.md:48,172-205``): volumetric primary march of a
BraTS-like case with the tumor's explicit boundary mesh answering batched
BVH shadow queries and seeding the empty-space skip.

    python -m mri_raytracer_tpu_torch.apps.hybrid_app --case CASE_DIR

Runs on the card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="hybrid volume+mesh renderer with mesh shadows "
        "(PyTorch/CUDA)")
    ap.add_argument("--case", default=None,
                    help="BraTS case dir (NIfTI); default = synthetic")
    ap.add_argument("--shape", default="96,96,80",
                    help="synthetic volume shape")
    ap.add_argument("--width", type=int, default=384)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--max-steps", type=int, default=192)
    ap.add_argument("--light", default="1.0,0.6,0.4")
    ap.add_argument("--downsample", type=int, default=1,
                    help="any-pool the occluder mask to cap mesh size")
    ap.add_argument("--no-shadows", action="store_true")
    ap.add_argument("--no-skip", action="store_true",
                    help="disable the mesh-seeded empty-space skip")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default="renders/hybrid")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mri_raytracer_tpu_torch.data import brats, synthetic
    from mri_raytracer_tpu_torch.env import resolve_device
    from mri_raytracer_tpu_torch.io.png import to_rgb8, write_png
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
    from mri_raytracer_tpu_torch.render.hybrid import HybridRenderer
    from mri_raytracer_tpu_torch.utils.profiling import FPSMeter, sync

    dev = resolve_device("cpu" if args.cpu else "cuda")
    if args.case:
        mods, seg = brats.load_case(pathlib.Path(args.case))
    else:
        shape = tuple(int(x) for x in args.shape.split(","))
        mods, seg = synthetic.synthetic_case(shape, seed=0)
    vol = np.stack([brats.percentile_normalize(m) for m in mods]).mean(0)
    mask = np.asarray(seg) > 0

    light = tuple(float(x) for x in args.light.split(","))
    r = HybridRenderer(vol.astype(np.float32), mask, width=args.width,
                       height=args.height, light_dir=light,
                       max_steps=args.max_steps,
                       downsample=args.downsample, device=dev)
    print(f"[app] occluder mesh: {r.n_tris} tris "
          f"(downsample={args.downsample})")

    cam = OrbitalCamera(radius=3.0, theta=math.pi, phi=1.1)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meter = FPSMeter()
    for i in range(args.frames):
        img = r.render(cam.basis(), shadows=not args.no_shadows,
                       mesh_skip=not args.no_skip)
        sync(img)
        meter.tick()
        write_png(out_dir / f"frame_{i:04d}.png", to_rgb8(img.cpu().numpy()))
        cam.orbit(2 * math.pi / args.frames, 0.0)
    print(f"[app] {args.frames} frames -> {out_dir} (fps ~{meter.fps:.1f}, "
          f"{dev})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
