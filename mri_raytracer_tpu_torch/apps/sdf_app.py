"""SDF sphere-tracer app (port of ``apps/sdf_app.py``; reference H6,
``scripts/raymarch/app.py``): slider-equivalents as flags (maxSteps /
maxDistance / hitThreshold / normalEps).

    python -m mri_raytracer_tpu_torch.apps.sdf_app --frames 12

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="analytic SDF sphere tracer "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--max-steps", type=int, default=96)
    ap.add_argument("--max-distance", type=float, default=20.0)
    ap.add_argument("--hit-threshold", type=float, default=1e-3)
    ap.add_argument("--normal-eps", type=float, default=1e-3)
    ap.add_argument("--fov", type=float, default=55.0)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default="renders/sdf")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the same "
                    "PyTorch code on the host)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mri_raytracer_tpu_torch.env import resolve_device
    from mri_raytracer_tpu_torch.io.png import to_rgb8, write_png
    from mri_raytracer_tpu_torch.ops import sdf
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
    from mri_raytracer_tpu_torch.utils.profiling import FPSMeter, sync

    dev = resolve_device(args.device)
    p = sdf.default_sdf_params(args.max_steps, args.max_distance,
                               args.hit_threshold, args.normal_eps)
    cam = OrbitalCamera(radius=2.5, fov_y=math.radians(args.fov))
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meter = FPSMeter()
    for i in range(args.frames):
        img = sdf.render_sdf(cam.basis(), p, args.width, args.height,
                             max_steps=args.max_steps, device=dev)
        sync(img)
        meter.tick()
        write_png(out_dir / f"frame_{i:04d}.png", to_rgb8(img.cpu().numpy()))
        cam.orbit(2 * math.pi / args.frames, 0.0)
    print(f"[app] {args.frames} frames -> {out_dir} (fps ~{meter.fps:.1f}, "
          f"{dev})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
