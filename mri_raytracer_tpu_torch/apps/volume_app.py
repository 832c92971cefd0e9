"""u8 grid volume renderer app (port of ``apps/volume_app.py``; reference
H2, ``scripts/volumeRendering/app.py``): r8/bc4/NIfTI sources,
occupancy/labels modes, composite/MIP/iso rendering, auto-rotate orbit,
step-count control.

    python -m mri_raytracer_tpu_torch.apps.volume_app --synthetic --frames 12

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="u8 grid volume renderer "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--volume", help="raw u8/.gz, BC4, or NIfTI volume")
    ap.add_argument("--format", default="r8", choices=["r8", "bc4"])
    ap.add_argument("--dims", help="X,Y,Z for raw formats (reference demo: "
                    "180,216,180)")
    ap.add_argument("--nii", help="NIfTI volume (alternative source)")
    ap.add_argument("--mode", default="occupancy", choices=["occupancy", "labels"])
    ap.add_argument("--render-mode", default="composite",
                    choices=["composite", "mip", "iso"],
                    help="composite (reference accumulation), mip "
                    "(maximum-intensity projection), or iso "
                    "(Phong-shaded iso-surface)")
    ap.add_argument("--iso", type=float, default=0.25,
                    help="iso mode: surface threshold in [0, 1]")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--steps", type=float, default=64.0,
                    help="march steps (reference slider 16-512)")
    ap.add_argument("--fov", type=float, default=72.0)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default="renders/volume")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the same "
                    "PyTorch code on the host)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mri_raytracer_tpu_torch.data import synthetic
    from mri_raytracer_tpu_torch.env import resolve_device
    from mri_raytracer_tpu_torch.io.png import to_rgb8, write_png
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
    from mri_raytracer_tpu_torch.render.volume import (GridVolumeRenderer,
                                                       load_volume)
    from mri_raytracer_tpu_torch.utils.profiling import FPSMeter, sync

    dev = resolve_device(args.device)
    if args.synthetic or not (args.volume or args.nii):
        vol = synthetic.synthetic_u8_volume((96, 96, 96), seed=0)
    elif args.nii:
        vol = load_volume(args.nii, mode=args.mode)
    else:
        dims = tuple(int(x) for x in args.dims.split(",")) if args.dims else None
        vol = load_volume(args.volume, fmt=args.format, dims=dims, mode=args.mode)

    r = GridVolumeRenderer(vol, width=args.width, height=args.height,
                           device=dev)
    cam = OrbitalCamera(radius=3.0, fov_y=math.radians(args.fov))
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meter = FPSMeter()
    for i in range(args.frames):
        img = r.render(cam.basis(), step_count=args.steps,
                       mode=args.render_mode, iso=args.iso)
        sync(img)
        meter.tick()
        write_png(out_dir / f"frame_{i:04d}.png", to_rgb8(img.cpu().numpy()))
        cam.orbit(2 * math.pi / args.frames, 0.0)  # auto-rotate
    print(f"[app] {args.frames} frames -> {out_dir} (fps ~{meter.fps:.1f}, "
          f"{dev})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
