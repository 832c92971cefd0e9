"""Mesh ray-tracing app (port of ``apps/mesh_app.py``; reference H3,
``scripts/mesh_rt/app.py``): PLY -> unit-box normalize -> BVH/brute trace
-> shaded orbit frames.

    python -m mri_raytracer_tpu_torch.apps.mesh_app --ply mesh.ply

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys

import numpy as np

# Built-in demo: an octahedron (double pyramid), 8 triangles.
DEMO_VERTS = np.array([[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0],
                       [0, 0, 1], [0, 0, -1]], np.float32)
DEMO_TRIS = np.array([[0, 2, 4], [0, 4, 3], [0, 3, 5], [0, 5, 2],
                      [1, 4, 2], [1, 3, 4], [1, 5, 3], [1, 2, 5]], np.uint32)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="triangle-mesh ray tracer "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--ply", help="ASCII PLY mesh path")
    ap.add_argument("--max-faces", type=int, default=None)
    ap.add_argument("--mode", default="auto", choices=["auto", "brute", "bvh"])
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--fov", type=float, default=55.0)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default="renders/mesh")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the same "
                    "PyTorch code on the host)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mri_raytracer_tpu_torch.env import resolve_device
    from mri_raytracer_tpu_torch.io.png import to_rgb8, write_png
    from mri_raytracer_tpu_torch.render import mesh
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
    from mri_raytracer_tpu_torch.utils.profiling import FPSMeter, sync

    dev = resolve_device(args.device)
    if args.ply:
        verts, tris = mesh.load_ply_ascii(args.ply, max_faces=args.max_faces)
    else:
        verts, tris = DEMO_VERTS, DEMO_TRIS
    print(f"[app] mesh: {len(verts)} verts, {len(tris)} tris")
    r = mesh.MeshRenderer(verts, tris, width=args.width, height=args.height,
                          mode=args.mode, device=dev)
    cam = OrbitalCamera(radius=3.0, fov_y=math.radians(args.fov))
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meter = FPSMeter()
    for i in range(args.frames):
        img = r.render(cam.basis())
        sync(img)
        meter.tick()
        write_png(out_dir / f"frame_{i:04d}.png", to_rgb8(img.cpu().numpy()))
        cam.orbit(2 * math.pi / args.frames, 0.0)
    print(f"[app] {args.frames} frames -> {out_dir} (fps ~{meter.fps:.1f}, "
          f"tracer={r.mode}, {dev})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
