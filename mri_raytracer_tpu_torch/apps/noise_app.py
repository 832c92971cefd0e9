"""2-D simplex-noise demo app (port of ``apps/noise_app.py``; reference H7,
``scripts/slang_test/test.py`` hosting ``draw.slang``) — the environment
smoke test: animate the noise demo, write PNG frames (the reference's F2
screenshot path, ``test.py:59-76``), optionally a GIF (``io/gif.py``).
Pointer interaction is a ``--mouse x,y`` flag (the offline analog of the
mouse-move callback).

    python -m mri_raytracer_tpu_torch.apps.noise_app --frames 12 --gif

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="2-D simplex-noise demo "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--noise-scale", type=float, default=4.0)
    ap.add_argument("--noise-amount", type=float, default=0.08)
    ap.add_argument("--mouse", default=None,
                    help="'x,y' pixel position of the red pointer highlight")
    ap.add_argument("--mouse-radius", type=float, default=64.0)
    ap.add_argument("--gif", action="store_true",
                    help="also write demo.gif next to the frames")
    ap.add_argument("--out", default="renders/noise2d")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the same "
                    "PyTorch code on the host)")
    return ap


def srgb8(img: np.ndarray) -> np.ndarray:
    """A linear frame -> sRGB uint8, like the reference's F2 path
    (``test.py:70-75`` converts with srgb_gamma=True): clipped to [0, 1],
    encoded, times 255, truncated."""
    arr = np.clip(img, 0.0, 1.0)
    srgb = np.where(arr <= 0.0031308, arr * 12.92,
                    1.055 * np.power(arr, 1.0 / 2.4) - 0.055)
    return (srgb * 255).astype(np.uint8)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mri_raytracer_tpu_torch.env import resolve_device
    from mri_raytracer_tpu_torch.io.gif import write_gif
    from mri_raytracer_tpu_torch.io.png import write_png
    from mri_raytracer_tpu_torch.ops.noise2d import render_noise_demo

    dev = resolve_device(args.device)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    mouse = None
    if args.mouse:
        mouse = [float(v) for v in args.mouse.split(",")]
    frames = []
    for i in range(args.frames):
        img = render_noise_demo(args.width, args.height,
                                time=i / args.fps, mouse_pos=mouse,
                                mouse_radius=args.mouse_radius,
                                noise_scale=args.noise_scale,
                                noise_amount=args.noise_amount, device=dev)
        u8 = srgb8(img.cpu().numpy())
        write_png(out / f"frame_{i:04d}.png", u8)
        frames.append(u8)
    if args.gif:
        write_gif(out / "demo.gif", frames, int(1000 / args.fps))
    print(f"[noise2d] {args.frames} frames -> {out} ({dev})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
