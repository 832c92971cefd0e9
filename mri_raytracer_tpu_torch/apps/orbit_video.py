"""Showcase orbit videos (port of ``scripts/orbit_video.py``; reference
``docs/showcase-plan.md:31-33``: "split-screen baseline vs. ours ...
moving camera"), as animated GIFs through ``io/gif.py``:

  img/roi_orbit_<scene>.gif   split screen: the tuned fixed-step B1 (left)
                              against the policy renderer at its operating
                              point (right), the camera orbiting
  img/brats_orbit.gif         the BraTS renderer's orbit (intensity + GT
                              seg overlay) on the 128^3 synthetic case

    python -m mri_raytracer_tpu_torch.apps.orbit_video --which brats

Operating points come from ``roi_results.json`` and the policy from
``roi_policy.npz`` (with ``roi_policy_meta.json``) in ``--docs`` (default
the repo's ``docs/``, only read); the GIFs go under ``--out`` (default
``build/orbit_video/`` of the checkout). The BraTS frames are stage 1 + K1
+ K2 on the card; the ROI renderers run no kernel of the port. Runs on the
card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "build" / "orbit_video"
BRATS_VOL = (128, 128, 128)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="showcase orbit GIFs "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--res", type=int, default=384)
    ap.add_argument("--frames", type=int, default=72)
    ap.add_argument("--fps", type=int, default=12)
    ap.add_argument("--which", default="all", choices=["all", "roi", "brats"])
    ap.add_argument("--docs", default=str(REPO / "docs"),
                    help="where roi_results.json and roi_policy.npz are "
                    "read")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    return ap


def to_u8(img) -> np.ndarray:
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype("uint8")


def label(frame_u8: np.ndarray, text: str):
    """The frame with a black caption bar and ``text`` (PIL image)."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(frame_u8)
    d = ImageDraw.Draw(im)
    w = im.size[0]
    d.rectangle([0, 0, w, 14], fill=(0, 0, 0))
    d.text((4, 2), text, fill=(255, 255, 255))
    return im


def save_gif(frames, path, fps: int = 12) -> None:
    from mri_raytracer_tpu_torch.io.gif import write_gif

    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    write_gif(path, [np.asarray(f.convert("RGB")) for f in frames],
              int(1000 / fps))
    print(f"[video] wrote {path} ({len(frames)} frames)")


def roi_orbit_gifs(docs, out, res: int, n_frames: int, fps: int,
                   device) -> list:
    """One split-screen GIF a voting scene of ``roi_results.json``'s
    verdicts; returns the paths written."""
    from PIL import Image

    from mri_raytracer_tpu_torch.eval import roi_protocol
    from mri_raytracer_tpu_torch.ops import roi_policy
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera

    docs, out = pathlib.Path(docs), pathlib.Path(out)
    results = json.loads((docs / "roi_results.json").read_text())
    pol = roi_policy.load_policy(docs / "roi_policy.npz", device=device)
    meta = json.loads((docs / "roi_policy_meta.json").read_text())
    n_coarse = int(meta.get("n_coarse", 48))
    # Probe stride scales with the RENDER resolution: the meta value was
    # recorded at the protocol's 1920 px and is wrong for GIF-sized frames.
    stride = roi_protocol.auto_probe_stride(res)
    verdicts = {v["scene"]: v for v in results.get("verdicts", [])}
    written = []
    for sc in roi_protocol.build_scenes((96, 96, 80), device=device):
        v = verdicts.get(sc["name"])
        if v is None or not v.get("counts_toward_bar", True):
            continue
        n_b1 = v["tuned_n"]
        n_pol = v.get("policy_n") or n_b1
        st = roi_protocol.scene_tuple(sc)
        p = sc["params"]
        frames = []
        for i in range(n_frames):
            f = i / n_frames
            th = 2 * np.pi * f
            ph = 0.9 + 0.4 * np.sin(2 * np.pi * f)
            bv = OrbitalCamera(radius=sc["radius"], theta=float(th),
                               phi=float(ph)).basis().pack()
            b1, _ = roi_policy.render_fixed(st[0], bv, p, res, res, n_b1)
            ours, _ = roi_policy.render_policy(pol, *st, bv, p, res, res,
                                               n_coarse, n_pol,
                                               probe_stride=stride)
            left = label(to_u8(b1), f"B1 fixed n={n_b1}")
            right = label(to_u8(ours),
                          f"policy n={n_pol} ({v['speedup']:.2f}x)")
            gap = Image.new("RGB", (4, res), (255, 255, 255))
            canvas = Image.new("RGB", (2 * res + 4, res))
            canvas.paste(left, (0, 0))
            canvas.paste(gap, (res, 0))
            canvas.paste(right, (res + 4, 0))
            frames.append(canvas)
        path = out / "img" / f"roi_orbit_{sc['name']}.gif"
        save_gif(frames, path, fps)
        written.append(path)
    return written


def brats_orbit_frames(res: int, n_frames: int, device,
                       vol=BRATS_VOL) -> list:
    """The BraTS orbit's (res, res, 3) float frames before encoding."""
    from mri_raytracer_tpu_torch.data import brats, synthetic
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.brats import BratsRenderer
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera

    mods, seg = synthetic.synthetic_case(vol, seed=0)
    mods_disp = np.stack([brats.percentile_normalize(m) for m in mods])
    p = rp.default_render_params(vol, show_seg=True, show_pred=False)
    r = BratsRenderer(mods_disp, seg.astype(np.int32), None, width=res,
                      height=res, device=device)
    cam = OrbitalCamera(radius=rp.default_camera_radius(p, vol),
                        theta=0.0, phi=1.1)
    frames = []
    for i in range(n_frames):
        cam.orbit(2 * 3.14159 / n_frames, 0.25 * np.sin(i / 6.0) / 8)
        frames.append(r.render_numpy(cam.basis(), p))
    return frames


def brats_orbit_gif(out, res: int, n_frames: int, fps: int, device):
    frames = [label(to_u8(f), "mri_raytracer_tpu orbit")
              for f in brats_orbit_frames(res, n_frames, device)]
    path = pathlib.Path(out) / "img" / "brats_orbit.gif"
    save_gif(frames, path, fps)
    return path


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from mri_raytracer_tpu_torch.env import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    with torch.no_grad():
        if args.which in ("all", "roi"):
            roi_orbit_gifs(args.docs, args.out, args.res, args.frames,
                           args.fps, dev)
        if args.which in ("all", "brats"):
            brats_orbit_gif(args.out, args.res, args.frames, args.fps, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
