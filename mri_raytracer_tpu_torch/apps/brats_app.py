"""BraTS viewer app (reference H1, ``inr/viewer/brats_viewer.py``) as a
headless CLI (port of ``apps/brats_app.py``): orbit-frame rendering with
every interactive control exposed as a flag, INR checkpoint loading ('Load
INR & Predict'), and an FPS meter. The deliverable is frames (PNGs, an
optional MP4) plus timing.

    python -m mri_raytracer_tpu_torch.apps.brats_app --synthetic --frames 8

Runs on the card (``--device cuda``, the default; backend 'auto' is then
'sweep_cuda', kernels K1 and K2) unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="BraTS multi-modal volume "
                                 "viewer (PyTorch/CUDA)")
    ap.add_argument("--case-dir", help="BraTS case directory (modality NIfTIs)")
    ap.add_argument("--synthetic", action="store_true",
                    help="render a synthetic case (no data needed)")
    ap.add_argument("--synthetic-shape", default="128,128,112")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--out", default="renders/brats")
    ap.add_argument("--mp4", action="store_true",
                    help="also write orbit.mp4 (needs imageio)")
    # Reference UI sliders -> flags (brats_viewer.py:163-176)
    ap.add_argument("--fov", type=float, default=55.0)
    ap.add_argument("--near", type=float, default=0.0)
    ap.add_argument("--far", type=float, default=0.0)
    ap.add_argument("--step", type=float, default=0.05)
    ap.add_argument("--alpha", type=float, default=None,
                    help="intensity alpha (default 0.4)")
    ap.add_argument("--ww", type=float, default=None)
    ap.add_argument("--wl", type=float, default=None)
    ap.add_argument("--gamma", type=float, default=None)
    ap.add_argument("--preset", default=None,
                    help="named transfer-function preset "
                    "(render/presets.py); explicit ww/wl/alpha/gamma "
                    "flags override the preset's values, matching the "
                    "HTTP /frame endpoint's precedence")
    ap.add_argument("--modalities", default="1,1,1,1",
                    help="enable flags for t1n,t1c,t2w,t2f")
    ap.add_argument("--weights", default="1,1,1,1")
    ap.add_argument("--show-seg", action="store_true", default=True)
    ap.add_argument("--no-seg", dest="show_seg", action="store_false")
    ap.add_argument("--inr-checkpoint", help="npz checkpoint; bakes a "
                    "prediction volume and overlays it (mode 1)")
    ap.add_argument("--neural-march", action="store_true",
                    help="evaluate the INR inside the march (mode 2, the "
                    "plain scan); needs --inr-checkpoint")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "sweep", "sweep_cuda", "oracle"])
    ap.add_argument("--theta0", type=float, default=0.6)
    ap.add_argument("--phi0", type=float, default=1.2)
    ap.add_argument("--d-theta", type=float, default=None,
                    help="orbit step per frame (default: full turn)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "PyTorch versions of the kernels)")
    return ap


def load_inr(checkpoint, device):
    """(model, params on ``device``) from a checkpoint and its sidecar."""
    from mri_raytracer_tpu_torch import convert
    from mri_raytracer_tpu_torch.config import ModelConfig
    from mri_raytracer_tpu_torch.io import checkpoint as ckpt

    tree, info = ckpt.model_load(checkpoint)
    return convert.inr_params_from_numpy(tree, ModelConfig.from_info(info),
                                         device=device)


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.neural_march and not args.inr_checkpoint:
        ap.error("--neural-march needs --inr-checkpoint")
    if args.mp4:
        try:
            import imageio.v3 as iio
        except ImportError:
            raise RuntimeError("--mp4 needs the imageio package, which is "
                               "not installed") from None
    import torch

    from mri_raytracer_tpu_torch.data import brats, synthetic
    from mri_raytracer_tpu_torch.env import resolve_device
    from mri_raytracer_tpu_torch.io.png import to_rgb8, write_png
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.brats import BratsRenderer
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
    from mri_raytracer_tpu_torch.utils.profiling import FPSMeter, sync

    dev = resolve_device(args.device)

    # ------------------------------------------------------------- data
    if args.synthetic or not args.case_dir:
        shape = tuple(int(x) for x in args.synthetic_shape.split(","))
        mods_raw, seg = synthetic.synthetic_case(shape, seed=0)
    else:
        mods_raw, seg = brats.load_case(pathlib.Path(args.case_dir),
                                        normalization="none")
    mods_disp = np.stack([brats.percentile_normalize(m) for m in mods_raw])
    shape = mods_disp.shape[1:]

    pred = None
    model = params = mods_z = None
    if args.inr_checkpoint:
        from mri_raytracer_tpu_torch.eval.inference import predict_volume

        model, params = load_inr(args.inr_checkpoint, dev)
        # Re-apply TRAINING normalization before inference, exactly like the
        # viewer's Load-INR path (brats_viewer.py:278-289).
        mods_z = np.stack([brats.zscore_nonzero(m.copy()) for m in mods_raw])
        if not args.neural_march:
            pred, _ = predict_volume(model, params,
                                     {"mods": mods_z, "seg": seg},
                                     device=dev)
            print(f"[app] baked INR prediction: classes "
                  f"{np.bincount(pred.reshape(-1), minlength=4)}")

    # ------------------------------------------------------------ params
    enabled = [float(x) for x in args.modalities.split(",")]
    weights = [float(x) for x in args.weights.split(",")]
    p = rp.default_render_params(
        shape, step_size=args.step, show_seg=args.show_seg,
        show_pred=pred is not None or args.neural_march,
        vol_enabled=enabled, vol_weight=weights, near=args.near,
        far=args.far)
    if args.preset:
        from mri_raytracer_tpu_torch.render.presets import apply_preset

        p = apply_preset(p, args.preset)
    # Explicit flags override the preset (same precedence as /frame).
    overrides = {k: torch.tensor(v, dtype=torch.float32) for k, v in
                 (("ww", args.ww), ("wl", args.wl),
                  ("intensity_alpha", args.alpha),
                  ("gamma", args.gamma)) if v is not None}
    if overrides:
        p = p._replace(**overrides)
    cam = OrbitalCamera(radius=rp.default_camera_radius(p, shape),
                        theta=args.theta0, phi=args.phi0,
                        fov_y=math.radians(args.fov))

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    d_theta = args.d_theta if args.d_theta is not None else \
        2 * math.pi / max(args.frames, 1)

    meter = FPSMeter()
    frames = []
    seg_i32 = seg.astype(np.int32) if args.show_seg else None
    if args.neural_march:
        from mri_raytracer_tpu_torch.ops.neural_march import \
            render_brats_neural

        for _ in range(args.frames):
            img = render_brats_neural(mods_disp, mods_z, seg_i32, model,
                                      params, cam.basis(), p, args.width,
                                      args.height, device=dev)
            sync(img)
            meter.tick()
            frames.append(img.cpu().numpy())
            cam.orbit(d_theta, 0.0)
    else:
        renderer = BratsRenderer(
            mods_disp, seg_i32,
            None if pred is None else pred.astype(np.int32),
            width=args.width, height=args.height, backend=args.backend,
            device=dev)
        renderer.warmup(p)
        for _ in range(args.frames):
            img = renderer.render(cam.basis(), p)
            sync(img)
            meter.tick()
            frames.append(img.cpu().numpy())
            cam.orbit(d_theta, 0.0)

    for i, f in enumerate(frames):
        write_png(out_dir / f"frame_{i:04d}.png", to_rgb8(f))
    if args.mp4:
        iio.imwrite(out_dir / "orbit.mp4", [to_rgb8(f) for f in frames],
                    fps=24)
    print(f"[app] {len(frames)} frames -> {out_dir}  (fps ~{meter.fps:.1f}, "
          f"{dev})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
