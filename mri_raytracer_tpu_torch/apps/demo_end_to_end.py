"""End-to-end demo (port of ``scripts/demo_end_to_end.py``): synthetic
BraTS-like dataset -> INR training -> full-volume inference (Dice) -> bake
the prediction -> sweep render with GT + pred overlays -> PSNR against the
oracle -> orbit fps.

    python -m mri_raytracer_tpu_torch.apps.demo_end_to_end

Writes ``RESULTS_r1.md`` and ``renders/inr_overlay_{sweep,oracle}.png``
under ``--out`` (default ``build/demo_end_to_end/`` of the checkout), with
the dataset and the training run beside them. The sizes are the JAX
script's constants, the defaults of ``run_demo``. The renderer is
``backend="sweep"``, as in the JAX script: the plain scan, whose warp on
the card is K2; its fps is the scan's, and the backend is printed beside
it. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

DEFAULT_OUT = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "demo_end_to_end"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="train -> bake -> render demo "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default="cuda")
    return ap


def _png(path: pathlib.Path, img: np.ndarray) -> None:
    from mri_raytracer_tpu_torch.io.png import to_rgb8, write_png

    write_png(path, to_rgb8(img))


def run_demo(out, device, num_cases: int = 6, shape=(96, 96, 80),
             steps: int = 400, hidden=(64, 64, 64, 64),
             global_batch: int = 16384, micro_batch: int = 8192,
             size: int = 1024, oracle_steps: int = 2048,
             fps_frames: int = 20) -> dict:
    """The demo at the JAX script's constants (the defaults); returns its
    record and writes the markdown and the two PNGs under ``out``."""
    import torch

    from mri_raytracer_tpu_torch import env
    from mri_raytracer_tpu_torch.config import TrainConfig
    from mri_raytracer_tpu_torch.data import brats, synthetic
    from mri_raytracer_tpu_torch.eval import metrics
    from mri_raytracer_tpu_torch.eval.inference import predict_volume
    from mri_raytracer_tpu_torch.ops import raymarch
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.brats import BratsRenderer
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
    from mri_raytracer_tpu_torch.train.engine import train_inr
    from mri_raytracer_tpu_torch.utils.profiling import sync

    out = pathlib.Path(out)
    render_dir = out / "renders"
    render_dir.mkdir(parents=True, exist_ok=True)
    where = (f"{torch.cuda.get_device_name(device)}, "
             f"{env.power_limit() or 'power limit not read'}"
             if device.type == "cuda" else "cpu")
    lines = [f"# Round-1 end-to-end results ({device.type}, {where})", ""]

    # ------------------------------------------------------------- dataset
    data_root = out / "data"
    if not data_root.exists():
        synthetic.write_synthetic_dataset(data_root, num_cases=num_cases,
                                          shape=shape, seed=11)
    # ------------------------------------------------------------ training
    cfg = TrainConfig()
    cfg.data.data_root = str(data_root)
    cfg.data.case_limit = num_cases
    cfg.data.num_folds = 3
    cfg.data.pool_size = 4
    cfg.data.pool_refresh = 0
    cfg.data.sampler = "tumor"
    cfg.model.hidden_dims = tuple(hidden)
    cfg.model.fourier_freqs = 6
    cfg.train_steps = steps
    cfg.global_batch = global_batch
    cfg.micro_batch = micro_batch
    cfg.checkpoint_every = 0
    cfg.log_every = 100
    cfg.out_dir = str(out / "run")
    t0 = time.time()
    state = train_inr(cfg, device=device)
    t_train = time.time() - t0
    ev = state["eval"]
    lines += [f"## INR training (synthetic {'x'.join(map(str, shape))}, 4 "
              f"modalities, {state['train_cache'].n_cases} cases train / "
              f"{state['val_cache'].n_cases} val)", "",
              f"- {cfg.train_steps} steps, global batch {cfg.global_batch}, "
              f"tumor-biased sampler: **{t_train:.1f} s** "
              f"({cfg.train_steps * cfg.global_batch / t_train / 1e6:.2f} M "
              "voxels/s)",
              f"- final loss {state['history'][-1]['loss']:.4f}", ""]
    for k in ("dice_class_1", "dice_class_2", "dice_class_3",
              "coverage_dice", "mean_dice"):
        m, s = ev[k]
        lines.append(f"- val {k}: {m:.3f} +/- {s:.3f}")
    lines.append("")

    # --------------------------------------------------- bake + full render
    case = state["val_cache"].get(0)
    with torch.no_grad():
        pred_vol, _ = predict_volume(state["model"], state["params"], case,
                                     device=device)
    # Display normalization for rendering: the cache holds z-scored mods;
    # percentile-normalize them for the viewer contract.
    mods_disp = np.stack([brats.percentile_normalize(m)
                          for m in case["mods"]])
    seg = case["seg"].astype(np.int32)
    pred = pred_vol.astype(np.int32)
    vol = mods_disp.shape[1:]
    p = rp.default_render_params(vol, show_seg=True, show_pred=True,
                                 step_size=1.8 / max(vol))
    cam = OrbitalCamera(radius=rp.default_camera_radius(p, vol),
                        theta=0.7, phi=1.15)
    renderer = BratsRenderer(mods_disp, seg, pred, width=size, height=size,
                             backend="sweep", device=device)
    with torch.no_grad():
        renderer.warmup(p)
        img_sweep = renderer.render_numpy(cam.basis(), p)
        _png(render_dir / "inr_overlay_sweep.png", img_sweep)
        # Quality against the oracle at full scale.
        img_oracle = raymarch.render_brats(
            mods_disp, seg, pred, cam.basis(), p, size, size,
            max_steps=oracle_steps, device=device).cpu().numpy()
        ps = metrics.psnr(img_sweep, img_oracle)
        _png(render_dir / "inr_overlay_oracle.png", img_oracle)

        # fps over an orbit (prediction + seg overlays on)
        for _ in range(3):
            sync(renderer.render(cam.basis(), p))
        t0 = time.time()
        for _ in range(fps_frames):
            cam.orbit(0.05, 0.01)
            img = renderer.render(cam.basis(), p)
        sync(img)
        fps = fps_frames / (time.time() - t0)

    lines += [f"## Rendering ({size}x{size}, GT seg + INR prediction "
              "overlays)", "",
              f"- {renderer.backend} renderer vs exact oracle PSNR: "
              f"**{ps:.1f} dB** (same frame, voxel-pitch sampling)",
              f"- orbit throughput with both overlays: **{fps:.1f} fps** "
              f"(backend {renderer.backend}, volume {tuple(vol)}, on "
              f"{where})",
              "- frames: renders/inr_overlay_{sweep,oracle}.png", ""]
    (out / "RESULTS_r1.md").write_text("\n".join(lines))
    print("\n".join(lines))
    return {"psnr_db": ps, "fps": fps, "backend": renderer.backend,
            "train_s": t_train, "mean_dice": ev["mean_dice"][0],
            "steps": steps}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mri_raytracer_tpu_torch.env import resolve_device

    run_demo(args.out, resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
