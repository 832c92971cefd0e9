"""Full-geometry end-to-end smoke (port of ``scripts/full_geometry_smoke.py``):
the real BraTS case shape (240 x 240 x 155, 4 modalities + seg,
``docs/Goals.md:139-152``) through the whole pipeline: dataset write ->
native/Python loader -> INR training -> full-volume bake -> render orbit,
with the wall time of each stage.

    python -m mri_raytracer_tpu_torch.apps.full_geometry_smoke [--steps 60]

The dataset is written to ``--root`` only when it holds fewer than
``--cases`` cases (default ``build/full_geometry_smoke/data``); the run and
``--write-doc``'s ``RESULTS_r2.md`` go under ``--out`` (default
``build/full_geometry_smoke/``). Prints one JSON line. The orbit is
stage 1 + K1 + K2 on the card. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

DEFAULT_OUT = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "full_geometry_smoke"
SHAPE = (240, 240, 155)  # real BraTS 2023 geometry


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="full BraTS geometry smoke "
                                 "(PyTorch/CUDA)")
    ap.add_argument("--root", default=str(DEFAULT_OUT / "data"))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--cases", type=int, default=3)
    ap.add_argument("--write-doc", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default="cuda")
    return ap


def run_smoke(root, out, steps: int, size: int, frames: int, cases: int,
              device, shape=SHAPE) -> tuple:
    """The smoke's stages: returns (JSON record, markdown table)."""
    import torch

    from mri_raytracer_tpu_torch.config import TrainConfig
    from mri_raytracer_tpu_torch.data import brats, synthetic
    from mri_raytracer_tpu_torch.data.cache import RAMCache
    from mri_raytracer_tpu_torch.eval.inference import predict_volume
    from mri_raytracer_tpu_torch.io import native
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.brats import BratsRenderer
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
    from mri_raytracer_tpu_torch.train.engine import train_inr
    from mri_raytracer_tpu_torch.utils.profiling import median_time

    timings = {}
    root = pathlib.Path(root)
    t0 = time.perf_counter()
    if len(brats.find_cases(root)) < cases:
        synthetic.write_synthetic_dataset(root, num_cases=cases,
                                          shape=shape, seed=0)
    timings["dataset_write_s"] = time.perf_counter() - t0
    print(f"[fg] dataset at {root} ({cases} cases of {shape}) in "
          f"{timings['dataset_write_s']:.1f}s; native loader: "
          f"{native.available()}", file=sys.stderr)

    # ---- loader (the native C++ path when it builds)
    t0 = time.perf_counter()
    cache = RAMCache(brats.find_cases(root), verbose=False)
    timings["load_all_cases_s"] = time.perf_counter() - t0
    if cache.vol_shape != tuple(shape):
        raise RuntimeError(f"loaded shape {cache.vol_shape}, want {shape}")
    print(f"[fg] loaded {cache.n_cases} cases in "
          f"{timings['load_all_cases_s']:.1f}s", file=sys.stderr)

    # ---- training at full geometry
    cfg = TrainConfig()
    cfg.data.data_root = str(root)
    cfg.data.case_limit = cases
    cfg.data.num_folds = cases
    cfg.data.pool_size = max(2, cases - 1)
    cfg.model.hidden_dims = (64, 64, 64)
    cfg.train_steps = steps
    cfg.global_batch = 16384
    cfg.micro_batch = 8192
    cfg.checkpoint_every = 0
    cfg.out_dir = str(pathlib.Path(out) / "run")
    cfg.run_name = "fullgeo"
    t0 = time.perf_counter()
    state = train_inr(cfg, use_wandb=False, device=device)
    timings["train_s"] = time.perf_counter() - t0
    steps_per_s = steps / timings["train_s"]
    print(f"[fg] {steps} steps in {timings['train_s']:.1f}s "
          f"({steps_per_s:.2f} steps/s at global batch {cfg.global_batch})",
          file=sys.stderr)

    # ---- bake the prediction volume (a forward pass a voxel)
    case = cache.get(0)
    t0 = time.perf_counter()
    with torch.no_grad():
        pred, _ = predict_volume(state["model"], state["params"], case,
                                 device=device)
    timings["bake_s"] = time.perf_counter() - t0
    print(f"[fg] baked {pred.shape} prediction in {timings['bake_s']:.1f}s "
          f"(classes {np.unique(pred)})", file=sys.stderr)

    # ---- render orbit at the full (non-cubic) geometry
    disp = np.stack([brats.percentile_normalize(m) for m in case["mods"]])
    p = rp.default_render_params(shape, show_seg=True, show_pred=True)
    renderer = BratsRenderer(disp, case["seg"].astype(np.int32),
                             pred.astype(np.int32), width=size, height=size,
                             device=device)
    cam = OrbitalCamera(radius=rp.default_camera_radius(p, shape),
                        theta=0.6, phi=1.2)
    with torch.no_grad():
        t0 = time.perf_counter()
        renderer.warmup(p)
        timings["render_compile_s"] = time.perf_counter() - t0

        def step():
            cam.orbit(0.03, 0.01)
            return renderer.render(cam.basis(), p)

        fps = 1.0 / median_time(step, frames, 3)
        img = renderer.render(cam.basis(), p)
    timings["render_fps"] = fps
    print(f"[fg] render {size}^2 on {shape}: {fps:.1f} fps "
          f"(backend {renderer.backend})", file=sys.stderr)
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("the orbit frame is not finite")
    rec = {"metric": "full_geometry_fps", "value": round(fps, 2),
           "unit": "fps", "shape": list(shape),
           **{k: round(v, 2) for k, v in timings.items()}}
    doc = (f"\n## Full BraTS geometry smoke ({'x'.join(map(str, shape))} "
           f"x4)\n\n| stage | time |\n|---|---|\n"
           f"| load {cache.n_cases} cases "
           f"({'native C++' if native.available() else 'python'}) | "
           f"{timings['load_all_cases_s']:.1f} s |\n"
           f"| train {steps} steps @ global {cfg.global_batch} |"
           f" {timings['train_s']:.1f} s ({steps_per_s:.2f} steps/s) |\n"
           f"| bake {'x'.join(map(str, shape))} prediction | "
           f"{timings['bake_s']:.1f} s |\n"
           f"| render orbit {size}^2 | **{fps:.1f} fps** |\n")
    return rec, doc


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mri_raytracer_tpu_torch.env import resolve_device

    dev = resolve_device(args.device)
    rec, doc = run_smoke(args.root, args.out, args.steps, args.size,
                         args.frames, args.cases, dev)
    print(json.dumps(rec))
    if args.write_doc:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "RESULTS_r2.md", "a") as f:
            f.write(doc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
