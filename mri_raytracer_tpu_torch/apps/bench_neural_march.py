"""Neural-march (mode 2) benchmark (port of ``scripts/bench_neural_march.py``):
fps at 1024^2 and the in-march MLP overhead against the baked-overlay
sweep (reference target < 1 ms a frame, ``docs/Goals.md:66``; modes
``docs/Goals.md:33-34``), on one volume and camera orbit:

  1. sweep with NO overlay            (floor)
  2. sweep with a BAKED pred overlay  (mode 1)
  3. fused neural march               (mode 2: the INR evaluated in-sweep)

    python -m mri_raytracer_tpu_torch.apps.bench_neural_march [--interleave]

MLP overhead = frame time (mode 2) - frame time (mode 1). Prints one JSON
line with the JAX script's keys; ``--write-doc`` appends a table to
``RESULTS_r2.md`` under ``--out`` (default ``build/bench_neural_march/`` of
the checkout). On the card the sweeps are stage 1 + K1 (K1a rows; K1b for
the neural field) + K2. Runs on the card unless ``--device cpu``. Frames
are queued back to back and synchronised once a batch.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

DEFAULT_OUT = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "bench_neural_march"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="mode-2 neural march fps and MLP overhead "
        "(PyTorch/CUDA)")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--vol", type=int, default=256)
    ap.add_argument("--hidden", default="32,32")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--batches", type=int, default=3)
    # stride 4 at 1024^2/256^3 matches the baked overlay's effective
    # content resolution (a 256-wide label volume nearest-sampled at 1024
    # intermediate positions carries ~256 distinct samples an axis).
    ap.add_argument("--pred-stride", type=int, default=4)
    ap.add_argument("--pred-kstride", type=int, default=1,
                    help="field plane stride (every K-th sweep plane, "
                    "nearest-upsampled in-kernel)")
    ap.add_argument("--write-doc", action="store_true")
    ap.add_argument("--interleave", action="store_true",
                    help="alternate plain/baked/neural batches per round "
                    "(overhead from same-round differences)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default="cuda")
    return ap


def _orbiting(render_fn, cam):
    """A call that moves ``cam`` one orbit step and renders it."""
    def step():
        cam.orbit(0.03, 0.01)
        return render_fn(cam.basis())
    return step


def orbit_fps(render_fn, camera_fn, frames: int, batches: int) -> float:
    """Median fps over ``batches`` batches of ``frames`` orbit frames, each
    batch synchronised once (after a synced warm frame)."""
    from mri_raytracer_tpu_torch.utils.profiling import median_time

    return 1.0 / median_time(_orbiting(render_fn, camera_fn()), frames,
                             batches)


def interleaved_fps(fns, camera_fn, frames: int, rounds: int):
    """{name: [fps a round]}: one batch of each renderer a round, so the
    rounds' differences share one window of the host's drift."""
    from mri_raytracer_tpu_torch.utils.profiling import batch_times, sync

    steps = {k: _orbiting(fn, camera_fn()) for k, fn in fns}
    for step in steps.values():  # warm every path
        sync(step())
    out = {k: [] for k in steps}
    for _ in range(rounds):
        for k, step in steps.items():
            out[k].append(1.0 / batch_times(step, frames, 1, warm=False)[0])
    return out


def rebake_ms(model, params, zsc, reps: int = 5) -> float:
    """Mean ms of ``neural_march.bake_labels`` over ``reps`` re-bakes after
    a synced warm one."""
    from mri_raytracer_tpu_torch.ops import neural_march
    from mri_raytracer_tpu_torch.utils.profiling import batch_times

    return 1000.0 * batch_times(
        lambda: neural_march.bake_labels(model, params, zsc), reps, 1)[0]


def doc_section(size: int, vol: int, fps: dict, ms: dict, overhead: float,
                n_params: int, bake_s: float) -> str:
    return (f"\n## Neural march (mode 2) at {size}^2 on {vol}^3\n\n"
            f"| config | fps | ms/frame |\n|---|---|---|\n"
            f"| sweep, no overlay | {fps['plain']:.1f} | "
            f"{ms['plain']:.2f} |\n"
            f"| mode 1 (baked overlay) | {fps['baked']:.1f} | "
            f"{ms['baked']:.2f} |\n"
            f"| mode 2 (fused neural march) | {fps['neural']:.1f} | "
            f"{ms['neural']:.2f} |\n\n"
            f"In-march MLP overhead ({n_params}-param INR): "
            f"**{overhead:.2f} ms/frame** (Goals.md target < 1 ms). "
            f"One-time bake cost avoided: {bake_s:.2f} s.\n")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from mri_raytracer_tpu_torch.apps.neural_psnr_cert import synthetic_inputs
    from mri_raytracer_tpu_torch.config import ModelConfig
    from mri_raytracer_tpu_torch.env import resolve_device
    from mri_raytracer_tpu_torch.eval.inference import predict_volume
    from mri_raytracer_tpu_torch.models.api import build_model
    from mri_raytracer_tpu_torch.ops.neural_march import NeuralBratsRenderer
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.brats import BratsRenderer
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera

    dev = resolve_device(args.device)
    V = (args.vol,) * 3
    S = args.size
    disp, zsc, seg = synthetic_inputs(args.vol)
    hidden = tuple(int(x) for x in args.hidden.split(","))
    cfg = ModelConfig(hidden_dims=hidden, fourier_freqs=6, num_classes=4)
    model = build_model(cfg, num_modalities=4)
    params = model.init(torch.Generator().manual_seed(0)).to(dev)
    n_params = sum(int(t.numel()) for t in params.parameters())
    print(f"[nm] INR: hidden={hidden} params={n_params} device={dev}",
          file=sys.stderr)

    p = rp.default_render_params(V, show_seg=True, show_pred=True)
    radius = rp.default_camera_radius(p, V)

    def start_cam():
        return OrbitalCamera(radius=radius, theta=0.6, phi=1.2)

    # Mode 1 prep: bake the prediction volume once.
    t0 = time.perf_counter()
    with torch.no_grad():
        pred, _ = predict_volume(model, params, {"mods": zsc, "seg": seg},
                                 device=dev)
    bake_s = time.perf_counter() - t0
    pred = pred.astype(np.int32)

    r_plain = BratsRenderer(disp, seg, None, width=S, height=S, device=dev)
    r_baked = BratsRenderer(disp, seg, pred, width=S, height=S, device=dev)
    r_neural = NeuralBratsRenderer(disp, zsc, seg, model, params, width=S,
                                   height=S, pred_stride=args.pred_stride,
                                   pred_kstride=args.pred_kstride,
                                   device=dev)
    p_np = p._replace(show_pred=torch.tensor(1.0))
    fns = [("plain", lambda b: r_plain.render(b, p)),
           ("baked", lambda b: r_baked.render(b, p_np)),
           ("neural", lambda b: r_neural.render(b, p_np))]
    with torch.no_grad():
        if args.interleave:
            rounds = interleaved_fps(fns, start_cam, args.frames,
                                     max(5, args.batches))
            per_round = [1000.0 / n - 1000.0 / b for n, b in
                         zip(rounds["neural"], rounds["baked"])]
            print("[nm] per-round fps: " + "; ".join(
                f"{k}={[round(x, 1) for x in v]}"
                for k, v in rounds.items()), file=sys.stderr)
            print(f"[nm] per-round overhead ms: "
                  f"{[round(x, 2) for x in per_round]}", file=sys.stderr)
            fps = {k: float(np.median(v)) for k, v in rounds.items()}
        else:
            fps = {k: orbit_fps(fn, start_cam, args.frames, args.batches)
                   for k, fn in fns}
        print(f"[nm] neural backend: {r_neural.backend}", file=sys.stderr)
        # The voxel-grid re-bake (the amortised live-INR path): one bake a
        # parameter change, mode-1 frames in between.
        rb_ms = rebake_ms(model, params, torch.as_tensor(zsc, device=dev))
    print(f"[nm] voxel-grid re-bake: {rb_ms:.1f} ms (generic bake path: "
          f"{bake_s:.2f} s)", file=sys.stderr)

    ms = {k: 1000.0 / v for k, v in fps.items()}
    overhead = float(np.median(per_round)) if args.interleave \
        else ms["neural"] - ms["baked"]
    print(f"[nm] fps: plain={fps['plain']:.1f} baked={fps['baked']:.1f} "
          f"neural={fps['neural']:.1f}; bake={bake_s:.2f}s",
          file=sys.stderr)
    print(f"[nm] in-march MLP overhead: {overhead:.2f} ms/frame "
          f"(<1 ms target)", file=sys.stderr)
    rec = {"metric": "neural_march_fps", "value": round(fps["neural"], 2),
           "unit": "fps", "mlp_overhead_ms": round(overhead, 3),
           "baked_fps": round(fps["baked"], 2),
           "plain_fps": round(fps["plain"], 2),
           "bake_seconds": round(bake_s, 2), "params": n_params,
           "rebake_ms": round(rb_ms, 2), "size": S, "vol": args.vol}
    print(json.dumps(rec))
    if args.write_doc:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "RESULTS_r2.md", "a") as f:
            f.write(doc_section(S, args.vol, fps, ms, overhead, n_params,
                                bake_s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
