"""Mode-2 (fused neural march) final-image certification (port of
``scripts/neural_psnr_cert.py``): PSNR of the neural-overlay render against
the oracle rendering the BAKED prediction, at the full bench configuration
(1024^2 / 256^3), over the six-pose sweep (orbit faces and the worst
diagonal), at each ``--kstrides`` plane stride.

    python -m mri_raytracer_tpu_torch.apps.neural_psnr_cert
    python -m mri_raytracer_tpu_torch.apps.neural_psnr_cert --train-steps 600

The bar is image PSNR >= 40 dB at EVERY pose; the exit code is 1 where a
kstride misses it. Writes ``neural_psnr_cert{_trained}{_sS}.json`` under
``--out`` (default ``build/neural_psnr_cert/`` of the checkout) and prints
one JSON line. On the card ``NeuralBratsRenderer``'s 'auto' backend is
'fused' (the INR field, stage 1, K1 with the field K1b, K2); runs on the
card unless ``--cpu`` is given (there: the plain scan).
"""

from __future__ import annotations

import argparse
import functools
import json
import pathlib
import sys

import numpy as np

DEFAULT_OUT = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "neural_psnr_cert"
PASS_DB = 40.0
POSES = [("orbit", 0.6, 1.2), ("face-x", 0.0, np.pi / 2),
         ("face-y", np.pi / 2, np.pi / 2), ("top", 0.3, 0.12),
         ("diag-low", 0.85, 0.6), ("diagonal", 0.85, 0.85)]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="mode-2 image PSNR certification (PyTorch/CUDA)")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--vol", type=int, default=256)
    ap.add_argument("--hidden", default="32,32")
    ap.add_argument("--pred-stride", type=int, default=4)
    ap.add_argument("--kstrides", default="1,2")
    ap.add_argument("--oracle-steps", type=int, default=640)
    ap.add_argument("--train-steps", type=int, default=0,
                    help="fit the INR to the synthetic case's labels for N "
                    "Adam steps before certifying. 0 = certify the "
                    "random-init field, an adversarial stress case (its "
                    "argmax label field is voxel-scale speckle); certify a "
                    "trained INR with e.g. --train-steps 600")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    return ap


@functools.lru_cache(maxsize=1)
def synthetic_inputs(vol: int):
    """(display mods, z-scored mods, seg int32) of the vol^3 synthetic case,
    seed 0, as NumPy arrays (kept for the next call: bench_neural_march
    renders the same case)."""
    from mri_raytracer_tpu_torch.data import brats, synthetic

    mods, seg = synthetic.synthetic_case((vol, vol, vol), seed=0)
    disp = np.stack([brats.percentile_normalize(m) for m in mods])
    zsc = np.stack([brats.zscore_nonzero(m.copy()) for m in mods])
    return disp, zsc, seg.astype(np.int32)


def fit_labels(model, params, zsc: np.ndarray, seg: np.ndarray, steps: int,
               device, n_voxels: int = 1 << 17):
    """Full-batch Adam (lr 3e-3, optax's defaults) on softmax cross-entropy
    over ``n_voxels`` fixed voxels drawn with NumPy seed 0 (the JAX
    script's fit). Returns (params, final loss)."""
    import torch
    import torch.nn.functional as F

    V = seg.shape
    rng = np.random.default_rng(0)
    ijk = np.stack([rng.integers(0, V[a], n_voxels) for a in range(3)], 1)
    coords = torch.as_tensor(
        (2.0 * ijk / (np.asarray(V) - 1.0) - 1.0).astype(np.float32),
        device=device)
    intens = torch.as_tensor(
        np.ascontiguousarray(zsc[:, ijk[:, 0], ijk[:, 1], ijk[:, 2]].T),
        dtype=torch.float32, device=device)
    labels = torch.as_tensor(seg[ijk[:, 0], ijk[:, 1], ijk[:, 2]]
                             .astype(np.int64), device=device)
    opt = torch.optim.Adam(params.parameters(), lr=3e-3, eps=1e-8)
    loss = torch.zeros((), device=device)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model.apply(params, coords, intens), labels)
        loss.backward()
        opt.step()
    return params, float(loss.detach())


def render_params(vol: int):
    """(oracle params at step = min voxel size, neural-frame params)."""
    import torch

    from mri_raytracer_tpu_torch.render import params as rp

    V = (vol, vol, vol)
    p = rp.default_render_params(V, show_seg=True, show_pred=True)
    dt_oracle = float(torch.min(p.voxel_size))
    one = torch.tensor(1.0)
    return (p._replace(step_size=torch.tensor(dt_oracle), show_pred=one),
            p._replace(show_pred=one))


def pose_bases(vol: int, poses=POSES):
    """{name: CameraBasis} of ``poses`` at the default camera radius."""
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera

    V = (vol, vol, vol)
    radius = rp.default_camera_radius(
        rp.default_render_params(V, show_seg=True, show_pred=True), V)
    return {name: OrbitalCamera(radius=radius, theta=th, phi=ph).basis()
            for name, th, ph in poses}


def oracle_images(disp, seg, pred, bases, p_o, size: int, steps: int,
                  device):
    """{name: clipped (S, S, 3) oracle frame with the baked prediction}."""
    from mri_raytracer_tpu_torch.ops import raymarch

    return {name: raymarch.render_brats(
        disp, seg, pred, b, p_o, size, size, max_steps=steps,
        device=device).clamp(0.0, 1.0).cpu().numpy()
        for name, b in bases.items()}


def neural_images(renderer, bases, p_n):
    """{name: clipped neural frame} of one renderer."""
    return {name: renderer.render(b, p_n).clamp(0.0, 1.0).cpu().numpy()
            for name, b in bases.items()}


def pose_psnr(img: np.ndarray, oracle: np.ndarray) -> float:
    mse = float(np.mean((img - oracle) ** 2))
    return 10.0 * float(np.log10(1.0 / max(mse, 1e-12)))


def kstride_record(psnrs) -> dict:
    """The JSON record of one kstride from [(dB, pose name), ...]."""
    worst, worst_pose = min(psnrs)
    med = float(np.median([q for q, _ in psnrs]))
    return {"per_pose": {n: round(q, 2) for q, n in psnrs},
            "min_db": round(worst, 2), "min_pose": worst_pose,
            "median_db": round(med, 2), "pass_40db": bool(worst >= PASS_DB)}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from mri_raytracer_tpu_torch.config import ModelConfig
    from mri_raytracer_tpu_torch.env import resolve_device
    from mri_raytracer_tpu_torch.eval.inference import predict_volume
    from mri_raytracer_tpu_torch.models.api import build_model
    from mri_raytracer_tpu_torch.ops.neural_march import NeuralBratsRenderer

    dev = resolve_device("cpu" if args.cpu else "cuda")
    S = args.size
    disp, zsc, seg = synthetic_inputs(args.vol)
    hidden = tuple(int(x) for x in args.hidden.split(","))
    cfg = ModelConfig(hidden_dims=hidden, fourier_freqs=6, num_classes=4)
    model = build_model(cfg, num_modalities=4)
    params = model.init(torch.Generator().manual_seed(0)).to(dev)
    if args.train_steps > 0:
        # A quick fit to the case's own labels: the certified field is then
        # the representative one (coherent tumour structure).
        params, loss = fit_labels(model, params, zsc, seg, args.train_steps,
                                  dev)
        print(f"[cert] trained {args.train_steps} steps, final CE "
              f"{loss:.4f}", file=sys.stderr)

    # Oracle overlay: the BAKED prediction (mode-1 ground truth semantics).
    with torch.no_grad():
        pred, _ = predict_volume(model, params, {"mods": zsc, "seg": seg},
                                 device=dev)
    pred = pred.astype(np.int32)
    print(f"[cert] device={dev} pred voxels={int((pred > 0).sum())}",
          file=sys.stderr)
    p_o, p_n = render_params(args.vol)
    bases = pose_bases(args.vol)
    with torch.no_grad():
        oracles = oracle_images(disp, seg, pred, bases, p_o, S,
                                args.oracle_steps, dev)
    print(f"[cert] oracle frames at {len(bases)} poses done",
          file=sys.stderr)

    results = {"config": {"size": S, "vol": args.vol, "hidden": hidden,
                          "pred_stride": args.pred_stride,
                          "oracle_steps": args.oracle_steps,
                          "train_steps": args.train_steps},
               "kstride": {}}
    overall_ok = True
    for ks in (int(x) for x in args.kstrides.split(",")):
        r = NeuralBratsRenderer(disp, zsc, seg, model, params, width=S,
                                height=S, pred_stride=args.pred_stride,
                                pred_kstride=ks, device=dev)
        with torch.no_grad():
            imgs = neural_images(r, bases, p_n)
        psnrs = [(pose_psnr(imgs[n], oracles[n]), n) for n in bases]
        for q, n in psnrs:
            print(f"[cert] kstride={ks} {n}: {q:.2f} dB", file=sys.stderr)
        rec = kstride_record(psnrs)
        overall_ok &= rec["pass_40db"]
        results["kstride"][str(ks)] = rec
        print(f"[cert] kstride={ks} ({r.backend}): min {rec['min_db']:.2f} "
              f"dB at '{rec['min_pose']}', median {rec['median_db']:.2f} dB "
              f"-> {'PASS' if rec['pass_40db'] else 'FAIL'}",
              file=sys.stderr)

    results["overall_pass"] = overall_ok
    suffix = "_trained" if args.train_steps > 0 else ""
    if args.pred_stride != 4:
        suffix += f"_s{args.pred_stride}"
    out = pathlib.Path(args.out) / f"neural_psnr_cert{suffix}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(json.dumps({"metric": "neural_march_image_psnr_min_db",
                      "value": min(v["min_db"]
                                   for v in results["kstride"].values()),
                      "unit": "dB", "pass": overall_ok}))
    return 0 if overall_ok else 1


if __name__ == "__main__":
    sys.exit(main())
