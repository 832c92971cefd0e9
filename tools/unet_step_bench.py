#!/usr/bin/env python3
"""The U-Net baseline's training step (``train/unet_trainer.make_train_step``
at ``chip_smoke.py``'s ``[unet]`` configuration: base 32, batch 8, 240^2,
4 modalities, 4 classes, lr 1e-3) under cuDNN's settings, in turns:

  * ``default``   float32 convolutions (the trainer's choice), NCHW,
                  ``torch.backends.cudnn.benchmark`` off
  * ``benchmark`` the same with cuDNN's autotuner on
  * ``nhwc``      the module and the batch in ``channels_last``
  * ``nhwc+benchmark``
  * ``tf32``      TF32 convolutions, NCHW, no autotuner
  * ``tf32+nhwc+benchmark``

    python3 tools/unet_step_bench.py      # needs one CUDA card, ~1 min

Each variant starts from the same weights and batch (seed 0), runs
WARM steps, then STEPS steps between CUDA events after each; prints the
median and mean ms a step, TFLOP/s at the step's 390 GFLOP, the first
step's loss (the variants must agree on it), and the two rounds' medians,
with the card's name and power limit.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

WARM = 5
STEPS = 20
ROUNDS = 2
VARIANTS = {
    "default": dict(benchmark=False, nhwc=False, tf32=False),
    "benchmark": dict(benchmark=True, nhwc=False, tf32=False),
    "nhwc": dict(benchmark=False, nhwc=True, tf32=False),
    "nhwc+benchmark": dict(benchmark=True, nhwc=True, tf32=False),
    "tf32": dict(benchmark=False, nhwc=False, tf32=True),
    "tf32+nhwc+benchmark": dict(benchmark=True, nhwc=True, tf32=True),
}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from mri_raytracer_tpu_torch.env import power_limit
    from mri_raytracer_tpu_torch.models import unet
    from mri_raytracer_tpu_torch.train import unet_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    card = f"{torch.cuda.get_device_name(0)} [{power_limit()}]"
    gflop = 3 * 8 * chip_smoke.unet_flops(32, 4, 4, 240, 240) / 1e9
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.normal(size=(8, 240, 240, 4))
                            .astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 4, (8, 240, 240))
                              .astype(np.int32)).cuda()
    init = unet.create_unet(torch.Generator().manual_seed(0), 4, 4, 32,
                            (240, 240)).state_dict()
    results = {name: [] for name in VARIANTS}
    for rnd in range(ROUNDS):
        order = list(VARIANTS) if rnd % 2 == 0 else list(VARIANTS)[::-1]
        for name in order:
            v = VARIANTS[name]
            torch.backends.cudnn.benchmark = v["benchmark"]
            torch.backends.cudnn.allow_tf32 = v["tf32"]
            net = unet.UNet2D(4, 4, 32).cuda()
            net.load_state_dict(init)
            x = imgs
            if v["nhwc"]:
                net = net.to(memory_format=torch.channels_last)
            step = unet_trainer.make_train_step(
                net, unet_trainer.build_adamw(net, 1e-3), 4)
            first = float(step(x, labels))
            for _ in range(WARM - 1):
                step(x, labels)
            torch.cuda.synchronize()
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(STEPS + 1)]
            events[0].record()
            for i in range(STEPS):
                step(x, labels)
                events[i + 1].record()
            torch.cuda.synchronize()
            per = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            results[name].append((float(np.median(per)),
                                  float(np.mean(per)), first))
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = True
    for name, runs in results.items():
        med = [r[0] for r in runs]
        print(f"{name:22s} median {np.median(med):8.4f} ms a step (rounds "
              + ", ".join(f"{m:.4f}" for m in med)
              + f"), mean {np.mean([r[1] for r in runs]):8.4f}, "
              f"{gflop / np.median(med):6.2f} TFLOP/s, first loss "
              f"{runs[0][2]:.6f}", flush=True)
    print(f"{gflop:.1f} GFLOP a step, on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
