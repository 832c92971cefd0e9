"""INR training CLI (port of ``scripts/train_inr.py``): the flags of
``TrainConfig.to_cli_parser`` plus ``--device``.

    python -m mri_raytracer_tpu_torch.apps.train_inr --data-root DIR \\
        --case-limit 4 --num-folds 4 --steps 60 --out runs/demo

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; without a card it exits with the error. Data-parallel training
runs one process a device under ``torchrun``, which sets the rendezvous
variables this CLI reads:

    torchrun --nproc-per-node N -m mri_raytracer_tpu_torch.apps.train_inr \
        --data-parallel N --data-root DIR ...
"""

from __future__ import annotations

import os
import sys


def join_torchrun(device: str) -> str:
    """Join the process group ``torchrun`` describes in the environment
    (``WORLD_SIZE`` > 1) and return this rank's device: ``cuda:LOCAL_RANK``
    for ``cuda``. Without ``torchrun`` the device is returned as it is."""
    from mri_raytracer_tpu_torch.parallel.mesh import initialize_distributed

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return device
    if device == "cuda":
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    initialize_distributed(
        f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", world,
        int(os.environ["RANK"]), device)
    return device


def main(argv=None) -> int:
    import torch.distributed

    from mri_raytracer_tpu_torch.config import TrainConfig
    from mri_raytracer_tpu_torch.train.engine import train_inr

    parser = TrainConfig.to_cli_parser()
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on ('cuda' or 'cpu')")
    args = parser.parse_args(argv)
    device = join_torchrun(args.device)
    try:
        state = train_inr(TrainConfig.from_args(args), device=device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if int(os.environ.get("RANK", "0")):
        return 0
    print(f"final loss={state['history'][-1]['loss']:.4f} "
          f"checkpoint={state['checkpoint']}")
    if state["eval"]:
        for k, (mean, std) in sorted(state["eval"].items()):
            print(f"  {k}: {mean:.4f} +/- {std:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
