"""INR training CLI (port of ``scripts/train_inr.py``): the flags of
``TrainConfig.to_cli_parser`` plus ``--device``.

    python -m mri_raytracer_tpu_torch.apps.train_inr --data-root DIR \\
        --case-limit 4 --num-folds 4 --steps 60 --out runs/demo

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; without a card it exits with the error.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from mri_raytracer_tpu_torch.config import TrainConfig
    from mri_raytracer_tpu_torch.train.engine import train_inr

    parser = TrainConfig.to_cli_parser()
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on ('cuda' or 'cpu')")
    args = parser.parse_args(argv)
    state = train_inr(TrainConfig.from_args(args), device=args.device)
    print(f"final loss={state['history'][-1]['loss']:.4f} "
          f"checkpoint={state['checkpoint']}")
    if state["eval"]:
        for k, (mean, std) in sorted(state["eval"].items()):
            print(f"  {k}: {mean:.4f} +/- {std:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
