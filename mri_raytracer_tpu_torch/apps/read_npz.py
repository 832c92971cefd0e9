"""Checkpoint inspector CLI (port of ``scripts/read_npz.py``; reference
``scripts/read_npz.py`` parity): the tree of each npz file, one line a
node, through ``io/checkpoint.inspect_npz``.

    python -m mri_raytracer_tpu_torch.apps.read_npz CKPT.npz [...]

Host-only: reads files, runs nothing on a device. Exit code 1 without a
path.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from mri_raytracer_tpu_torch.io.checkpoint import inspect_npz

    paths = sys.argv[1:] if argv is None else list(argv)
    if not paths:
        print("usage: read_npz.py <checkpoint.npz> [...]")
        return 1
    for path in paths:
        print(f"== {path}")
        for line in inspect_npz(path):
            print("  " + line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
