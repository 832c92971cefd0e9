"""Runs one cell of ``BENCHMARK.json`` once and prints its result.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit;
the same numbers end standard error, after the run's details (set-up by
part, the frames checked, the largest pixel difference).
Exits 2 without a result where no card, or fewer cards than the cell asks
for, is present (it never falls back to the CPU), and 3 where JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    harness.cache_dirs(ROOT)
    marks = {"torch_imported_at_s": harness.process_age_s()}
    import torch

    chips = harness.cell(ROOT, args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA card(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                    ": no result")
        return 2
    marks["cards_seen_at_s"] = harness.process_age_s()
    result, detail = harness.run(args.workload, args.seed, args.seconds,
                                 bool(args.trace), ROOT, marks=marks)
    harness.log(f"detail {json.dumps(detail)}")
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded {bad} (JAX or the JAX package): no result")
        return 3
    for line in harness.checks_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
