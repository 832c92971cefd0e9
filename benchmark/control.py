"""The readings the ``limits`` of a configuration were set from.

    python3 -m benchmark.control --workload <name> --seeds 12 --control-seeds 3

In one process, for the cell ``name``:

  * the program on ``--seeds`` seeds, each a short run of the cell
    (``--seconds``), checked as a run checks: the lower readings;
  * each control (``systems/<system>.controls``: the reference put in the
    program's place, computed one step below the precision the
    configuration states, one part at a time) on ``--control-seeds``
    seeds, over as many frames as a run checks: the upper readings.

Prints one JSON line a run and a summary (the largest program reading and
the smallest control reading of each compared number), and writes them to
``--out`` as well. It needs the card, as a run does; the benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(workload: str, seeds, control_seeds, seconds: float,
             root: pathlib.Path = ROOT, device=None, log_fn=None):
    """[{"seed", "run": "program" | "control:<variant>", "correct",
    "checks": {number: value}}] for the program and every control."""
    from benchmark import check, harness

    log_fn = log_fn or harness.log
    c = harness.cell(root, workload)
    out = []

    def one(seed, label, make_sut=None, min_frames=1, secs=seconds):
        r, detail = harness.run(workload, seed, secs, False, root, device,
                                log_fn, make_sut=make_sut,
                                min_frames=min_frames)
        row = {"seed": seed, "run": label, "correct": r["correct"],
               "frames": detail["frames_checked"],
               "err_max": detail["err_max"],
               "checks": {k: r["checks"][k]["value"]
                          for k in check.COMPARED}}
        print(json.dumps(row), flush=True)
        out.append(row)

    for seed in seeds:
        one(seed, "program")
    n = harness.CHECK_FRAMES + 1
    for variant in c.system.controls(c.config):
        def make(cfg, traffic, seed, dev, v=variant):
            return c.system.control(cfg, traffic, seed, dev, v)
        for seed in control_seeds:
            one(seed, f"control:{variant}", make, min_frames=n, secs=0.0)
    return out


def summary(rows):
    from benchmark import check

    prog = [r for r in rows if r["run"] == "program"]
    s = {"lower": {k: max(r["checks"][k] for r in prog)
                   for k in check.COMPARED} if prog else {},
         "upper": {}}
    for label in sorted({r["run"] for r in rows} - {"program"}):
        rs = [r for r in rows if r["run"] == label]
        s["upper"][label] = {k: min(r["checks"][k] for r in rs)
                             for k in check.COMPARED}
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3000000000)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from benchmark import harness

    harness.cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        harness.log("needs a CUDA card")
        return 2
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    cseeds = [args.first_seed + 104729 * (k + 1)
              for k in range(args.control_seeds)]
    rows = readings(args.workload, seeds, cseeds, args.seconds)
    s = summary(rows)
    print(json.dumps({"workload": args.workload, "summary": s}), flush=True)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            for r in rows:
                f.write(json.dumps({"workload": args.workload, **r}) + "\n")
            f.write(json.dumps({"workload": args.workload,
                                "summary": s}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
