"""A copy of the benchmark at a size the CPU tests can hold: the cells'
configurations and traffic cut to a 24 x 24 x 16 case and a 48 x 48
viewport, in a temporary root beside the real files."""

from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]
SHAPE = [24, 24, 16]
VIEW = 48


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    """``tmp`` holding ``benchmark/`` and a ``BENCHMARK.json`` with the
    cells ``tiny.seg`` and ``tiny.inr``."""
    root = pathlib.Path(tmp)
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = []
    cfg_dir = root / "benchmark" / "configs"
    for name in ("brats_seg", "brats_inr"):
        cfg = json.loads((cfg_dir / f"{name}.json").read_text())
        cfg["shape"] = SHAPE
        (cfg_dir / f"tiny_{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({
            "name": f"tiny_{name}", "source": cfg["source"],
            "file": f"benchmark/configs/tiny_{name}.json",
            "reduced": ["shape"], "why": "CPU test"})
    traffic = json.loads((root / "benchmark" / "traffic" /
                          "orbit1024.json").read_text())
    traffic.update(width=VIEW, height=VIEW)
    (root / "benchmark" / "traffic" / "tiny.json").write_text(
        json.dumps(traffic))
    spec["workloads"] = [
        {"name": "tiny.seg", "config": "tiny_brats_seg", "traffic": "tiny",
         "chips": 1, "why": "CPU test"},
        {"name": "tiny.inr", "config": "tiny_brats_inr", "traffic": "tiny",
         "chips": 1, "why": "CPU test"}]
    for m in spec["per_layer"]:
        m["workloads"] = ["tiny.inr"] + (
            [] if m["name"] == "predict_field_ms" else ["tiny.seg"])
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
