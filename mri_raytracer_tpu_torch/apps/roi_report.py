"""Re-report a finished ROI protocol run (port of ``scripts/roi_report.py``):
``ROI_RESULTS{_hard}.md`` from ``roi_results{_hard}.json`` (no renders),
in the current report format (verdict table and anchor sweep), with the
LOD ablation line when the results hold one.

    python -m mri_raytracer_tpu_torch.apps.roi_report [--suite adversarial]

Reads ``--docs`` (default the repo's ``docs/``); writes the markdown under
``--out`` (default ``build/roi_report/`` of the checkout). Host-only: runs
nothing on a device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Optional

REPO = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "build" / "roi_report"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="ROI protocol report from its "
                                 "results JSON")
    ap.add_argument("--suite", default="showcase",
                    choices=["showcase", "adversarial"])
    ap.add_argument("--docs", default=str(REPO / "docs"),
                    help="where roi_results{_hard}.json is read")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    return ap


def lod_line(results: dict) -> Optional[str]:
    """The LOD ablation sentence of the report, or None without one."""
    ab = results.get("lod_ablation")
    if not (ab and ab.get("policy") and ab.get("policy_lod")):
        return None
    pl_, plod = ab["policy"][-1], ab["policy_lod"][-1]
    return (f"LOD ablation (primary scene, n={pl_['n']}, fine-tuned "
            f"head): policy {pl_['wpsnr']:.2f} dB wPSNR / "
            f"{pl_['ms']:.1f} ms -> +LOD {plod['wpsnr']:.2f} dB / "
            f"{plod['ms']:.1f} ms "
            f"(delta {plod['wpsnr'] - pl_['wpsnr']:+.2f} dB, "
            f"{plod['ms'] - pl_['ms']:+.1f} ms).")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from mri_raytracer_tpu_torch.eval import roi_protocol

    suffix = "" if args.suite == "showcase" else "_hard"
    results = json.loads((pathlib.Path(args.docs)
                          / f"roi_results{suffix}.json").read_text())
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    md = out / ("ROI_RESULTS_hard.md" if suffix else "ROI_RESULTS.md")
    roi_protocol.write_report(results, md, suite=args.suite,
                              lod_line=lod_line(results))
    print(f"[roi-report] wrote {md}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
