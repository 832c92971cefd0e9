"""Experiment observability (own copy of ``io/logging.py``, reference
O1-O6).

W&B is optional (import-gated: it may not be installed); the JSON
results file is always written and progressively updated, mirroring the
reference's ``training_config_and_results.json`` / ``best_results.json``
(``inr/inr/train.py:90-96,341-424``). Scalars also stream to a local JSONL
so training curves survive without any network service.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Any, Dict, Optional


def _wandb():
    try:
        import wandb  # type: ignore

        return wandb
    except ImportError:
        return None


class RunLogger:
    def __init__(self, out_dir, run_name: str, config: Dict[str, Any],
                 use_wandb: bool = False, wandb_project: str = "mri-raytracer-tpu",
                 wandb_entity: Optional[str] = None, tags=None, notes: str = ""):
        self.out_dir = pathlib.Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.run_name = run_name
        self.results: Dict[str, Any] = {"config": config, "run_name": run_name,
                                        "started_at": time.time()}
        self._scalars_path = self.out_dir / f"{run_name}_scalars.jsonl"
        self._scalars_f = open(self._scalars_path, "a")
        self._results_path = self.out_dir / "training_config_and_results.json"
        self._flush_results()

        self.wandb_run = None
        if use_wandb:
            wandb = _wandb()
            if wandb is None:
                print("[logger] wandb requested but not installed; JSON-only logging")
            else:
                self.wandb_run = wandb.init(project=wandb_project, entity=wandb_entity,
                                            name=run_name, config=config,
                                            tags=tags, notes=notes)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        rec = {"step": step, "t": time.time(), **{k: float(v) for k, v in metrics.items()}}
        self._scalars_f.write(json.dumps(rec) + "\n")
        self._scalars_f.flush()
        if self.wandb_run is not None:
            try:
                self.wandb_run.log(metrics, step=step)
            except Exception as e:  # network failures never kill training
                print(f"[logger] wandb.log failed: {e}")

    def log_bar(self, name: str, labels, values, step: int) -> None:
        """Per-class bar chart (reference ``inr/inr/train.py:426-431``
        ``wandb.plot.bar``); the values also stream to the JSONL record."""
        self.log({f"{name}/{l}": float(v) for l, v in zip(labels, values)},
                 step)
        if self.wandb_run is None:
            return
        try:
            wandb = _wandb()
            table = wandb.Table(data=[[str(l), float(v)]
                                      for l, v in zip(labels, values)],
                                columns=["class", "value"])
            self.wandb_run.log(
                {name: wandb.plot.bar(table, "class", "value", title=name)},
                step=step)
        except Exception as e:
            print(f"[logger] wandb bar failed: {e}")

    def log_table(self, name: str, columns, rows, step: int) -> None:
        """Tabular metrics (reference ``wandb.Table`` at train.py:432-435);
        always mirrored to ``<run>_tables.jsonl``."""
        rec = {"step": step, "name": name, "columns": list(columns),
               "rows": [[None if v is None else float(v) if isinstance(
                   v, (int, float)) else str(v) for v in r] for r in rows]}
        with open(self.out_dir / f"{self.run_name}_tables.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.wandb_run is None:
            return
        try:
            wandb = _wandb()
            self.wandb_run.log(
                {name: wandb.Table(columns=list(columns), data=rows)},
                step=step)
        except Exception as e:
            print(f"[logger] wandb table failed: {e}")

    def log_image(self, name: str, image, step: int,
                  caption: str = "") -> None:
        """Image/overlay logging (reference ``wandb.Image`` at
        ``jax_inr_training_wandb_improved.py:1005-1036``); always saved as a
        PNG under ``media/`` so offline runs keep the visuals."""
        import numpy as np

        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        media = self.out_dir / "media"
        media.mkdir(exist_ok=True)
        path = media / f"{name.replace('/', '_')}_step{step:06d}.png"
        try:
            from PIL import Image

            Image.fromarray(arr).save(path)
        except Exception as e:
            print(f"[logger] png save failed: {e}")
        if self.wandb_run is None:
            return
        try:
            wandb = _wandb()
            self.wandb_run.log({name: wandb.Image(str(path), caption=caption)},
                               step=step)
        except Exception as e:
            print(f"[logger] wandb image failed: {e}")

    def log_summary(self, summary: Dict[str, Any]) -> None:
        self.results.update(summary)
        self._flush_results()
        if self.wandb_run is not None:
            try:
                for k, v in summary.items():
                    self.wandb_run.summary[k] = v
            except Exception as e:
                print(f"[logger] wandb summary failed: {e}")

    def log_artifact(self, path, kind: str = "model") -> None:
        if self.wandb_run is None:
            return
        try:
            wandb = _wandb()
            art = wandb.Artifact(f"{self.run_name}-{kind}", type=kind)
            art.add_file(str(path))
            self.wandb_run.log_artifact(art)
        except Exception as e:
            print(f"[logger] artifact upload failed: {e}")

    def save_best(self, payload: Dict[str, Any]) -> None:
        (self.out_dir / "best_results.json").write_text(
            json.dumps(payload, indent=2, default=str))

    def _flush_results(self) -> None:
        self._results_path.write_text(json.dumps(self.results, indent=2, default=str))

    def finish(self) -> None:
        self.results["finished_at"] = time.time()
        self._flush_results()
        self._scalars_f.close()
        if self.wandb_run is not None:
            try:
                self.wandb_run.finish()
            except Exception:
                pass
