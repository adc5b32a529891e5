"""Metrics logging: structured rows → CSV, stdout, optional wandb
(counterpart of ``eeg_image_decode_tpu/utils/logging.py``).

The reference's observability surface (``models/util.py:231-287``'s
``wandb_logger`` and the per-epoch CSV rows of ``ATMS_retrieval.py:569-582``)
without its crash when logging is off. The CSV and stdout rows are the JAX
logger's, byte for byte. ``wandb`` is imported only when asked for, and a
missing or failing wandb raises: the rows are never dropped silently.
"""

from __future__ import annotations

import csv
import json
import os
import sys
import time
from typing import Any


class MetricsLogger:
    """Collects metric rows; writes CSV; optionally mirrors to wandb and
    stdout."""

    def __init__(
        self,
        output_dir: str | None = None,
        *,
        use_wandb: bool = False,
        wandb_config: dict | None = None,
        project: str = "eeg_image_decode_tpu",
        stream=sys.stdout,
    ):
        self.output_dir = output_dir
        self.rows: list[dict[str, Any]] = []
        self.stream = stream
        self._wandb = None
        if use_wandb:
            import wandb  # ImportError when absent: no silent fallback

            self._wandb = wandb.init(
                project=project, config=wandb_config or {}, reinit=True)

    def log(self, row: dict[str, Any], step: int | None = None) -> None:
        row = dict(row)
        row.setdefault("time", time.time())
        self.rows.append(row)
        if self._wandb is not None:
            self._wandb.log(
                {k: v for k, v in row.items() if isinstance(v, (int, float))},
                step=step,
            )

    def print(self, row: dict[str, Any]) -> None:
        if self.stream:
            printable = {
                k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in row.items()
                if k != "time"
            }
            print(json.dumps(printable), file=self.stream)

    def write_csv(self, name: str = "results.csv") -> str | None:
        if not self.output_dir or not self.rows:
            return None
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, name)
        keys = sorted({k for r in self.rows for k in r})
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.rows)
        return path

    def finish(self) -> None:
        self.write_csv()
        if self._wandb is not None:
            self._wandb.finish()
