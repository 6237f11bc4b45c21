"""Console logging and a CSV metrics writer, ported from
``explainable_spatial_vqa_tpu/utils/logging.py``: timestamped records on
stderr (:func:`setup_logging`) and one CSV row per (epoch, split)
(:class:`MetricsWriter`)."""

from __future__ import annotations

import csv
import logging
import os
import sys
from typing import Dict, Iterable

__all__ = ["setup_logging", "MetricsWriter"]


def setup_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(
        level=level,
        format="%(asctime)s - %(levelname)s - %(name)s: %(message)s",
        handlers=[logging.StreamHandler(sys.stderr)],
        force=True,
    )


class MetricsWriter:
    """Append-only CSV metrics log; one row per (epoch, split)."""

    def __init__(self, path: str, fieldnames: Iterable[str]):
        self.path = path
        self.fieldnames = ["epoch", "split"] + [
            f for f in fieldnames if f not in ("epoch", "split")
        ]
        exists = os.path.exists(path)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._file = open(path, "a", newline="")
        self._writer = csv.DictWriter(self._file, fieldnames=self.fieldnames,
                                      extrasaction="ignore")
        if not exists:
            self._writer.writeheader()

    def write(self, epoch: int, split: str, metrics: Dict[str, float]) -> None:
        row = {"epoch": epoch, "split": split}
        row.update({k: float(v) for k, v in metrics.items()})
        self._writer.writerow(row)
        self._file.flush()

    def close(self) -> None:
        self._file.close()
