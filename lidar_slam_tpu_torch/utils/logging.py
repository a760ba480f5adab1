"""Structured stage logging (a copy of lidar_slam_tpu/utils/logging.py,
which imports no JAX; the port keeps its own).

The reference logs with banner prints and per-stage stats scattered through
main.py (reference: main.py:58-70, modules/localization.py:247-249;
SURVEY.md section 5 metrics/logging). This module centralizes that: stage
banners, key=value metric lines that remain grep-able in batch logs, and a
run summary.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional


class StageLogger:
    """Banner-per-stage logger with a collected metrics dict."""

    def __init__(self, stream=None, json_lines: bool = False):
        self.stream = stream or sys.stdout
        self.json_lines = json_lines
        self.metrics: Dict[str, Any] = {}
        self._stage: Optional[str] = None
        self._t0 = 0.0

    def banner(self, text: str) -> None:
        print("=" * 52, file=self.stream)
        print(text, file=self.stream)
        print("=" * 52, file=self.stream)

    def start(self, stage: str) -> None:
        self._stage = stage
        self._t0 = time.time()
        self.banner(f"{stage}...")

    def metric(self, name: str, value) -> None:
        key = f"{self._stage}.{name}" if self._stage else name
        self.metrics[key] = value
        if self.json_lines:
            print(json.dumps({"metric": key, "value": value}), file=self.stream)
        else:
            print(f"  {key} = {value}", file=self.stream)

    def end(self) -> float:
        dt = time.time() - self._t0
        if self._stage:
            self.metrics[f"{self._stage}.seconds"] = round(dt, 3)
            print(f"Done ({dt:.2f}s)\n", file=self.stream)
        self._stage = None
        return dt

    def summary(self) -> Dict[str, Any]:
        if self.json_lines:
            print(json.dumps({"summary": self.metrics}), file=self.stream)
        else:
            self.banner("Run summary")
            for k, v in self.metrics.items():
                print(f"  {k}: {v}", file=self.stream)
        return dict(self.metrics)
