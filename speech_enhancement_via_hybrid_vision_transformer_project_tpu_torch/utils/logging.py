"""Training scalars as JSON lines and a throughput stopwatch (JAX
``utils/logging.py``). TensorBoard is not ported: ``metrics.jsonl`` is the
one sink."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class MetricsLogger:
    """Appends ``{"step", "time", <prefix><name>: value, ...}`` lines to
    ``<log_dir>/<experiment_name>/metrics.jsonl``."""

    def __init__(self, log_dir: str | Path, experiment_name: str = "experiment"):
        self.log_dir = Path(log_dir) / experiment_name
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = self.log_dir / "metrics.jsonl"
        self._jsonl = open(self.jsonl_path, "a")

    def log_scalars(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            rec[f"{prefix}{k}" if prefix else k] = float(v)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()


class Stopwatch:
    """Audio-seconds trained per second of wall time."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.audio_seconds = 0.0

    def tick(self, audio_seconds: float = 0.0):
        self.audio_seconds += audio_seconds

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def audio_seconds_per_second(self) -> float:
        e = self.elapsed
        return self.audio_seconds / e if e > 0 else 0.0
