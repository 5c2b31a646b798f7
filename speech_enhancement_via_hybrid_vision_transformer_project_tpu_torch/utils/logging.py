"""Training scalars as JSON lines, optional TensorBoard, audio samples and a
throughput stopwatch (JAX ``utils/logging.py``).

``metrics.jsonl`` is always written. With ``use_tensorboard`` the scalars
also go to a ``torch.utils.tensorboard`` writer under ``<log_dir>/tb``; that
module (and the ``tensorboard`` package behind it, slow to import) is
imported only then, and where it is missing ``tb`` stays ``None`` and the
JSON lines are the one sink.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict

import numpy as np


class NullLogger:
    """A ``MetricsLogger`` that writes nothing: a data-parallel rank other
    than 0 logs through it."""

    tb = None

    def log_scalars(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        pass

    def log_audio(self, step: int, tag: str, audio, sample_rate: int = 16000):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class MetricsLogger:
    """Appends ``{"step", "time", <prefix><name>: value, ...}`` lines to
    ``<log_dir>/<experiment_name>/metrics.jsonl``, and the same scalars to
    TensorBoard when asked for and available (``tb``)."""

    def __init__(self, log_dir: str | Path, experiment_name: str = "experiment",
                 use_tensorboard: bool = True):
        self.log_dir = Path(log_dir) / experiment_name
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = self.log_dir / "metrics.jsonl"
        self._jsonl = open(self.jsonl_path, "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(str(self.log_dir / "tb"))
            except Exception:  # no tensorboard package: JSON lines only
                self.tb = None

    def log_scalars(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            key = f"{prefix}{k}" if prefix else k
            rec[key] = float(v)
            if self.tb is not None:
                self.tb.add_scalar(key, float(v), int(step))
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def log_audio(self, step: int, tag: str, audio, sample_rate: int = 16000):
        """An audio sample: TensorBoard's ``add_audio``, or, without a
        writer or when it raises, a WAV at
        ``<log_dir>/audio/step%08d_<tag with / as _>.wav``."""
        if self.tb is not None:
            try:
                self.tb.add_audio(tag, np.asarray(audio, np.float32).reshape(1, -1), int(step),
                                  sample_rate)
                return
            except Exception:
                pass
        from ..data.wavio import save_wav

        safe = tag.replace("/", "_")
        save_wav(self.log_dir / "audio" / f"step{int(step):08d}_{safe}.wav",
                 np.asarray(audio, np.float32), sample_rate)

    def flush(self):
        """Write what the TensorBoard writer holds (it writes on its own
        every 2 minutes and at ``close``)."""
        if self.tb is not None:
            self.tb.flush()

    def close(self):
        self._jsonl.close()
        if self.tb is not None:
            self.tb.close()


class Stopwatch:
    """Wall-clock steps and audio-seconds per second."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.audio_seconds = 0.0
        self.steps = 0

    def tick(self, audio_seconds: float = 0.0):
        self.audio_seconds += audio_seconds
        self.steps += 1

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def audio_seconds_per_second(self) -> float:
        e = self.elapsed
        return self.audio_seconds / e if e > 0 else 0.0

    @property
    def steps_per_second(self) -> float:
        e = self.elapsed
        return self.steps / e if e > 0 else 0.0
