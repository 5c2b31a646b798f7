"""Host-side waveform preprocessing of the dataset (JAX
``data/preprocessing.py``): pre-emphasis -> VAD trim -> silence trim ->
compression -> peak normalization, each switched by the config. The
default config enables only peak normalization."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops import audio as A
from .wavio import load_audio, save_wav


class AudioPreprocessor:
    def __init__(
        self,
        sample_rate: int = 16000,
        apply_pre_emphasis: bool = False,
        pre_emphasis_coef: float = 0.97,
        apply_vad: bool = False,
        vad_threshold: float = 0.01,
        trim_silence: bool = False,
        trim_top_db: float = 30.0,
        normalize: bool = True,
        target_level: float = 0.95,
        apply_compression: bool = False,
        compression_threshold_db: float = -20.0,
        compression_ratio: float = 4.0,
    ):
        self.sample_rate = sample_rate
        self.apply_pre_emphasis = apply_pre_emphasis
        self.pre_emphasis_coef = pre_emphasis_coef
        self.apply_vad = apply_vad
        self.vad_threshold = vad_threshold
        self.trim_silence = trim_silence
        self.trim_top_db = trim_top_db
        self.normalize = normalize
        self.target_level = target_level
        self.apply_compression = apply_compression
        self.compression_threshold_db = compression_threshold_db
        self.compression_ratio = compression_ratio

    @classmethod
    def from_config(cls, config: dict) -> "AudioPreprocessor":
        d = config.get("data", config)
        p = d.get("preprocessing", {})
        return cls(
            sample_rate=d.get("sample_rate", 16000),
            apply_pre_emphasis=p.get("apply_pre_emphasis", False),
            pre_emphasis_coef=p.get("pre_emphasis_coef", 0.97),
            apply_vad=p.get("apply_vad", False),
            vad_threshold=p.get("vad_threshold", 0.01),
            trim_silence=p.get("trim_silence", False),
            normalize=d.get("normalize_audio", True),
        )

    def process(self, x: np.ndarray) -> np.ndarray:
        """Apply the configured chain."""
        x = np.asarray(x, dtype=np.float32)
        if self.apply_pre_emphasis:
            x = A.pre_emphasis(x, self.pre_emphasis_coef)
        if self.apply_vad:
            x = A.energy_vad_trim(x, self.vad_threshold)
        if self.trim_silence:
            x = A.trim_silence_db(x, self.trim_top_db)
        if self.apply_compression:
            x = A.dynamic_range_compress(x, self.compression_threshold_db, self.compression_ratio)
        if self.normalize:
            x, _ = A.peak_normalize(x, self.target_level)
        return x

    def pre_emphasis(self, x, coef=None):
        return A.pre_emphasis(x, coef if coef is not None else self.pre_emphasis_coef)

    def de_emphasis(self, x, coef=None):
        return A.de_emphasis(x, coef if coef is not None else self.pre_emphasis_coef)

    def resample(self, x, orig_sr, target_sr=None):
        return A.resample(x, orig_sr, target_sr or self.sample_rate)

    def add_noise_at_snr(self, clean, noise, snr_db, rng=None):
        return A.mix_at_snr(clean, noise, snr_db, rng)

    def compute_snr(self, clean, noisy):
        return A.compute_snr_db(clean, noisy)

    def process_file(self, in_path: str | Path, out_path: str | Path) -> None:
        """Load at ``sample_rate``, ``process``, write PCM16."""
        x, sr = load_audio(in_path, self.sample_rate)
        save_wav(out_path, self.process(x), sr)

    def process_directory(self, in_dir: str | Path, out_dir: str | Path,
                          pattern: str = "*.wav") -> int:
        """``process_file`` on each file of ``in_dir`` matching ``pattern``,
        in name order, into ``out_dir`` under the same name; returns the count."""
        in_dir, out_dir = Path(in_dir), Path(out_dir)
        count = 0
        for p in sorted(in_dir.glob(pattern)):
            self.process_file(p, out_dir / p.name)
            count += 1
        return count
