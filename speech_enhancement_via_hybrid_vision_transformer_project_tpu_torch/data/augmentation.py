"""SpecAugment and random gain on the device (JAX ``data/augmentation.py``).

Per spectrogram of a ``[B, F, T]`` batch: ``freq_mask_num`` frequency bands
and ``time_mask_num`` time bands zeroed, each of a width drawn uniformly from
``[0, max_width]`` and a start uniformly from ``[0, max(size - width, 1))``,
then, with probability ``gain_prob``, a gain of ``U[lo, hi]`` dB. Only the
noisy model input is augmented.

The random draws (``draw_spec_augment``, from an explicit
``torch.Generator``) are apart from their application
(``apply_spec_augment``), so that a test can feed the JAX function's own
draws to the port: ``jax.random`` and ``torch.Generator`` give different
numbers from one seed. ``AudioAugmenter`` is the waveform-domain
augmenter (host numpy; off in the shipped config, and not on the train
step's path).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.audio import resample


@dataclass(frozen=True)
class SpecAugmentConfig:
    freq_mask_num: int = 2
    freq_mask_width: int = 15
    time_mask_num: int = 2
    time_mask_width: int = 30
    gain_prob: float = 0.5
    gain_db_range: tuple[float, float] = (-3.0, 3.0)
    enabled: bool = True
    gain_enabled: bool = True

    @classmethod
    def from_config(cls, config: dict) -> "SpecAugmentConfig":
        aug = config.get("data", {}).get("augmentation", {})
        sa = aug.get("spec_augment", {})
        rg = aug.get("random_gain", {})
        return cls(
            freq_mask_num=sa.get("freq_mask_num", 2),
            freq_mask_width=sa.get("freq_mask_width", 15),
            time_mask_num=sa.get("time_mask_num", 2),
            time_mask_width=sa.get("time_mask_width", 30),
            gain_prob=rg.get("probability", 0.5),
            gain_db_range=tuple(rg.get("gain_db_range", (-3.0, 3.0))),
            enabled=sa.get("enabled", True) and aug.get("enabled", True),
            gain_enabled=rg.get("enabled", True) and aug.get("enabled", True),
        )


class SpecAugmentDraws(NamedTuple):
    """The random numbers of one batch: band widths and starts ``[B, num]``
    (int64), gain on/off ``[B]`` (bool) and gain in dB ``[B]``."""

    freq_width: torch.Tensor
    freq_start: torch.Tensor
    time_width: torch.Tensor
    time_start: torch.Tensor
    gain_on: torch.Tensor
    gain_db: torch.Tensor


def _bands(b: int, num: int, size: int, max_width: int, g: torch.Generator):
    width = torch.randint(0, max_width + 1, (b, num), generator=g, device=g.device)
    hi = torch.clamp(size - width, min=1)
    start = torch.floor(torch.rand(b, num, generator=g, device=g.device) * hi).long()
    return width, torch.minimum(start, hi - 1)


def draw_spec_augment(batch: int, n_freq: int, n_time: int, cfg: SpecAugmentConfig,
                      generator: torch.Generator) -> SpecAugmentDraws:
    """Draw one batch's bands and gains on the generator's device."""
    fw, fs = _bands(batch, cfg.freq_mask_num, n_freq, cfg.freq_mask_width, generator)
    tw, ts = _bands(batch, cfg.time_mask_num, n_time, cfg.time_mask_width, generator)
    dev = generator.device
    on = torch.rand(batch, generator=generator, device=dev) < cfg.gain_prob
    lo, hi = cfg.gain_db_range
    db = lo + (hi - lo) * torch.rand(batch, generator=generator, device=dev)
    return SpecAugmentDraws(fw, fs, tw, ts, on, db)


def _band_mask(width: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """``[B, size]``: True inside any of the ``[B, num]`` bands."""
    idx = torch.arange(size, device=width.device)[None, None, :]
    s, w = start[..., None], width[..., None]
    return ((idx >= s) & (idx < s + w)).any(dim=1)


def apply_spec_augment(specs: torch.Tensor, draws: SpecAugmentDraws,
                       cfg: SpecAugmentConfig) -> torch.Tensor:
    """SpecAugment of ``specs [B, F, T]`` with the given draws."""
    _, f, t = specs.shape
    draws = SpecAugmentDraws(*(x.to(specs.device) for x in draws))
    out = specs
    if cfg.enabled:
        zero = (_band_mask(draws.freq_width, draws.freq_start, f)[:, :, None]
                | _band_mask(draws.time_width, draws.time_start, t)[:, None, :])
        out = out.masked_fill(zero, 0.0)
    if cfg.gain_enabled:
        gain = torch.where(draws.gain_on, 10.0 ** (draws.gain_db.float() / 20.0),
                           torch.ones_like(draws.gain_db, dtype=torch.float32))
        out = out * gain[:, None, None]
    return out.to(specs.dtype)


def spec_augment_batch(specs: torch.Tensor, cfg: SpecAugmentConfig,
                       generator: torch.Generator) -> torch.Tensor:
    """Draw and apply SpecAugment over ``[B, F, T]``."""
    b, f, t = specs.shape
    return apply_spec_augment(specs, draw_spec_augment(b, f, t, cfg, generator), cfg)


def spec_augment(spec: torch.Tensor, cfg: SpecAugmentConfig = SpecAugmentConfig(),
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[SpecAugmentDraws] = None) -> torch.Tensor:
    """SpecAugment of one spectrogram ``[F, T]``: the given ``draws`` (a
    batch of one), else draws from ``generator``."""
    if draws is None:
        if generator is None:
            raise ValueError("spec_augment needs a generator or draws")
        draws = draw_spec_augment(1, *spec.shape, cfg, generator)
    return apply_spec_augment(spec[None], draws, cfg)[0]


class SpectrogramAugmenter:
    """SpecAugment with the settings of a data config's ``augmentation``
    section (the JAX class; ``config`` is the ``data`` section)."""

    def __init__(self, config: Optional[dict] = None):
        self.cfg = SpecAugmentConfig.from_config({"data": config or {}})

    def augment(self, spec: torch.Tensor, generator: Optional[torch.Generator] = None,
                draws: Optional[SpecAugmentDraws] = None) -> torch.Tensor:
        return spec_augment(spec, self.cfg, generator, draws)

    def augment_batch(self, specs: torch.Tensor, generator: Optional[torch.Generator] = None,
                      draws: Optional[SpecAugmentDraws] = None) -> torch.Tensor:
        if draws is None:
            return spec_augment_batch(specs, self.cfg, generator)
        return apply_spec_augment(specs, draws, self.cfg)


class AudioAugmenter:
    """Waveform augmentations on the host (JAX ``AudioAugmenter``): a
    resample-based time stretch (duration and pitch change together), a
    pitch shift back to the input's length, and a comb-filter reverb.
    ``rng``: the explicit ``np.random.Generator`` of the caller's draws."""

    def __init__(self, sample_rate: int = 16000, rng: Optional[np.random.Generator] = None):
        self.sample_rate = sample_rate
        self.rng = rng or np.random.default_rng()

    def time_stretch(self, x: np.ndarray, rate: float) -> np.ndarray:
        return resample(x, int(self.sample_rate * rate), self.sample_rate).astype(np.float32)

    def pitch_shift(self, x: np.ndarray, n_steps: float) -> np.ndarray:
        factor = 2.0 ** (n_steps / 12.0)
        shifted = resample(x, int(self.sample_rate * factor), self.sample_rate)
        if len(shifted) >= len(x):
            return shifted[: len(x)].astype(np.float32)
        return np.pad(shifted, (0, len(x) - len(shifted))).astype(np.float32)

    def add_reverb(self, x: np.ndarray, delay_ms: float = 50.0, decay: float = 0.3) -> np.ndarray:
        d = int(self.sample_rate * delay_ms / 1000.0)
        out = x.copy().astype(np.float32)
        if d < len(x):
            out[d:] += decay * x[:-d]
        peak = np.max(np.abs(out))
        if peak > 1.0:
            out /= peak
        return out
