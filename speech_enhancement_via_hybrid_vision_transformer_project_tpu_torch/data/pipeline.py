"""Featurization in the train step: padded waveform batch -> normalized
spectrogram batch (JAX ``data/pipeline.py``).

On a CUDA device both STFTs (noisy and clean) run through kernel K1, or K1g
at a geometry K1 does not take (``ops/cuda_stft.stft_mag``), two launches a
step; on the CPU its plain version. Then phase, per-utterance min-max over the utterance's own frames,
and SpecAugment of the noisy input. No gradient flows through this.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.cuda_stft import stft_mag
from ..ops.stft import STFTConfig
from .augmentation import SpecAugmentConfig, spec_augment_batch


class FeaturizedBatch(NamedTuple):
    noisy_spec: torch.Tensor  # [B, F, T, 1] normalized magnitudes
    clean_spec: torch.Tensor  # [B, F, T, 1]
    noisy_phase: torch.Tensor  # [B, F, T]
    frame_mask: torch.Tensor  # [B, T] True on frames from real audio
    noisy_min: torch.Tensor  # [B]
    noisy_max: torch.Tensor  # [B]
    clean_min: torch.Tensor  # [B]
    clean_max: torch.Tensor  # [B]
    # the mask head's pair: both raw magnitudes on the noisy max's scale,
    # un-augmented (the mask multiplies the physical mixture)
    noisy_over_max: torch.Tensor  # [B, F, T]
    clean_over_max: torch.Tensor  # [B, F, T]


def int16_to_float(x: torch.Tensor) -> torch.Tensor:
    """PCM16 loader batches -> the float path's exact values; float input
    passes through as float32."""
    if x.dtype == torch.int16:
        return x.to(torch.float32) * (1.0 / 32768.0)
    return x.to(torch.float32)


def minmax_normalize(mag: torch.Tensor, frame_mask: Optional[torch.Tensor] = None):
    """Per-utterance min-max of ``mag [B, F, T]`` to [0, 1] over the valid
    frames; returns ``(normed, min, max)``."""
    if frame_mask is None:
        mn = mag.amin(dim=(1, 2))
        mx = mag.amax(dim=(1, 2))
    else:
        m = frame_mask[:, None, :]
        big = torch.finfo(torch.float32).max
        mn = torch.where(m, mag, big).amin(dim=(1, 2))
        mx = torch.where(m, mag, -big).amax(dim=(1, 2))
    denom = torch.clamp(mx - mn, min=1e-8)
    normed = (mag - mn[:, None, None]) / denom[:, None, None]
    if frame_mask is not None:
        normed = torch.where(frame_mask[:, None, :], normed, 0.0)
    return normed, mn, mx


@torch.no_grad()
def featurize_batch(
    noisy_audio: torch.Tensor,
    clean_audio: torch.Tensor,
    lengths: torch.Tensor,
    stft_config: STFTConfig = STFTConfig(),
    *,
    augment_config: SpecAugmentConfig = SpecAugmentConfig(),
    augment_generator: Optional[torch.Generator] = None,
) -> FeaturizedBatch:
    """Waveforms ``[B, L]`` (float or int16) and lengths -> the model's
    inputs and targets; min/max over each utterance's own frames, and
    SpecAugment drawn from ``augment_generator`` when one is given."""
    noisy = int16_to_float(noisy_audio).contiguous()
    clean = int16_to_float(clean_audio).contiguous()
    re_n, im_n, noisy_mag = stft_mag(noisy, stft_config)
    clean_mag = stft_mag(clean, stft_config)[2]
    noisy_phase = torch.atan2(im_n, re_n)

    t = noisy_mag.shape[-1]
    n_valid = 1 + lengths.to(noisy_mag.device) // stft_config.hop_length
    frame_mask = torch.arange(t, device=noisy_mag.device)[None, :] < n_valid[:, None]

    noisy_n, n_min, n_max = minmax_normalize(noisy_mag, frame_mask)
    clean_n, c_min, c_max = minmax_normalize(clean_mag, frame_mask)
    if augment_generator is not None:
        noisy_n = spec_augment_batch(noisy_n, augment_config, augment_generator)

    inv_nmax = 1.0 / torch.clamp(n_max, min=1e-8)[:, None, None]
    return FeaturizedBatch(
        noisy_spec=noisy_n[..., None],
        clean_spec=clean_n[..., None],
        noisy_phase=noisy_phase,
        frame_mask=frame_mask,
        noisy_min=n_min,
        noisy_max=n_max,
        clean_min=c_min,
        clean_max=c_max,
        noisy_over_max=noisy_mag * inv_nmax,
        clean_over_max=clean_mag * inv_nmax,
    )
