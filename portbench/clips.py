"""The one generator of inputs: speech-like PCM16 clips, their lengths and
their arrival times, from a seed and a traffic file's parameters.

Every seed gets the same multiset of lengths and of gaps between arrivals
(stratified quantiles of the stated distributions), in its own order and
with its own content, so that a seed changes what is computed and not how
much. numpy only: the HTTP client process imports this and no torch.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

SAMPLE_RATE = 16000


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent numpy stream of ``seed`` for one purpose."""
    return np.random.default_rng([int(seed), *stream.encode()])


def lognormal_lengths(n: int, median_s: float, sigma: float, min_s: float,
                      max_s: float) -> np.ndarray:
    """``n`` lengths in samples at the stratified quantiles of a log-normal
    of ``median_s`` and ``sigma``, truncated to ``[min_s, max_s]``."""
    dist = NormalDist(math.log(median_s), sigma)
    lo, hi = dist.cdf(math.log(min_s)), dist.cdf(math.log(max_s))
    u = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    seconds = np.exp([dist.inv_cdf(float(x)) for x in u])
    return np.round(seconds * SAMPLE_RATE).astype(np.int64)


def uniform_lengths(n: int, min_s: float, max_s: float) -> np.ndarray:
    """``n`` lengths in samples evenly spread over ``[min_s, max_s]``."""
    return np.round(np.linspace(min_s, max_s, n) * SAMPLE_RATE).astype(np.int64)


def lengths_for(params: dict, n: int) -> np.ndarray:
    """The lengths a traffic file's ``lengths`` entry asks for."""
    spec = params["lengths"]
    if spec["kind"] == "lognormal":
        return lognormal_lengths(n, spec["median_s"], spec["sigma"], spec["min_s"],
                                 spec["max_s"])
    if spec["kind"] == "uniform":
        return uniform_lengths(n, spec["min_s"], spec["max_s"])
    raise ValueError(f"unknown length distribution {spec['kind']!r}")


def poisson_offsets(rate: float, seconds: float, seed: int, stream: str = "") -> np.ndarray:
    """Arrival offsets (s) of an open loop at ``rate`` a second over
    ``seconds``: ``rate * seconds`` exponential gaps at stratified
    quantiles, in the seed's order."""
    n = max(1, int(round(rate * seconds)))
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    return np.cumsum(rng(seed, "arrivals" + stream).permutation(gaps))


def speech_like(g: np.random.Generator, n: int) -> tuple[np.ndarray, np.ndarray]:
    """``(noisy, clean)`` float32 waveforms of ``n`` samples: a voiced
    harmonic series with a slow pitch glide under a syllable envelope, and
    that plus white noise at 0-15 dB SNR, peak 0.1-0.9."""
    t = np.arange(n, dtype=np.float32) / SAMPLE_RATE
    f0 = g.uniform(90.0, 250.0) * (1.0 + 0.1 * np.sin(2 * np.pi * g.uniform(0.2, 1.0) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    clean = np.zeros(n, np.float32)
    for k in range(1, 6):
        clean += (0.6 ** k) * np.sin(k * phase + g.uniform(0, 2 * np.pi)).astype(np.float32)
    clean *= np.abs(np.sin(2 * np.pi * g.uniform(2.0, 5.0) * t + g.uniform(0, np.pi))) ** 1.5
    snr_db = g.uniform(0.0, 15.0)
    p = float(np.mean(clean * clean)) + 1e-12
    noisy = clean + math.sqrt(p / 10 ** (snr_db / 10)) * g.standard_normal(n).astype(np.float32)
    peak = g.uniform(0.1, 0.9) / max(float(np.abs(noisy).max()), 1e-6)
    return (noisy * peak).astype(np.float32), (clean * peak).astype(np.float32)


def pcm16(x: np.ndarray) -> np.ndarray:
    return np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)


def clip_pool(seed: int, lengths: np.ndarray, stream: str = "clips") -> list[np.ndarray]:
    """One noisy PCM16 clip per length, in the seed's order of the lengths."""
    g = rng(seed, stream)
    order = g.permutation(len(lengths))
    return [pcm16(speech_like(g, int(lengths[i]))[0]) for i in order]


def pair_pool(seed: int, lengths: np.ndarray, stream: str = "pairs") -> list[tuple]:
    """``(noisy, clean)`` PCM16 pairs, one per length, in the seed's order."""
    g = rng(seed, stream)
    order = g.permutation(len(lengths))
    out = []
    for i in order:
        noisy, clean = speech_like(g, int(lengths[i]))
        out.append((pcm16(noisy), pcm16(clean)))
    return out


def to_float(x: np.ndarray) -> np.ndarray:
    """PCM16 as the port's WAV reader gives it: x / 32768."""
    return x.astype(np.float32) / 32768.0
