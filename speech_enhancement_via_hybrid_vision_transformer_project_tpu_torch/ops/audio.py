"""Host-side waveform utilities in numpy (the JAX ``ops/audio.py``)."""

from __future__ import annotations

import numpy as np


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample with ``scipy.signal.resample_poly`` (librosa's
    ``resample`` on the host)."""
    if orig_sr == target_sr:
        return x.astype(np.float32)
    from scipy import signal

    g = np.gcd(int(orig_sr), int(target_sr))
    return signal.resample_poly(
        x.astype(np.float64), target_sr // g, orig_sr // g
    ).astype(np.float32)


# The host-side chain of ``data/preprocessing.py`` (the JAX ``ops/audio.py``'s
# numpy functions).


def peak_normalize(x: np.ndarray, target_level: float = 0.95):
    """Scale so max |x| == target_level; returns (normalized, peak)."""
    peak = float(np.max(np.abs(x))) if x.size else 0.0
    if peak > 0:
        return (x * (target_level / peak)).astype(np.float32), peak
    return x.astype(np.float32), peak


def rms_energy(x: np.ndarray, frame_length: int = 2048, hop_length: int = 512):
    """Framewise RMS energy."""
    n = max(1 + (len(x) - frame_length) // hop_length, 0)
    if n == 0:
        return np.sqrt(np.mean(x**2, keepdims=True)).astype(np.float32)
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    return np.sqrt(np.mean(x[idx] ** 2, axis=1)).astype(np.float32)


def pre_emphasis(x: np.ndarray, coef: float = 0.97) -> np.ndarray:
    """y[n] = x[n] - coef*x[n-1]."""
    return np.concatenate([x[:1], x[1:] - coef * x[:-1]]).astype(np.float32)


def de_emphasis(x: np.ndarray, coef: float = 0.97) -> np.ndarray:
    """The inverse IIR filter of ``pre_emphasis``: y[n] = x[n] + coef*y[n-1]
    (``scipy.signal.lfilter`` where scipy is installed)."""
    try:
        from scipy import signal
    except ImportError:
        y = np.empty(len(x), np.float64)
        acc = 0.0
        for i, v in enumerate(x):
            acc = v + coef * acc
            y[i] = acc
        return y.astype(np.float32)
    return signal.lfilter([1.0], [1.0, -coef], x).astype(np.float32)


def _trim(x: np.ndarray, keep: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    if keep.size == 0:
        return x
    return x[keep[0] * hop_length : min(keep[-1] * hop_length + frame_length, len(x))]


def trim_silence_db(x: np.ndarray, top_db: float = 30.0, frame_length: int = 2048,
                    hop_length: int = 512) -> np.ndarray:
    """Trim leading/trailing frames more than top_db below the peak RMS."""
    rms = rms_energy(x, frame_length, hop_length)
    ref = np.max(rms)
    if ref <= 0:
        return x
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
    return _trim(x, np.nonzero(db > -top_db)[0], frame_length, hop_length)


def energy_vad_trim(x: np.ndarray, threshold: float = 0.01, frame_length: int = 400,
                    hop_length: int = 160) -> np.ndarray:
    """Energy-threshold VAD trim."""
    rms = rms_energy(x, frame_length, hop_length)
    return _trim(x, np.nonzero(rms > threshold)[0], frame_length, hop_length)


def dynamic_range_compress(x: np.ndarray, threshold_db: float = -20.0,
                           ratio: float = 4.0) -> np.ndarray:
    """Static compressor above a dB threshold."""
    eps = 1e-10
    db = 20.0 * np.log10(np.maximum(np.abs(x), eps))
    comp_db = np.where(db > threshold_db, threshold_db + (db - threshold_db) / ratio, db)
    return (np.sign(x) * 10.0 ** (comp_db / 20.0) * (np.abs(x) > eps)).astype(np.float32)


def compute_snr_db(clean: np.ndarray, noisy: np.ndarray) -> float:
    """SNR of ``noisy`` with respect to ``clean`` over their common length."""
    n = min(len(clean), len(noisy))
    clean, noisy = clean[:n], noisy[:n]
    sp = float(np.sum(clean**2))
    npow = float(np.sum((noisy - clean) ** 2))
    if npow <= 0:
        return float("inf")
    return 10.0 * np.log10(sp / npow) if sp > 0 else float("-inf")


def mix_at_snr(clean: np.ndarray, noise: np.ndarray, snr_db: float,
               rng: np.random.Generator | None = None) -> np.ndarray:
    """Add ``noise`` to ``clean`` at ``snr_db``; the noise is tiled to the
    clean length, then a random window of it (drawn from ``rng``) is cut."""
    if rng is None:
        rng = np.random.default_rng()
    n = len(clean)
    if len(noise) < n:
        noise = np.tile(noise, int(np.ceil(n / len(noise))))
    if len(noise) > n:
        start = int(rng.integers(0, len(noise) - n + 1))
        noise = noise[start : start + n]
    cp = np.mean(clean**2)
    npow = np.mean(noise**2)
    if npow <= 0 or cp <= 0:
        return clean.astype(np.float32)
    scale = np.sqrt(cp / (npow * 10.0 ** (snr_db / 10.0)))
    return (clean + scale * noise).astype(np.float32)
