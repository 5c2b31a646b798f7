"""Native PESQ (ITU-T P.862 perceptual model) in pure numpy: the JAX
package's ``evaluation/pesq_native.py``, copied so that the port imports
nothing of that package.

The reference project evaluates with PESQ via the ``pesq`` package — a thin
binding over the ITU reference C code (reference: evaluation/metrics.py:16-55)
— and silently reports 0.0 when that package is missing. A typical eval host,
the CUDA machines included, has no ``pesq`` wheel, so this module provides a
first-party, dependency-free implementation of the published P.862 algorithm:

    level alignment -> input filtering -> time alignment ->
    Bark pitch-power densities -> partial frequency/gain equalization ->
    Zwicker loudness -> masked symmetric + asymmetric disturbances ->
    L6-over-L2 time aggregation -> raw MOS -> MOS-LQO mapping
    (P.862.1 narrowband / P.862.2 wideband logistic maps).

Fidelity statement (be honest with downstream consumers): this follows the
P.862 signal-processing structure and its published constants, but is NOT
bit-exact against the ITU reference implementation (whose conformance-tested
band/threshold tables and utterance-splitting time alignment are only defined
by the C code). Scores are deterministic, correctly ordered (less distortion
=> higher score), near-max for identical signals, and land in the standard
MOS-LQO range. When the ``pesq`` package IS installed,
``metrics.pesq_score`` prefers it and this module is never consulted.

Anchor validation (tests/test_metric_golden.py): identical inputs land on
the exact ITU MOS-LQO ceilings (4.644 wb / 4.549 nb, within 0.05), and the
raw->MOS-LQO logistic maps reproduce the published P.862.1/.2 values.
Mid-scale calibration (benchmarks/calibrate_pesq.py, round 4): the
disturbance gain ``_D_CAL`` is fitted against published wb-PESQ
MOS-vs-SNR behavior for additive white/speech-shaped noise; at the fit the
sweep deviates from the published anchors by 0.054 MOS mean / 0.12 MOS max
(see the ``_D_CAL`` comment for the protocol and residual table), and the
regression fixtures in tests/test_metric_golden.py pin the scale. The
round-4 corpus also covers the repo's own babble/hum noise families,
comb-filter reverb and hard clipping (monotonicity + range checks;
babble tracks approximate literature anchors within +0.22 MOS). Full conformance testing requires the
ITU test-vector corpus, which is not redistributable; scores from this
module therefore carry a ``pesq_impl: 'native'`` provenance marker in
Evaluator output and should be compared against ITU-scored results only
with that ~0.2-MOS uncertainty in mind.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-12

# -- raw-MOS -> MOS-LQO logistic mappings (published) -----------------------
# P.862.1 (narrowband):  y = 0.999 + 4.0   / (1 + exp(-1.4945 x + 4.6607))
# P.862.2 (wideband):    y = 0.999 + 4.0   / (1 + exp(-1.3669 x + 3.8224))
_NB_MAP = (1.4945, 4.6607)
_WB_MAP = (1.3669, 3.8224)

_TARGET_POWER = 1e7  # P.862 fixed level for the 350-3250 Hz band

# Calibration gain on the per-frame disturbances. The ITU tables (Sp/Sl and
# per-band widths) are approximated analytically above; this constant scales
# the resulting disturbances onto the published P.862.2 MOS-LQO scale. It
# cancels for identical inputs (disturbance ~ 0), so the 4.64 ceiling anchor
# is independent of it; every degraded score rides on it.
#
# Fitted (round 4; r3 fitted 10.0 on a narrower corpus) by
# benchmarks/calibrate_pesq.py: wb MOS-LQO swept over formant-synthesized
# speech + additive white/speech-shaped noise at SNR 0..40 dB and MNRU
# Q 10..35 dB, fitted against published wb-PESQ anchor points (literature
# AWGN curve ~1.25@0dB .. 4.0@40dB; the reference project's own published
# operating point wb-PESQ 1.97 on real mixed noise at ~9 dB SNR, reference
# README.md:308-313). Measured deviation at the fit
# (benchmarks/results/pesq_calibration.json): mean |residual| 0.054 MOS,
# max |residual| 0.12 MOS. The round-4 corpus additionally sweeps the
# repo's own babble + mains-hum noise families, comb-filter reverb and
# hard clipping: all strictly monotone in degradation strength, babble
# within +0.22 MOS of approximate literature anchors. tests/
# test_metric_golden.py pins (clean, degraded)->score fixtures so this
# scale cannot drift silently; re-fit with
# `python benchmarks/calibrate_pesq.py --fit` after any change to the
# perceptual model, then re-pin the fixtures from the same run.
_D_CAL = 11.0


def _bark(f: np.ndarray) -> np.ndarray:
    """Zwicker & Terhardt Hz->Bark warping."""
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(7.6e-4 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _abs_thresh_power(fc: np.ndarray) -> np.ndarray:
    """Absolute hearing threshold per band centre, as linear power on the
    internal intensity scale (Terhardt threshold-in-quiet approximation)."""
    f = np.maximum(np.asarray(fc, np.float64), 20.0)
    db = (
        3.64 * (f / 1000.0) ** -0.8
        - 6.5 * np.exp(-0.6 * (f / 1000.0 - 3.3) ** 2)
        + 1e-3 * (f / 1000.0) ** 4
    )
    db = np.clip(db, -20.0, 96.0)
    return 10.0 ** (db / 10.0)


class _Perceptual:
    """Frame/band layout + constant tables for one (sample_rate, mode)."""

    def __init__(self, sample_rate: int, mode: str):
        if sample_rate not in (8000, 16000):
            raise ValueError("PESQ is defined for 8 kHz and 16 kHz only")
        if mode not in ("nb", "wb"):
            raise ValueError(f"mode must be 'nb' or 'wb', got {mode!r}")
        if mode == "wb" and sample_rate == 8000:
            raise ValueError("wideband PESQ (P.862.2) requires 16 kHz input")
        self.sr = sample_rate
        self.mode = mode
        # 32 ms hann frames, 50% overlap (P.862 clause 10.2.2)
        self.frame = 512 if sample_rate == 16000 else 256
        self.hop = self.frame // 2
        self.window = 0.5 * (
            1.0 - np.cos(2.0 * np.pi * np.arange(self.frame) / self.frame)
        )
        freqs = np.fft.rfftfreq(self.frame, 1.0 / sample_rate)
        # Bark bands of width 0.5 Bark (P.862 uses 42 bands at 8 kHz /
        # 49 at 16 kHz over the same warping). Start at the first bin
        # above DC; wideband keeps the full band up to Nyquist.
        top_bark = _bark(np.array([sample_rate / 2.0]))[0]
        n_bands = 49 if sample_rate == 16000 else 42
        edges_bark = np.linspace(0.0, top_bark, n_bands + 1)
        bin_bark = _bark(freqs)
        self.band_of_bin = np.clip(
            np.searchsorted(edges_bark, bin_bark, side="right") - 1,
            0,
            n_bands - 1,
        )
        self.n_bands = n_bands
        # band centre frequencies (Hz) + band widths in Bark (all 0.5 here)
        centre_bark = 0.5 * (edges_bark[:-1] + edges_bark[1:])
        # invert the warping numerically on a dense grid
        grid = np.linspace(0.0, sample_rate / 2.0, 4096)
        self.centre_hz = np.interp(centre_bark, _bark(grid), grid)
        self.width_bark = np.diff(edges_bark)
        self.bins_per_band = np.maximum(
            np.bincount(self.band_of_bin, minlength=n_bands), 1
        )
        self.abs_thresh = _abs_thresh_power(self.centre_hz)
        # P.862 'Sp'-style scaling: normalize so that a full-scale calibrated
        # sine lands on the intensity scale the loudness law expects.
        self.power_scale = 1e4 / _TARGET_POWER
        self.zwicker = 0.23
        self.loud_scale = 0.5 * self.width_bark  # Sl * band width


def _active_band_power(x: np.ndarray, sr: int) -> float:
    """Mean power of the 350-3250 Hz band over the whole file, used for the
    P.862 fixed-level alignment."""
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(len(x), 1.0 / sr)
    band = (freqs >= 350.0) & (freqs <= 3250.0)
    # Parseval: mean power contribution of the band
    p = (np.abs(spec[band]) ** 2).sum() / max(len(x), 1) ** 2 * 2.0
    return float(p) + EPS


# Below this active-band power the signal is effectively digital silence;
# level alignment would amplify by ~1e9 and score silence-vs-silence near
# the MOS ceiling. Callers return nan instead (mirrors the too-short gate).
_SILENCE_POWER_FLOOR = 1e-10


def _level_align(x: np.ndarray, sr: int) -> np.ndarray:
    return x * np.sqrt(_TARGET_POWER / _active_band_power(x, sr))


def _highpass(x: np.ndarray, sr: int, fc: float = 100.0) -> np.ndarray:
    """2nd-order Butterworth high-pass (P.862.2 wideband input filter is a
    flat response with a ~100 Hz low cut; narrowband IRS is approximated by
    the same cut plus the band limit already present in 8 kHz material)."""
    w = np.tan(np.pi * fc / sr)
    k = 1.0 / (1.0 + np.sqrt(2.0) * w + w * w)
    b = np.array([k, -2.0 * k, k])
    a = np.array(
        [1.0, 2.0 * (w * w - 1.0) * k, (1.0 - np.sqrt(2.0) * w + w * w) * k]
    )
    try:
        from scipy.signal import lfilter

        return lfilter(b, a, x)
    except ImportError:  # pragma: no cover — scipy is in the image
        y = np.empty_like(x)
        z1 = z2 = 0.0
        for i in range(len(x)):  # 2 taps: direct form II transposed
            xi = x[i]
            yi = b[0] * xi + z1
            z1 = b[1] * xi - a[1] * yi + z2
            z2 = b[2] * xi - a[2] * yi
            y[i] = yi
        return y


_MAX_DELAY_S = 0.25  # P.862-style cap on the searched global delay


def _estimate_delay(ref: np.ndarray, deg: np.ndarray, sr: int) -> int:
    """Global delay estimate: cross-correlation of 4 ms frame-energy
    envelopes (P.862's crude alignment). The searched lag range is bounded
    to +/-250 ms and the peak must clearly beat the zero-lag correlation,
    so a spurious peak cannot silently trim a distorted region out of the
    comparison."""
    frame = sr // 250
    n = min(len(ref), len(deg)) // frame
    if n < 4:
        return 0
    re = np.log1p(
        np.sum(ref[: n * frame].reshape(n, frame) ** 2, axis=1)
    )
    de = np.log1p(
        np.sum(deg[: n * frame].reshape(n, frame) ** 2, axis=1)
    )
    re -= re.mean()
    de -= de.mean()
    try:
        from scipy.signal import fftconvolve

        corr = fftconvolve(de, re[::-1], mode="full")
    except ImportError:  # pragma: no cover — scipy is in the image
        corr = np.correlate(de, re, mode="full")
    lags = np.arange(len(corr)) - (n - 1)
    max_lag = max(1, int(_MAX_DELAY_S * sr) // frame)
    window = np.abs(lags) <= max_lag
    corr_w = np.where(window, corr, -np.inf)
    lag = int(lags[np.argmax(corr_w)])
    zero_lag = corr[n - 1]
    # accept only a decisive off-zero peak; ties/noise keep alignment as-is
    if corr_w.max() <= max(zero_lag, 0.0) * 1.05:
        return 0
    return lag * frame


def _frames_power(x: np.ndarray, pm: _Perceptual) -> np.ndarray:
    n = 1 + max(0, len(x) - pm.frame) // pm.hop
    idx = np.arange(n)[:, None] * pm.hop + np.arange(pm.frame)[None, :]
    spec = np.fft.rfft(x[idx] * pm.window, axis=1)
    return (spec.real**2 + spec.imag**2) * pm.power_scale


def _pitch_power_density(power: np.ndarray, pm: _Perceptual) -> np.ndarray:
    """Sum FFT-bin powers into Bark bands, normalized per band width."""
    bands = np.zeros((power.shape[0], pm.n_bands))
    np.add.at(bands.T, pm.band_of_bin, power.T)
    return bands / pm.bins_per_band


def _loudness(ppd: np.ndarray, pm: _Perceptual) -> np.ndarray:
    """Zwicker loudness density per band (P.862 clause 10.2.2.6):
    Sl * (t/0.5)^g * [(0.5 + 0.5 p/t)^g - 1] above threshold, 0 below."""
    t = pm.abs_thresh[None, :]
    g = pm.zwicker
    loud = (
        pm.loud_scale[None, :]
        * (t / 0.5) ** g
        * ((0.5 + 0.5 * ppd / t) ** g - 1.0)
    )
    return np.where(ppd > t, loud, 0.0)


def pesq_p862(
    reference: np.ndarray,
    degraded: np.ndarray,
    sample_rate: int = 16000,
    mode: str = "wb",
) -> float:
    """MOS-LQO in [1.0, ~4.64] for ``degraded`` against ``reference``.

    mode='wb' -> P.862.2 wideband (16 kHz); mode='nb' -> P.862.1 (8/16 kHz).
    """
    pm = _Perceptual(sample_rate, mode)
    ref = np.asarray(reference, np.float64)
    deg = np.asarray(degraded, np.float64)
    n = min(len(ref), len(deg))
    if n < pm.frame * 2:
        return float("nan")
    ref, deg = ref[:n].copy(), deg[:n].copy()

    ref = _highpass(ref, pm.sr)
    deg = _highpass(deg, pm.sr)
    if (
        _active_band_power(ref, pm.sr) < _SILENCE_POWER_FLOOR
        or _active_band_power(deg, pm.sr) < _SILENCE_POWER_FLOOR
    ):
        return float("nan")
    ref = _level_align(ref, pm.sr)
    deg = _level_align(deg, pm.sr)

    delay = _estimate_delay(ref, deg, pm.sr)
    if delay > 0:
        deg = deg[delay:]
    elif delay < 0:
        ref = ref[-delay:]
    n = min(len(ref), len(deg))
    if n < pm.frame * 2:
        return float("nan")
    ref, deg = ref[:n], deg[:n]

    ref_ppd = _pitch_power_density(_frames_power(ref, pm), pm)
    deg_ppd = _pitch_power_density(_frames_power(deg, pm), pm)
    n_frames = min(len(ref_ppd), len(deg_ppd))
    ref_ppd, deg_ppd = ref_ppd[:n_frames], deg_ppd[:n_frames]

    # speech-active frames: total band power well above threshold floor
    frame_pow = ref_ppd.sum(axis=1)
    active = frame_pow > 1e4 * pm.power_scale * pm.frame * 1e-2
    if not active.any():
        active = np.ones(n_frames, bool)

    # partial frequency-response equalization on the REFERENCE
    avg_ref = ref_ppd[active].mean(axis=0)
    avg_deg = deg_ppd[active].mean(axis=0)
    band_gain = np.clip((avg_deg + 1e3) / (avg_ref + 1e3), 0.01, 100.0)
    ref_eq = ref_ppd * band_gain[None, :]

    # short-term gain equalization on the DEGRADED (first-order smoothed)
    audible_ref = np.where(
        ref_eq > pm.abs_thresh[None, :], ref_eq, 0.0
    ).sum(axis=1)
    audible_deg = np.where(
        deg_ppd > pm.abs_thresh[None, :], deg_ppd, 0.0
    ).sum(axis=1)
    raw_gain = (audible_ref + 5e3 * pm.power_scale) / (
        audible_deg + 5e3 * pm.power_scale
    )
    # first-order smoother h_i = 0.8 h_{i-1} + 0.2 g_i, h_0 state = 1
    try:
        from scipy.signal import lfilter

        smooth = lfilter([0.2], [1.0, -0.8], raw_gain, zi=[0.8])[0]
    except ImportError:  # pragma: no cover — scipy is in the image
        smooth = np.empty(n_frames)
        h = 1.0
        for i in range(n_frames):
            h = 0.8 * h + 0.2 * raw_gain[i]
            smooth[i] = h
    smooth = np.clip(smooth, 3e-4, 5.0)
    deg_eq = deg_ppd * smooth[:, None]

    loud_ref = _loudness(ref_eq, pm)
    loud_deg = _loudness(deg_eq, pm)

    # masked symmetric disturbance magnitude (deadzone = 0.25 * min
    # loudness); only magnitudes are aggregated downstream
    d = loud_deg - loud_ref
    m = 0.25 * np.minimum(loud_deg, loud_ref)
    disturbance = np.maximum(np.abs(d) - m, 0.0)

    # asymmetry factor: additive (not merely reshaped) noise weighs more
    asym = ((deg_eq + 50.0 * pm.power_scale) / (ref_eq + 50.0 * pm.power_scale)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))
    asym_disturbance = disturbance * asym

    w = pm.width_bark[None, :]

    def _frame_norm(dist: np.ndarray, p: float) -> np.ndarray:
        return (np.sum((np.abs(dist) * w) ** p, axis=1) / w.sum()) ** (1.0 / p)

    d_sym = _frame_norm(disturbance, 2.0)
    d_asym = _frame_norm(asym_disturbance, 1.0)

    # weight frames by reference loudness (quiet frames count less)
    frame_loud = loud_ref.sum(axis=1)
    weight = ((frame_loud + 1e2) / 1e2) ** 0.04
    d_sym = np.minimum(_D_CAL * d_sym / weight, 45.0)
    d_asym = np.minimum(_D_CAL * d_asym / weight, 45.0)

    def _time_aggregate(dv: np.ndarray) -> float:
        # L6 over 320 ms split-second intervals, L2 over the utterance.
        # The frame hop is 16 ms at both rates (256/16k, 128/8k) -> 20 frames.
        # A final interval anchored at the clip end covers the remainder, so
        # the tail is never silently dropped (the ITU code overlaps here too).
        span = min(20, len(dv))
        starts = list(range(0, len(dv) - span + 1, span))
        if starts[-1] + span < len(dv):
            starts.append(len(dv) - span)
        ints = np.stack([dv[s : s + span] for s in starts])
        l6 = (np.mean(ints**6.0, axis=1)) ** (1.0 / 6.0)
        return float(np.sqrt(np.mean(l6**2.0)))

    d_total = _time_aggregate(d_sym)
    da_total = _time_aggregate(d_asym)

    raw = 4.5 - 0.1 * d_total - 0.0309 * da_total
    return mos_lqo_map(raw, mode)


def mos_lqo_map(raw: float, mode: str = "nb") -> float:
    """Published raw-P.862-score -> MOS-LQO logistic mapping
    (P.862.1 narrowband / P.862.2 wideband). Value-anchored in tests:
    raw 4.5 -> 4.5486 nb, the ITU ceiling for identical inputs."""
    a, b = _WB_MAP if mode == "wb" else _NB_MAP
    mos_lqo = 0.999 + 4.0 / (1.0 + np.exp(-a * raw + b))
    return float(np.clip(mos_lqo, 1.0, 5.0))
