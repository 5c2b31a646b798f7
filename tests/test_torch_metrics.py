"""PyTorch port's metrics and aggregation (``evaluation/metrics.py``,
``pesq_native.py``, ``Evaluator.aggregate*``) against the JAX package's.

The port's metric modules are copies of the JAX package's numpy code, with
the same resampler (``scipy.signal.resample_poly``), so every value must be
exactly equal: the same float64 operations in the same order, no
tolerance. The aggregates are the same numpy reductions over the same
rows, exactly equal too, nan rows excluded alike.
"""

import math

import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.evaluation import (
    Evaluator as JEvaluator,
    metrics as jm,
    pesq_native as jp,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.evaluation import (
    metrics as tm,
    pesq_native as tp,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.evaluation.evaluator import (
    Evaluator,
    default_metric_workers,
)

torch.set_num_threads(2)


def _triple(seed, sr, seconds=1.5):
    """Seeded (clean, noisy, enhanced): a harmonic tone with a syllable
    envelope, the same plus noise, and a partly denoised version."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = rng.uniform(110, 220)
    clean = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 5))
    clean = 0.3 * clean * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) / np.abs(clean).max()
    noise = rng.standard_normal(n)
    noisy = clean + 0.1 * noise
    enhanced = clean + 0.03 * noise + 0.01 * rng.standard_normal(n)
    return tuple(x.astype(np.float32) for x in (clean, noisy, enhanced))


def _same(a, b):
    return a == b or (math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("sr", [16000, 8000])
@pytest.mark.parametrize("name", ["si_sdr", "snr", "segmental_snr", "log_spectral_distance",
                                  "stoi"])
def test_metric_equals_jax(name, sr):
    clean, noisy, enh = _triple(1, sr)
    for est in (noisy, enh, clean):
        args = (clean, est, sr) if name == "stoi" else (clean, est)
        assert getattr(tm, name)(*args) == getattr(jm, name)(*args)


@pytest.mark.parametrize("sr,mode", [(16000, "wb"), (8000, "nb")])
def test_pesq_equals_jax(sr, mode):
    clean, noisy, enh = _triple(2, sr, seconds=2.0)
    for est in (noisy, enh):
        got = tp.pesq_p862(clean, est, sr, mode)
        assert got == jp.pesq_p862(clean, est, sr, mode) and 1.0 <= got <= 4.65
        assert _same(tm.pesq_score(clean, est, sr), jm.pesq_score(clean, est, sr))
    assert tm.pesq_implementation() == jm.pesq_implementation()
    assert tp.mos_lqo_map(2.5, mode) == jp.mos_lqo_map(2.5, mode)


@pytest.mark.parametrize("include_pesq", [True, False])
def test_compute_all_metrics_equals_jax(include_pesq):
    clean, noisy, enh = _triple(3, 16000)
    got = tm.compute_all_metrics(clean, enh, noisy, 16000, include_pesq=include_pesq)
    want = jm.compute_all_metrics(clean, enh, noisy, 16000, include_pesq=include_pesq)
    assert got.keys() == want.keys()
    assert {k for k in got if k.endswith("_improvement")} == {
        f"{k}_improvement" for k in ("si_sdr", "snr", "seg_snr", "lsd", "lsd_db", "stoi")
        + (("pesq",) if include_pesq else ())}
    assert all(_same(got[k], want[k]) for k in want)
    assert got["si_sdr_improvement"] > 0 and got["lsd_improvement"] > 0
    assert tm.metrics_task((clean, enh, noisy, 16000, include_pesq)) == got


def _per_file():
    """Per-file rows as the evaluator writes them, with a nan PESQ, a
    missing key, a nan input SNR and rows in every SNR bin."""
    rng = np.random.default_rng(5)
    rows = {}
    for i, s in enumerate((-7.0, -5.0, -1.0, 0.0, 3.0, 7.5, 9.9, 12.0, 15.0, 21.0, 4.0, 6.0)):
        rows[f"f{i}.wav"] = {
            "noisy_snr": s, "si_sdr": s + rng.normal(5, 2), "pesq": rng.uniform(1, 4),
            "stoi": rng.uniform(0.5, 1), "si_sdr_improvement": rng.normal(5, 2),
            "snr_improvement": rng.normal(4, 2), "stoi_improvement": rng.normal(0.05, 0.02),
            "lsd_improvement": rng.normal(0.3, 0.1),
        }
    rows["f3.wav"]["pesq"] = float("nan")
    rows["f4.wav"]["stoi_improvement"] = float("nan")
    del rows["f5.wav"]["lsd_improvement"]
    rows["f6.wav"]["noisy_snr"] = float("nan")
    return rows


def test_aggregates_equal_jax():
    rows = _per_file()
    got, want = Evaluator.aggregate(rows), JEvaluator.aggregate(rows)
    assert got == want and got["pesq"]["count"] == len(rows) - 1
    got_bins = Evaluator.aggregate_by_input_snr(rows)
    assert got_bins == JEvaluator.aggregate_by_input_snr(rows)
    assert sum(r["count"] for r in got_bins.values()) == len(rows) - 1
    assert got_bins["[0,5)dB"]["count"] == 3.0
    assert got_bins["[0,5)dB"]["stoi_improvement_count"] == 2.0
    results = {"summary": {**got, "_by_input_snr": got_bins,
                           "_meta": {"num_files": 12.0, "audio_seconds_per_second": 3.5}}}
    assert Evaluator.format_report(results) == JEvaluator.format_report(results)


def test_default_metric_workers_policy(monkeypatch):
    """max(1, min(8, cpu_count - 2)), as the CLI's help text says."""
    import os

    for cpus, want in ((None, 1), (1, 1), (3, 1), (4, 2), (10, 8), (64, 8)):
        monkeypatch.setattr(os, "cpu_count", lambda cpus=cpus: cpus)
        assert default_metric_workers() == want
