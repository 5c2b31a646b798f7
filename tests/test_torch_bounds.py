"""Behavioural bounds of the PyTorch port's enhancer (device cpu), the JAX
package's own bounds on the same committed fixtures:

* do no harm (JAX ``tests/test_do_no_harm.py``): the mask-head fixture
  ``tiny_denoiser_mask`` never degrades a clip at -5 to 20 dB input SNR by
  more than 1 dB SI-SDR, helps by more than 1 dB on average, and, a [0, 1]
  mask attenuating only, never outputs more than 1.05x the input's energy;
* streaming against exact mode (JAX ``tests/test_streaming_bound.py``) on
  ``tiny_denoiser``: interior relative RMS < 0.45, boundary < 0.50 and
  < 2.5x the interior, SI-SDR within 0.75 dB, and the fixture denoises.

The bounds are the JAX tests' own; the port's waveforms agree with the JAX
package's within 5e-5, far inside them.
"""

import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from synth_dataset import coloured_noise, speechlike  # noqa: E402

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops.audio import (  # noqa: E402
    mix_at_snr,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.evaluation.metrics import (  # noqa: E402
    si_sdr,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (  # noqa: E402
    AudioEnhancer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (  # noqa: E402
    HybridViT,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_model_weights,
    read_meta,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from fixtures.make_tiny_denoiser import TINY, make_pairs  # noqa: E402

torch.set_num_threads(2)

SR = 16000
FIXTURES = Path(__file__).parent / "fixtures"
CHUNK_S, OVERLAP_S = 1.0, 0.25


def _enhancer(name, buckets):
    path = FIXTURES / name
    model = load_model_weights(path, HybridViT(**TINY))
    return AudioEnhancer(model, read_meta(path)["config"], device="cpu", buckets=buckets,
                         mask_padding=True, blend=1.0)


@pytest.fixture(scope="module")
def mask_enhancer():
    enh = _enhancer("tiny_denoiser_mask", (64, 128, 256))
    assert enh.output_mode == "mask"
    return enh


@pytest.fixture(scope="module")
def stream_enhancer():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # magnitude head at blend 1.0, as JAX's
        return _enhancer("tiny_denoiser", (64, 128, 256, 384, 512))


@pytest.fixture(scope="module")
def streamed(stream_enhancer):
    """(clean, noisy, exact, streaming, bucketed) for 2 clips of 3 s."""
    cleans, noisies = make_pairs(2, 3.0, np.random.default_rng(7), snr_lo=2.0, snr_hi=8.0)
    return [(c, x, stream_enhancer.enhance(x, exact=True),
             stream_enhancer.enhance_streaming(x, chunk_seconds=CHUNK_S,
                                               overlap_seconds=OVERLAP_S),
             stream_enhancer.enhance(x))
            for c, x in zip(cleans, noisies)]


def test_mask_fixture_never_hurts_and_helps_on_average(mask_enhancer):
    rng = np.random.default_rng(11)
    gains = []
    for snr in (-5.0, 0.0, 5.0, 10.0, 15.0, 20.0):
        clean = speechlike(1.0, rng)
        noisy = np.asarray(mix_at_snr(clean, coloured_noise(len(clean), rng), snr), np.float32)
        gain = si_sdr(clean, mask_enhancer.enhance(noisy)) - si_sdr(clean, noisy)
        gains.append(gain)
        assert gain > -1.0, f"clip at {snr} dB input SNR degraded by {gain:.2f} dB"
    assert float(np.mean(gains)) > 1.0, f"per-clip gains {np.round(gains, 2)}"


def test_mask_fixture_attenuation_bound(mask_enhancer):
    x = np.random.default_rng(12).standard_normal(SR).astype(np.float32) * 0.3
    y = mask_enhancer.enhance(x)
    assert float(np.sum(y**2)) <= 1.05 * float(np.sum(x**2))


def _interior_mask(n):
    """True away from streaming chunk boundaries (2x overlap margin)."""
    chunk, ov = int(CHUNK_S * SR), int(OVERLAP_S * SR)
    mask = np.ones(n, bool)
    for s in range(chunk - ov, max(n - ov, 1), chunk - ov):
        mask[max(s - ov, 0): min(s + 2 * ov, n)] = False
    return mask


def _rel_rms(a, b, m):
    return float(np.sqrt(np.mean((a[m] - b[m]) ** 2)) / (np.sqrt(np.mean(b[m] ** 2)) + 1e-12))


def test_streaming_fixture_actually_denoises(streamed):
    gains = [si_sdr(c, y) - si_sdr(c, x) for c, x, _, _, y in streamed]
    assert np.mean(gains) > 0.5, f"fixture no longer denoises: {gains}"


def test_streaming_within_rms_bound_of_exact(streamed):
    for _, x, exact, stream, _ in streamed:
        assert len(stream) == len(exact) == len(x)
        m = _interior_mask(len(x))
        interior, boundary = _rel_rms(stream, exact, m), _rel_rms(stream, exact, ~m)
        assert interior < 0.45 and boundary < 0.50, (interior, boundary)
        assert boundary < 2.5 * max(interior, 0.02), (interior, boundary)


def test_streaming_si_sdr_matches_exact(streamed):
    for c, _, exact, stream, _ in streamed:
        delta = si_sdr(c, stream) - si_sdr(c, exact)
        assert abs(delta) < 0.75, f"streaming SI-SDR delta {delta:+.2f} dB"
