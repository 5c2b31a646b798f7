"""The port's waveform ``AudioAugmenter`` and ``get_data_loader`` against
the JAX package's on the CPU: host numpy and scipy in both, so equal.

The augmenter's time stretch and pitch shift (through ``ops.audio.resample``)
and comb-filter reverb, each on the same input with the same
``np.random.Generator``; the loader factory's batches from the same files
and seed (the data of ``test_torch_loader.py``), exported under the JAX
package's names.
"""

import numpy as np
import pytest

from speech_enhancement_via_hybrid_vision_transformer_project_tpu import data as jdata
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch import data
from test_torch_loader import data_root  # noqa: F401


def _augmenters(seed: int):
    return (data.AudioAugmenter(16000, rng=np.random.default_rng(seed)),
            jdata.AudioAugmenter(16000, rng=np.random.default_rng(seed)))


@pytest.fixture
def clip(rng):
    t = np.arange(7001) / 16000
    return (0.6 * np.sin(2 * np.pi * 230 * t) + 0.1 * rng.standard_normal(len(t))).astype(
        np.float32)


@pytest.mark.parametrize("rate", [0.9, 1.1, 1.5])
def test_time_stretch_matches_jax(rate, clip):
    ours, ref = _augmenters(0)
    got, want = ours.time_stretch(clip, rate), ref.time_stretch(clip, rate)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_steps", [-3.0, 2.0, 0.5])
def test_pitch_shift_matches_jax(n_steps, clip):
    ours, ref = _augmenters(0)
    got = ours.pitch_shift(clip, n_steps)
    assert got.shape == clip.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref.pitch_shift(clip, n_steps))


@pytest.mark.parametrize("delay_ms,decay", [(50.0, 0.3), (10.0, 0.9), (500.0, 0.3)])
def test_add_reverb_matches_jax(delay_ms, decay, clip):
    ours, ref = _augmenters(0)
    got = ours.add_reverb(clip, delay_ms, decay)
    np.testing.assert_array_equal(got, ref.add_reverb(clip, delay_ms, decay))
    assert np.abs(got).max() <= 1.0 and not np.shares_memory(got, clip)


def test_augmenter_keeps_the_callers_generator():
    g = np.random.default_rng(4)
    assert data.AudioAugmenter(rng=g).rng is g
    assert isinstance(data.AudioAugmenter().rng, np.random.Generator)


@pytest.mark.parametrize("shuffle", [True, False])
def test_get_data_loader_matches_jax(shuffle, data_root):  # noqa: F811
    kw = dict(batch_size=3, shuffle=shuffle, num_workers=2, seed=5, buckets=(32, 128, 256),
              transfer_dtype="int16")
    ours = data.get_data_loader(data.VoiceBankDataset(data_root, "train"), **kw)
    ref = jdata.get_data_loader(jdata.VoiceBankDataset(data_root, "train"), **kw)
    assert isinstance(ours, data.DataLoader) and len(ours) == len(ref)
    got, want = list(ours), list(ref)
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
