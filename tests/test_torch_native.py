"""The port's native C++ audio runtime (``native/``, built with the host
compiler at first use) against the JAX package's, and ``load_audio``'s
native path against both packages' numpy codec.

Tolerances, as the JAX package's own ``tests/test_native.py``: a decode
1e-7 (the same float arithmetic), the PCM16 write round trip 1e-4 (one
PCM16 step is 3.1e-5), the batch decoder 2e-4 against the source waveform
(PCM16 rounding), peak normalization and pre-emphasis 1e-6.
"""

import warnings

import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu import native as jnative
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.data.wavio import (
    load_audio as j_load_audio,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch import native
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data import wavio
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import audio as A

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def built():
    """Both runtimes, built (the port's from its own source)."""
    native.build()
    assert native.available() and jnative.available()
    assert native.library_path().parent.name == "torch_native"


def _write(tmp_path, name, x, sr=16000, subtype="pcm16"):
    p = tmp_path / name
    wavio.save_wav(p, x, sr, subtype=subtype)
    return p


@pytest.mark.parametrize("subtype", ["pcm16", "float32"])
def test_read_matches_jax_native_and_numpy(built, tmp_path, rng, subtype):
    x = rng.random(5000).astype(np.float32) * 1.6 - 0.8
    p = _write(tmp_path, f"a_{subtype}.wav", x, subtype=subtype)
    xn, srn = native.read_wav(p)
    xj, srj = jnative.read_wav(p)
    xp, srp = wavio.read_wav_raw(p)
    assert srn == srj == srp == 16000
    np.testing.assert_allclose(xn, xj, atol=1e-7, rtol=0)
    np.testing.assert_allclose(xn, xp, atol=1e-7, rtol=0)


def test_write_round_trip(built, tmp_path, rng):
    x = rng.random(3000).astype(np.float32) * 1.8 - 0.9
    native.write_wav(tmp_path / "port.wav", x, 16000)
    jnative.write_wav(tmp_path / "jax.wav", x, 16000)
    y, sr = wavio.load_audio(tmp_path / "port.wav", None, use_native=False)
    assert sr == 16000
    np.testing.assert_allclose(y, np.clip(x, -1, 1), atol=1e-4, rtol=0)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


@pytest.mark.parametrize("normalize", [False, True])
def test_decode_batch(built, tmp_path, rng, normalize):
    paths, wavs = [], []
    for i in range(5):
        x = np.clip(rng.standard_normal(2000 + 700 * i).astype(np.float32) * 0.4, -1, 1)
        paths.append(_write(tmp_path, f"b{i}.wav", x))
        wavs.append(x)
    paths.append(tmp_path / "missing.wav")  # an error row
    out, lengths, rates = native.decode_batch(paths, 4500, normalize=normalize, num_threads=3)
    ref = jnative.decode_batch(paths, 4500, normalize=normalize, num_threads=3)
    for a, b in zip((out, lengths, rates), ref):
        np.testing.assert_array_equal(a, b)
    assert out.shape == (6, 4500)
    for i, x in enumerate(wavs):
        n = min(len(x), 4500)
        assert lengths[i] == n and rates[i] == 16000
        if normalize:
            assert abs(np.abs(out[i, :n]).max() - 0.95) < 1e-3
        else:
            np.testing.assert_allclose(out[i, :n], x[:n], atol=2e-4, rtol=0)
        assert np.all(out[i, n:] == 0)
    assert lengths[5] == -1 and rates[5] == 0


def test_peak_normalize_and_pre_emphasis(built, rng):
    x = rng.standard_normal(4000).astype(np.float32) * 0.3
    ref, peak_ref = A.peak_normalize(x.copy(), 0.95)
    xn, xj = x.copy(), x.copy()
    peak = native.peak_normalize_inplace(xn, 0.95)
    assert peak == pytest.approx(jnative.peak_normalize_inplace(xj, 0.95), rel=1e-6)
    assert peak == pytest.approx(peak_ref, rel=1e-6)
    np.testing.assert_allclose(xn, xj, atol=1e-6, rtol=0)
    np.testing.assert_allclose(xn, ref, atol=1e-6, rtol=0)
    xn, xj = x.copy(), x.copy()
    native.pre_emphasis_inplace(xn, 0.97)
    jnative.pre_emphasis_inplace(xj, 0.97)
    np.testing.assert_allclose(xn, xj, atol=1e-6, rtol=0)
    np.testing.assert_allclose(xn, A.pre_emphasis(x, 0.97), atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        native.pre_emphasis_inplace(x.astype(np.float64))


@pytest.mark.parametrize("sr", [16000, 22050])
@pytest.mark.parametrize("use_native", [True, False])
def test_load_audio_equal_on_both_packages(built, tmp_path, rng, sr, use_native):
    """Mono loads at the file's rate and resampled to 16 kHz; stereo files
    decode through the native mixdown the same as numpy's."""
    x = rng.standard_normal((2500, 2)).astype(np.float32) * 0.3
    for name, wav in (("mono.wav", x[:, 0]), ("stereo.wav", x)):
        p = _write(tmp_path, name, wav, sr=sr)
        for target in (None, 16000):
            got, got_sr = wavio.load_audio(p, target, use_native=use_native)
            want, want_sr = j_load_audio(p, target, use_native=use_native)
            assert got_sr == want_sr and got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            plain, _ = wavio.load_audio(p, target, use_native=False)
            np.testing.assert_allclose(got, plain, atol=1e-7, rtol=0)


def test_failed_build_warns_once_and_falls_back(tmp_path, rng, monkeypatch):
    """A build that fails makes ``available()`` False with one warning that
    carries the compiler's message; ``load_audio`` then decodes in numpy."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "SOURCE", tmp_path / "broken.cpp")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    p = _write(tmp_path, "f.wav", rng.standard_normal(800).astype(np.float32) * 0.2)
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.build()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert not native.available()
        assert not native.available()
        got, _ = wavio.load_audio(p, None)
    assert len(caught) == 1 and "broken.cpp" in str(caught[0].message)
    np.testing.assert_array_equal(got, wavio.read_wav_raw(p)[0])
    with pytest.raises(RuntimeError, match="unavailable"):
        native.read_wav(p)


def test_port_native_reads_no_file_of_the_jax_package():
    src = native.SOURCE.read_text()
    init = (native.SOURCE.parent / "__init__.py").read_text()
    assert native.SOURCE.parent.parent.name.endswith("_torch")
    for text in (src, init):
        assert "project_tpu/" not in text and "Makefile" not in text
