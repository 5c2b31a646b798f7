"""The port's remaining DSP against the JAX package, on seeded numpy inputs:
``ops/audio.py`` (de-emphasis, SNR, mixing), the ``AudioPreprocessor``
methods and its directory pass, ``ops/resize.py``'s tap and nearest
resizes, the STFT's ``method=`` choices, ``spectrogram`` and Griffin-Lim.

Tolerances: the numpy functions are copies, so exactly equal; the tap resize
1e-6 (fp32 lerps in another order); STFT and iSTFT with ``method="fft"``
2e-4 (two FFT libraries' fp32 rounding on |re| up to ~60, as the matmul
STFT's test); the spectrogram's magnitude 2e-4 and its phase 2e-4 where the
magnitude is above 1e-3 of its largest (below, the angle of a near-zero bin
is rounding). Griffin-Lim against the JAX package with JAX's own initial
phase: 1e-5 of the output's peak after 0 and 1 rounds (measured 1.0e-6 and
1.7e-6), 5e-4 after 8 (measured 9.2e-5: each round's STFT and iSTFT round
in another order than XLA's, and the rescale carries it on).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.data.preprocessing import (
    AudioPreprocessor as JPreprocessor,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops import audio as JA
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops import resize as JR
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.preprocessing import (
    AudioPreprocessor,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import save_wav
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import audio as A
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import cuda_stft
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import resize as R

JS = importlib.import_module("speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops.stft")
S = importlib.import_module("speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft")

torch.set_num_threads(2)

SR = 16000


def _speechlike(rng, seconds=1.0, zeros=None):
    t = np.arange(int(SR * seconds)) / SR
    x = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 880 * t + 0.3)
         + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    if zeros is not None:
        x[zeros[0]:zeros[1]] = 0.0
    return x


# ---------------------------------------------------------------------------
# ops/audio.py and the preprocessor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coef", [0.97, 0.5])
def test_de_emphasis_inverts_pre_emphasis_as_jax(rng, coef):
    x = rng.standard_normal(3000).astype(np.float32)
    np.testing.assert_array_equal(A.de_emphasis(x, coef), JA.de_emphasis(x, coef))
    np.testing.assert_allclose(A.de_emphasis(A.pre_emphasis(x, coef), coef), x, atol=1e-5)


def test_compute_snr_db_as_jax(rng):
    clean = rng.standard_normal(4000).astype(np.float32)
    noisy = np.concatenate([clean, clean[:100]]) + 0.3 * rng.standard_normal(4100).astype(
        np.float32)  # longer than clean: the common length counts
    assert A.compute_snr_db(clean, noisy) == JA.compute_snr_db(clean, noisy)
    assert A.compute_snr_db(clean, clean) == float("inf")
    assert A.compute_snr_db(np.zeros(10), np.ones(10)) == float("-inf")


@pytest.mark.parametrize("noise_len", [1500, 4000, 9000])
@pytest.mark.parametrize("snr_db", [-5.0, 10.0])
def test_mix_at_snr_as_jax(rng, noise_len, snr_db):
    """Noise shorter than the clean clip is tiled, longer is cut at a start
    drawn from the generator: equal generators give equal mixes."""
    clean = rng.standard_normal(4000).astype(np.float32)
    noise = rng.standard_normal(noise_len).astype(np.float32)
    got = A.mix_at_snr(clean, noise, snr_db, np.random.default_rng(7))
    want = JA.mix_at_snr(clean, noise, snr_db, np.random.default_rng(7))
    np.testing.assert_array_equal(got, want)
    assert A.compute_snr_db(clean, got) == pytest.approx(snr_db, abs=0.5)
    np.testing.assert_array_equal(A.mix_at_snr(clean, np.zeros(100), 5.0), clean)


def test_preprocessor_methods_as_jax(rng):
    kw = dict(sample_rate=SR, apply_pre_emphasis=True, pre_emphasis_coef=0.9)
    ours, ref = AudioPreprocessor(**kw), JPreprocessor(**kw)
    x = _speechlike(rng, 0.5)
    noise = rng.standard_normal(9000).astype(np.float32)
    for name, args in (("pre_emphasis", (x,)), ("de_emphasis", (x,)),
                       ("de_emphasis", (x, 0.8)), ("resample", (x, 22050)),
                       ("resample", (x, 8000, 16000)),
                       ("compute_snr", (x, x + 0.1 * noise[: len(x)]))):
        np.testing.assert_array_equal(getattr(ours, name)(*args), getattr(ref, name)(*args))
    np.testing.assert_array_equal(
        ours.add_noise_at_snr(x, noise, 3.0, np.random.default_rng(1)),
        ref.add_noise_at_snr(x, noise, 3.0, np.random.default_rng(1)))


def test_process_directory_writes_the_same_files(rng, tmp_path):
    kw = dict(sample_rate=SR, apply_pre_emphasis=True, apply_vad=True, trim_silence=True,
              apply_compression=True)
    for i, seconds in enumerate((0.4, 0.9, 0.6)):
        x = _speechlike(rng, seconds)
        x[: SR // 10] *= 0.001  # a quiet lead-in for the VAD and the trim
        save_wav(tmp_path / "in" / f"f{i}.wav", x, SR if i else 22050)
    (tmp_path / "in" / "notes.txt").write_text("skipped")
    assert AudioPreprocessor(**kw).process_directory(tmp_path / "in", tmp_path / "port") == 3
    assert JPreprocessor(**kw).process_directory(tmp_path / "in", tmp_path / "jax") == 3
    for i in range(3):
        got = (tmp_path / "port" / f"f{i}.wav").read_bytes()
        assert got == (tmp_path / "jax" / f"f{i}.wav").read_bytes()


# ---------------------------------------------------------------------------
# ops/resize.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,out_hw", [((2, 3, 64, 40), (257, 40)),
                                          ((2, 3, 257, 40), (64, 97)),
                                          ((5, 1, 9), (1, 4)), ((7, 13), (20, 6))])
def test_resize_bilinear_taps_and_nearest_as_jax(rng, shape, out_hw):
    x = rng.standard_normal(shape).astype(np.float32)
    got = R.resize_bilinear_taps(torch.from_numpy(x), out_hw).numpy()
    want = np.asarray(JR.resize_bilinear_taps(jnp.asarray(x), out_hw))
    assert got.shape == want.shape == (*shape[:-2], *out_hw)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    dense = np.asarray(JR.resize_bilinear(jnp.asarray(x), out_hw))
    np.testing.assert_allclose(got, dense, atol=1e-6, rtol=0)
    got = R.resize_nearest(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_array_equal(got, np.asarray(JR.resize_nearest(jnp.asarray(x), out_hw)))


def test_resize_nearest_is_torch_nearest(rng):
    x = torch.from_numpy(rng.standard_normal((2, 3, 50, 31)).astype(np.float32))
    want = torch.nn.functional.interpolate(x, size=(77, 12), mode="nearest")
    assert torch.equal(R.resize_nearest(x, (77, 12)), want)


# ---------------------------------------------------------------------------
# ops/stft.py: method=, spectrogram, Griffin-Lim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (256, 100)])
def test_stft_and_istft_fft_as_jax(rng, n_fft, hop):
    x = rng.standard_normal((2, 5000)).astype(np.float32)
    cfg, jcfg = S.STFTConfig(n_fft=n_fft, hop_length=hop, win_length=n_fft), \
        JS.STFTConfig(n_fft=n_fft, hop_length=hop, win_length=n_fft)
    re, im = S.stft(torch.from_numpy(x), cfg, method="fft")
    jre, jim = JS.stft(jnp.asarray(x), jcfg, method="fft")
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), atol=2e-4, rtol=0)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), atol=2e-4, rtol=0)
    mre, mim = S.stft(torch.from_numpy(x), cfg)
    np.testing.assert_allclose(re.numpy(), mre.numpy(), atol=2e-4, rtol=0)
    y = S.istft(re, im, cfg, length=5000, method="fft")
    jy = JS.istft(jre, jim, jcfg, length=5000, method="fft")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-4, rtol=0)
    np.testing.assert_allclose(y.numpy(), x, atol=2e-4, rtol=0)
    with pytest.raises(ValueError, match="method"):
        S.stft(torch.from_numpy(x), cfg, method="dft")
    with pytest.raises(ValueError, match="method"):
        S.istft(re, im, cfg, method="dft")


@pytest.mark.parametrize("method", ["matmul", "fft", "auto"])
def test_spectrogram_as_jax(rng, method):
    x = _speechlike(rng, 0.7)
    mag, phase = S.spectrogram(torch.from_numpy(x), method=method)
    jmag, jphase = JS.spectrogram(jnp.asarray(x), JS.STFTConfig(),
                                  method="fft" if method == "fft" else "matmul")
    jmag, jphase = np.asarray(jmag), np.asarray(jphase)
    np.testing.assert_allclose(mag.numpy(), jmag, atol=2e-4, rtol=0)
    big = jmag > 1e-3 * jmag.max()
    dphase = np.angle(np.exp(1j * (phase.numpy()[big] - jphase[big])))  # wrapped
    assert np.abs(dphase).max() < 2e-4


def test_kernel_methods_run_the_plain_versions_on_the_cpu(rng):
    """``method="auto"``/``"pallas"`` name K1 and K3: on a CPU tensor their
    wrappers run the plain versions, which equal ``method="matmul"``, for
    leading dims too; nothing launches."""
    x = torch.from_numpy(rng.standard_normal((2, 3, 4000)).astype(np.float32))
    re, im = S.stft(x, method="matmul")
    mag, phase = S.magphase(re, im)
    for method in ("auto", "pallas"):
        kre, kim = S.stft(x, method=method)
        assert torch.equal(kre, re) and torch.equal(kim, im)
        want = S.reconstruct(mag, phase, length=4000)
        got = S.reconstruct(mag, phase, length=4000, method=method)
        assert got.shape == (2, 3, 4000)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        got = S.istft(re, im, length=4000, method=method)
        torch.testing.assert_close(got, S.istft(re, im, length=4000), atol=2e-5, rtol=0)
    one = x[0, 0]
    assert S.stft(one, method="auto")[0].shape == re.shape[2:]


@pytest.mark.parametrize("n_iter,limit", [(0, 1e-5), (1, 1e-5), (8, 5e-4)])
@pytest.mark.parametrize("clip", ["speech", "zero-run"])
def test_griffin_lim_as_jax(rng, n_iter, limit, clip):
    """With JAX's own initial phase (its default key 0), on a 1 s clip and on
    one with 0.3 s of exact digital silence: the plain version follows JAX's
    (re, im) rounds. Where the target magnitude is 0, both write 0."""
    zeros = (6000, 10800) if clip == "zero-run" else None
    x = _speechlike(rng, 1.0, zeros)
    jmag = JS.spectrogram(jnp.asarray(x), JS.STFTConfig())[0]
    mag = np.asarray(jmag)
    phase = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), mag.shape, minval=0.0,
                                          maxval=2.0 * np.pi))
    want = np.asarray(JS.griffin_lim(jmag, JS.STFTConfig(), n_iter=n_iter))
    got = S.griffin_lim(torch.from_numpy(mag.copy()), n_iter=n_iter,
                        phase=torch.from_numpy(phase.copy())).numpy()
    assert got.shape == want.shape == (S.implied_length(S.STFTConfig(), mag.shape[-1]),)
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= limit * peak
    if zeros is not None:  # frames wholly inside the run have magnitude 0
        assert np.abs(got[7000:9800]).max() <= limit * peak


def test_griffin_lim_polar_rounds_match_the_plain_rounds(rng):
    """The kernels' polar rounds (``cuda_stft.griffin_lim_polar``, here on
    CPU tensors, so through K1's and K3's plain versions) against the plain
    (re, im) rounds: 1e-6 of the peak after 1 round, 1e-4 after 16
    (measured 2.0e-7 and 1.0e-5 at 8 to 32 rounds). The zero-run clip shows
    the silence case: the polar form keeps ``mag`` at phase 0 where the
    spectrum is exactly 0, the plain rescale writes 0; ``mag`` is 0 there,
    so both give 0."""
    for zeros in (None, (6000, 10800)):
        x = _speechlike(rng, 1.0, zeros)
        mag = S.spectrogram(torch.from_numpy(x))[0][None]
        phase = S.draw_griffin_lim_phase(mag.shape, torch.Generator().manual_seed(3))
        for n_iter, limit in ((1, 1e-6), (16, 1e-4)):
            plain = S.griffin_lim_plain(mag, phase, n_iter=n_iter, length=len(x))
            polar = cuda_stft.griffin_lim_polar(mag, phase, n_iter=n_iter, length=len(x))
            assert polar.shape == plain.shape == (1, len(x))
            assert float((polar - plain).abs().max()) <= limit * float(plain.abs().max())


def test_griffin_lim_default_phase_is_seeded_and_convergence_falls(rng):
    x = _speechlike(rng, 0.5)
    mag = S.spectrogram(torch.from_numpy(x))[0]
    a = S.griffin_lim(mag, n_iter=2)
    b = S.griffin_lim(mag, n_iter=2, generator=torch.Generator().manual_seed(0))
    c = S.griffin_lim(mag, n_iter=2, phase=S.draw_griffin_lim_phase(
        mag.shape, torch.Generator().manual_seed(0)))
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, S.griffin_lim(mag, n_iter=2,
                                            generator=torch.Generator().manual_seed(1)))

    def convergence(y):
        return float(torch.linalg.norm(S.spectrogram(y)[0] - mag) / torch.linalg.norm(mag))

    assert convergence(S.griffin_lim(mag, n_iter=16)) < convergence(S.griffin_lim(mag, n_iter=1))
