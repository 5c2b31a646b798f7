"""PyTorch port's STFT / iSTFT against the JAX package.

The port's plain versions (``ops/stft.py``) are held against the JAX matmul
path, and the wrappers of kernels K1/K3 (``ops/cuda_stft.py``, which take
their plain versions for CPU tensors) against the JAX Pallas kernels run in
interpret mode, as ``tests/test_stft.py`` runs them.

Tolerances: STFT 2e-4 absolute — sums of 512 fp32 products (|re| up to ~60
for unit-variance noise) taken in another order by two BLAS libraries; the
JAX tests' own bound is 2e-3. iSTFT 2e-5 absolute, the JAX tests' own bound.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops.pallas_stft import (
    pallas_istft,
    pallas_stft,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops.stft import (
    STFTConfig as JConfig,
    frame_signal as j_frame_signal,
    istft as j_istft,
    magphase as j_magphase,
    overlap_add as j_overlap_add,
    reconstruct as j_reconstruct,
    stft as j_stft,
)
T = importlib.import_module("speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft")
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.cuda_stft import (
    istft_polar,
    stft_mag,
)

torch.set_num_threads(2)

STFT_ATOL = 2e-4
ISTFT_ATOL = 2e-5
LENGTHS = [16000, 5123, 48000]  # one block, odd length, multi-block


def _signal(rng, length, batch=2):
    return rng.standard_normal((batch, length)).astype(np.float32)


@pytest.mark.parametrize("length", LENGTHS)
def test_stft_matches_jax(length, rng):
    x = _signal(rng, length)
    re, im = j_stft(jnp.asarray(x), JConfig(), method="matmul")
    tre, tim = T.stft(torch.from_numpy(x), T.STFTConfig())
    assert tre.shape == re.shape == (2, 257, JConfig().num_frames(length))
    np.testing.assert_allclose(tre.numpy(), np.asarray(re), atol=STFT_ATOL, rtol=0)
    np.testing.assert_allclose(tim.numpy(), np.asarray(im), atol=STFT_ATOL, rtol=0)


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("give_length", [True, False])
def test_istft_matches_jax(length, give_length, rng):
    x = _signal(rng, length)
    re, im = j_stft(jnp.asarray(x), JConfig())
    kw = {"length": length} if give_length else {}
    ref = np.asarray(j_istft(re, im, JConfig(), method="matmul", **kw))
    y = T.istft(torch.tensor(np.asarray(re)), torch.tensor(np.asarray(im)),
                T.STFTConfig(), **kw).numpy()
    assert y.shape == ref.shape
    np.testing.assert_allclose(y, ref, atol=ISTFT_ATOL, rtol=0)
    if give_length:
        np.testing.assert_allclose(y, x, atol=2e-3)  # the round trip


def test_istft_length_pads_with_zeros(rng):
    """``length`` past the overlap-added signal: zeros, as in JAX. (The
    samples just before, where the window sum is near zero, amplify rounding
    and are left out of the comparison.)"""
    x = _signal(rng, 4000)
    re, im = j_stft(jnp.asarray(x), JConfig())
    ref = np.asarray(j_istft(re, im, JConfig(), length=4500))
    y = T.istft(torch.tensor(np.asarray(re)), torch.tensor(np.asarray(im)),
                length=4500).numpy()
    assert y.shape == ref.shape == (2, 4500)
    np.testing.assert_allclose(y[:, :4000], ref[:, :4000], atol=ISTFT_ATOL, rtol=0)
    end = 512 + 31 * 128 - 256  # overlap-added samples after the center crop
    assert not ref[:, end:].any() and not y[:, end:].any()


@pytest.mark.parametrize("length", [16000, 5123])
def test_reconstruct_matches_jax(length, rng):
    x = _signal(rng, length)
    mag, phase = j_magphase(*j_stft(jnp.asarray(x), JConfig()))
    tmag, tphase = T.magphase(*T.stft(torch.from_numpy(x)))
    np.testing.assert_allclose(tmag.numpy(), np.asarray(mag), atol=STFT_ATOL, rtol=0)
    ref = np.asarray(j_reconstruct(mag, phase, JConfig(), length=length))
    y = T.reconstruct(torch.tensor(np.asarray(mag)), torch.tensor(np.asarray(phase)),
                      length=length).numpy()
    np.testing.assert_allclose(y, ref, atol=ISTFT_ATOL, rtol=0)


@pytest.mark.parametrize("hop", [128, 100])
def test_framing_and_overlap_add_match_jax(hop, rng):
    """Both the phase-split (hop | n_fft) and the general overlap-add."""
    x = _signal(rng, 3000)
    jc, tc = JConfig(hop_length=hop), T.STFTConfig(hop_length=hop)
    frames = np.asarray(j_frame_signal(jnp.asarray(x), jc))
    tframes = T.frame_signal(torch.from_numpy(x), tc)
    np.testing.assert_array_equal(tframes.numpy(), frames)
    ola = np.asarray(j_overlap_add(jnp.asarray(frames), jc))
    np.testing.assert_allclose(T.overlap_add(tframes, tc).numpy(), ola, atol=1e-5, rtol=0)
    re, im = j_stft(jnp.asarray(x), jc)
    tre, tim = T.stft(torch.from_numpy(x), tc)
    np.testing.assert_allclose(tre.numpy(), np.asarray(re), atol=STFT_ATOL, rtol=0)
    np.testing.assert_allclose(
        T.istft(tre, tim, tc, length=3000).numpy(),
        np.asarray(j_istft(re, im, jc, length=3000)), atol=ISTFT_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# Kernel wrappers (plain versions on the CPU) against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", LENGTHS)
def test_stft_mag_matches_pallas_stft(length, rng):
    x = _signal(rng, length)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_stft(jnp.asarray(x), JConfig(), return_mag=True)
    out = stft_mag(torch.from_numpy(x), T.STFTConfig())
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=STFT_ATOL, rtol=0)


@pytest.mark.parametrize("length", LENGTHS)
def test_istft_polar_matches_pallas_istft(length, rng):
    x = _signal(rng, length)
    mag, phase = j_magphase(*j_stft(jnp.asarray(x), JConfig()))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_istft(mag, phase, JConfig(), length=length, polar=True))
    y = istft_polar(torch.tensor(np.asarray(mag)), torch.tensor(np.asarray(phase)),
                    T.STFTConfig(), length=length).numpy()
    assert y.shape == ref.shape
    np.testing.assert_allclose(y, ref, atol=ISTFT_ATOL, rtol=0)


def test_istft_polar_no_length_matches_pallas_istft(rng):
    """Default trim (no ``length``) on a single-block input."""
    x = _signal(rng, 5123, batch=1)
    mag, phase = j_magphase(*j_stft(jnp.asarray(x), JConfig()))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_istft(mag, phase, JConfig(), polar=True))
    y = istft_polar(torch.tensor(np.asarray(mag)), torch.tensor(np.asarray(phase))).numpy()
    assert y.shape == ref.shape
    np.testing.assert_allclose(y, ref, atol=ISTFT_ATOL, rtol=0)


def test_istft_output_span_matches_jax_trim():
    """The crop/trim arithmetic K3 fuses, against the JAX istft's shapes."""
    cfg = T.STFTConfig()
    for n_frames in (1, 41, 384):
        re = jnp.zeros((257, n_frames))
        for length in (None, 1000, 60000):
            kw = {} if length is None else {"length": length}
            n_out = np.asarray(j_istft(re, re, JConfig(), **kw)).shape[-1]
            assert T.istft_output_span(cfg, n_frames, length) == (256, n_out)


# ---------------------------------------------------------------------------
# Center padding as jnp.pad pads: every mode name, short signals
# ---------------------------------------------------------------------------

PAD_LENGTHS = [1, 100, 256, 257, 9000]  # at most n_fft/2 samples, just over it, long
PAD_GEOMS = [(512, 128), (400, 100)]


@pytest.mark.parametrize("n_fft,hop", PAD_GEOMS)
@pytest.mark.parametrize("mode", T.PAD_MODES)
def test_center_padding_matches_jax(mode, n_fft, hop, rng):
    """Every numpy pad mode the JAX package takes, at lengths from 1 sample
    (which ``reflect`` pads by repeating its reflection, as numpy does) to
    9000: the frames as JAX's ``frame_signal`` cuts them, and the STFT."""
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft, pad_mode=mode)
    jc, tc = JConfig(**kw), T.STFTConfig(**kw)
    for length in PAD_LENGTHS:
        x = _signal(rng, length)
        frames = np.asarray(j_frame_signal(jnp.asarray(x), jc))
        tframes = T.frame_signal(torch.from_numpy(x), tc).numpy()
        assert tframes.shape == frames.shape == (2, tc.num_frames(length), n_fft)
        np.testing.assert_allclose(tframes, frames, atol=1e-6, rtol=0)
        re, im = (np.asarray(a) for a in j_stft(jnp.asarray(x), jc))
        tre, tim, tmag = stft_mag(torch.from_numpy(x), tc)  # its plain version on the CPU
        np.testing.assert_allclose(tre.numpy(), re, atol=STFT_ATOL, rtol=0)
        np.testing.assert_allclose(tim.numpy(), im, atol=STFT_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["replicate", "circular", "reflection"])
def test_pad_modes_numpy_lacks_are_refused(mode, rng):
    """PyTorch's names for ``edge`` and ``wrap`` are not numpy's: JAX refuses
    them, and so does the port, on the CPU and before a launch."""
    import contextlib

    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import kernels

    x = _signal(rng, 4000)
    with pytest.raises(NotImplementedError, match=mode):
        j_stft(jnp.asarray(x), JConfig(pad_mode=mode))
    with pytest.raises(ValueError, match=f"pad_mode '{mode}'"):
        T.stft(torch.from_numpy(x), T.STFTConfig(pad_mode=mode))
    with pytest.raises(ValueError, match=f"pad_mode '{mode}'"):
        stft_mag(torch.from_numpy(x), T.STFTConfig(pad_mode=mode))
    with contextlib.ExitStack() as stack:
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        mp.setattr(kernels, "uses_kernel", lambda t: True)
        mp.setattr(kernels, "launch", lambda *a: pytest.fail("launched"))
        with pytest.raises(ValueError, match=f"pad_mode '{mode}'"):
            stft_mag(torch.from_numpy(x), T.STFTConfig(pad_mode=mode))


@pytest.mark.parametrize("n_fft,hop", PAD_GEOMS)
def test_kernel_launch_pads_what_its_loads_do_not(n_fft, hop, monkeypatch, rng):
    """The CUDA impl of ``sevit::stft_mag`` on CPU tensors with the launch
    recorded: reflect on rows longer than n_fft/2 and zeros are the
    kernel's own loads (pad n_fft/2, the reflect flag); a shorter reflected
    row and numpy's other modes are padded first, as ``center_pad`` pads,
    and launched with pad 0. Whatever it launches, the kernel reads the
    padded row the plain version frames."""
    import contextlib

    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_stft,
        kernels,
    )

    calls = []
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "launch", lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda t: t)  # the launch sees the tensors
    half = n_fft // 2
    for mode in T.PAD_MODES:
        cfg = T.STFTConfig(n_fft=n_fft, hop_length=hop, win_length=n_fft, pad_mode=mode)
        for length in PAD_LENGTHS:
            x = torch.from_numpy(_signal(rng, length))
            calls.clear()
            cuda_stft._stft_cuda(x, *cuda_stft._cfg_args(cfg))
            ((name, a),) = calls
            assert name == "stft_mag"  # n_fft 512 and 400 are K1's
            row, b, n, pad, reflect = a[0], a[5], a[6], a[7], a[8]
            assert b == 2 and a[9] == cfg.num_frames(length)
            fused = mode == "constant" or (mode == "reflect" and length > half)
            assert (pad, n) == ((half, length) if fused else (0, length + 2 * half))
            assert reflect == int(mode == "reflect")
            if fused:
                assert row is x
            else:
                torch.testing.assert_close(row, T.center_pad(x, cfg), atol=0, rtol=0)
