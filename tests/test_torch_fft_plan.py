"""A numpy model of the FFT algorithm of kernels K1 and K3, on the CPU.

The CUDA kernels (``csrc/stft.cu``, ``csrc/istft.cu``, with the Stockham
stages of ``csrc/fft_stages.cuh``) run only on a card. This file repeats
their algorithm step by step in float32 numpy: the even/odd pack, the
mixed-radix Stockham stages of the host's radix plan (``fft_stages``), the
untangle (K1) or Hermitian pack (K3),
the window and, for K3, the gather overlap-add, reading the same fp32
table (``fft_plan``) that the wrappers hand to the kernels. The model is
held against the port's plain versions and the JAX package's ``ops/stft.py``.

Tolerance: 1e-5 of the largest magnitude (or output sample). An fp32 FFT of
n points rounds ~log2(n) times per value, a plain DFT sums n fp32 products:
both stay near 1e-6 of the largest value, so 1e-5 leaves a margin of ~10
without hiding an error in the algorithm (a wrong twiddle is off by O(1)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops.stft import (
    STFTConfig as JConfig,
    reconstruct as j_reconstruct,
    stft as j_stft,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import cuda_stft
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import (
    STFTConfig,
    istft_output_span,
    window_sumsquare_denominator,
)

REL_TOL = 1e-5
N_FFTS = [128, 512, 2048]
F32 = np.float32


@pytest.fixture(autouse=True)
def _two_threads():
    torch.set_num_threads(2)


def _cfgs(n_fft):
    kw = dict(n_fft=n_fft, hop_length=n_fft // 4, win_length=n_fft)
    return STFTConfig(**kw), JConfig(**kw)


def _tables(cfg):
    """Twiddles, untangle factors and window, as the kernels index them."""
    plan = cuda_stft.fft_plan(cfg)
    m = cfg.n_fft // 2
    assert plan.dtype == np.float32 and plan.shape == (3 * cfg.n_fft + 2,)
    return plan[: 2 * m].view(np.complex64), plan[2 * m : 4 * m + 2].view(np.complex64), plan[4 * m + 2 :]


def _dft4(a, b, c, d, inverse):
    apc, amc, bpd = a + c, a - c, b + d
    jb = (1j if inverse else -1j) * (b - d)
    return [apc + bpd, amc + jb, apc - bpd, amc - jb]


def _w(e, n, like):
    """exp(-2 pi i e / n) in the precision of ``like`` (its conjugate in
    the inverse is taken by the caller)."""
    return like.dtype.type(np.exp(-2j * np.pi * e / n))


def _dft(x, r, inverse):
    """The R-point DFT of one butterfly, as ``dft()`` computes it, in the
    precision of ``x``; outputs in natural order. R = 16 is 4 x 4 (n = 4 n1
    + n2, k = k1 + 4 k2), R = 8 is 4 x 2 (n = 2 n1 + n2, k = k1 + 4 k2), R = 5
    and R = 3 are direct with the fp32 (or float64) cos and sin of 2 pi/5,
    4 pi/5 and 2 pi/3."""
    mi = 1j if inverse else -1j  # -i forward, +i inverse
    real = x[0].real.dtype.type
    if r == 2:
        return [x[0] + x[1], x[0] - x[1]]
    if r == 3:
        a, b = x[1] + x[2], mi * (real(np.sin(2 * np.pi / 3)) * (x[1] - x[2]))
        m = x[0] - real(0.5) * a
        return [x[0] + a, m + b, m - b]
    if r == 4:
        return _dft4(*x, inverse)
    if r == 5:
        c1, c2 = real(np.cos(2 * np.pi / 5)), real(np.cos(4 * np.pi / 5))
        s1, s2 = real(np.sin(2 * np.pi / 5)), real(np.sin(4 * np.pi / 5))
        a1, b1, a2, b2 = x[1] + x[4], x[1] - x[4], x[2] + x[3], x[2] - x[3]
        m1, m2 = x[0] + c1 * a1 + c2 * a2, x[0] + c2 * a1 + c1 * a2
        n1, n2 = mi * (s1 * b1 + s2 * b2), mi * (s2 * b1 - s1 * b2)
        return [x[0] + (a1 + a2), m1 + n1, m2 + n2, m2 - n2, m1 - n1]
    conj = np.conj if inverse else (lambda w: w)
    if r == 8:
        a = [_dft4(x[n2], x[n2 + 2], x[n2 + 4], x[n2 + 6], inverse) for n2 in range(2)]
        a[1] = [a[1][k1] * conj(_w(k1, 8, x[0])) if k1 else a[1][k1] for k1 in range(4)]
        return [a[0][k % 4] + a[1][k % 4] if k < 4 else a[0][k % 4] - a[1][k % 4]
                for k in range(8)]
    a = [_dft4(x[n2], x[n2 + 4], x[n2 + 8], x[n2 + 12], inverse) for n2 in range(4)]  # a[n2][k1]
    a = [[a[n2][k1] * conj(_w(n2 * k1, 16, x[0])) if n2 * k1 else a[n2][k1] for k1 in range(4)]
         for n2 in range(4)]
    out = [_dft4(*(a[n2][k1] for n2 in range(4)), inverse) for k1 in range(4)]  # out[k1][k2]
    return [out[k % 4][k // 4] for k in range(16)]


def _stockham(z, tw, inverse, stages=None):
    """``fft_stages.cuh`` on ``z [..., M]``, unscaled, in the precision of
    ``z`` and ``tw``: one stage per radix of the host's plan
    (``cuda_stft.fft_stages``, or ``stages``), butterfly j = p s + q reading
    x[j + c M/R] and writing output c times W_M^{c p s} to y[q + s (R p +
    c)]."""
    m = z.shape[-1]
    stages = cuda_stft.fft_stages(m) if stages is None else stages
    w_tab = np.conj(tw) if inverse else tw
    x, s = z, 1
    for r in stages:
        nb = m // r
        j = np.arange(nb)
        p, q = j // s, j % s
        assert (p * (r - 1) * s < m).all()  # the twiddle index needs no modulo
        outs = _dft([x[..., j + c * nb] for c in range(r)], r, inverse)
        y = np.empty_like(x)
        for c, v in enumerate(outs):
            y[..., q + s * (r * p + c)] = v * w_tab[p * c * s] if c else v
        x, s = y, s * r
    assert s == m and x.dtype == z.dtype
    return x


def model_stft_mag(x, cfg):
    """K1 on ``x [B, L]``: ``(re, im, mag)``, each ``[B, F, N]``."""
    tw, ut, win = _tables(cfg)
    n_fft, hop, m_pts = cfg.n_fft, cfg.hop_length, cfg.n_fft // 2
    xp = np.pad(x, ((0, 0), (n_fft // 2, n_fft // 2)), mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(xp, n_fft, axis=-1)[:, ::hop] * win
    z = (frames[..., 0::2] + 1j * frames[..., 1::2]).astype(np.complex64)
    zz = _stockham(z, tw, inverse=False)
    k = np.arange(m_pts // 2 + 1)  # bins k and M - k from one pair
    zk, zm = zz[..., k], zz[..., (m_pts - k) % m_pts]
    er, ei = F32(0.5) * (zk.real + zm.real), F32(0.5) * (zk.imag - zm.imag)
    orr, oi = F32(0.5) * (zk.imag + zm.imag), F32(-0.5) * (zk.real - zm.real)
    w = ut[k]
    wr, wi = w.real * orr - w.imag * oi, w.real * oi + w.imag * orr  # W^k Fo
    re = np.empty(zz.shape[:-1] + (m_pts + 1,), np.float32)
    im = np.empty_like(re)
    re[..., m_pts - k], im[..., m_pts - k] = er - wr, wi - ei  # conj(Fe - W^k Fo)
    re[..., k], im[..., k] = er + wr, ei + wi  # Fe + W^k Fo (k = M/2 written last)
    out = (re, im, np.sqrt(re * re + im * im))
    assert all(o.dtype == np.float32 for o in out)
    return tuple(np.swapaxes(o, -1, -2) for o in out)


def model_istft_polar(mag, phase, cfg, length):
    """K3 on ``mag, phase [B, F, N]``: waveform ``[B, length]``."""
    tw, ut, win = _tables(cfg)
    n_fft, hop, m_pts = cfg.n_fft, cfg.hop_length, cfg.n_fft // 2
    mag, phase = np.swapaxes(mag, -1, -2), np.swapaxes(phase, -1, -2)  # [B, N, F]
    xr, xi = mag * np.cos(phase), mag * np.sin(phase)
    xi[..., [0, m_pts]] = 0  # irfft ignores the imaginary DC and Nyquist
    k = np.arange(m_pts)
    xkr, xki, xmr, xmi = xr[..., k], xi[..., k], xr[..., m_pts - k], xi[..., m_pts - k]
    er, ei = F32(0.5) * (xkr + xmr), F32(0.5) * (xki - xmi)
    dr, di = F32(0.5) * (xkr - xmr), F32(0.5) * (xki + xmi)
    w = ut[:m_pts]
    orr, oi = dr * w.real + di * w.imag, di * w.real - dr * w.imag
    zz = _stockham(((er - oi) + 1j * (ei + orr)).astype(np.complex64), tw, inverse=True)
    frames = np.stack([zz.real, zz.imag], axis=-1).reshape(*zz.shape[:-1], n_fft)
    n_frames, r = frames.shape[-2], n_fft // hop
    ola = np.zeros((frames.shape[0], n_frames - 1 + r, hop), np.float32)
    for p in range(r):  # the kernel's gather: phase p of frame f lands on hop f + p
        ola[:, p : p + n_frames] += frames[..., p * hop : (p + 1) * hop] * win[p * hop : (p + 1) * hop]
    ola = ola.reshape(frames.shape[0], -1)[:, : n_fft + (n_frames - 1) * hop]
    y = ola / (F32(m_pts) * window_sumsquare_denominator(cfg, n_frames))
    offset, n_out = istft_output_span(cfg, n_frames, length)
    assert y.dtype == np.float32 and offset + n_out <= y.shape[-1]
    return y[:, offset : offset + n_out]


@pytest.mark.parametrize("log2m", [2, 3, 6, 7, 8, 9, 10])
@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_stages_match_numpy_fft(log2m, inverse, rng):
    m_pts = 1 << log2m
    z = (rng.standard_normal((3, m_pts)) + 1j * rng.standard_normal((3, m_pts))).astype(np.complex64)
    tw = np.exp(-2j * np.pi * np.arange(m_pts) / m_pts).astype(np.complex64)
    got = _stockham(z, tw, inverse)
    ref = np.fft.ifft(z) * m_pts if inverse else np.fft.fft(z)
    assert np.abs(got - ref).max() < REL_TOL * np.abs(ref).max()


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_fft_plan_tables(n_fft):
    cfg, _ = _cfgs(n_fft)
    tw, ut, win = _tables(cfg)
    m = n_fft // 2
    np.testing.assert_allclose(tw, np.exp(-2j * np.pi * np.arange(m) / m), atol=1e-7)
    np.testing.assert_allclose(ut, np.exp(-2j * np.pi * np.arange(m + 1) / n_fft), atol=1e-7)
    np.testing.assert_array_equal(win, cfg.padded_window(np.float32))


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_stft_model_matches_plain_and_jax(n_fft, rng):
    cfg, jcfg = _cfgs(n_fft)
    x = rng.standard_normal((2, 3 * n_fft + 37)).astype(np.float32)
    got = model_stft_mag(x, cfg)
    plain = [t.numpy() for t in cuda_stft.stft_mag_plain(torch.from_numpy(x), cfg)]
    jre, jim = (np.asarray(a) for a in j_stft(jnp.asarray(x), jcfg))
    scale = np.abs(plain[2]).max()
    for g, p, j in zip(got, plain, (jre, jim, np.hypot(jre, jim))):
        assert g.shape == p.shape == j.shape
        assert np.abs(g - p).max() < REL_TOL * scale
        assert np.abs(g - j).max() < REL_TOL * scale


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_istft_model_matches_plain_and_jax(n_fft, rng):
    cfg, jcfg = _cfgs(n_fft)
    length = 3 * n_fft + 37
    x = rng.standard_normal((2, length)).astype(np.float32)
    _, _, mag = model_stft_mag(x, cfg)
    jre, jim = (np.asarray(a) for a in j_stft(jnp.asarray(x), jcfg))
    mag, phase = np.ascontiguousarray(mag), np.arctan2(jim, jre).astype(np.float32)
    got = model_istft_polar(mag, phase, cfg, length)
    plain = cuda_stft.istft_polar_plain(torch.from_numpy(mag), torch.from_numpy(phase), cfg,
                                        length=length).numpy()
    ref = np.asarray(j_reconstruct(jnp.asarray(mag), jnp.asarray(phase), jcfg, length=length))
    scale = np.abs(plain).max()
    assert got.shape == plain.shape == ref.shape == (2, length)
    assert np.abs(got - plain).max() < REL_TOL * scale
    assert np.abs(got - ref).max() < REL_TOL * scale
    np.testing.assert_allclose(got, x, atol=1e-4 * scale)  # the round trip


@pytest.mark.parametrize("n_fft,hop,inverse,match", [
    (500, 125, False, "multiple of 4"),  # n_fft/2 = 250 = 2 5^3 is taken, the hop is not
    (384, 96, True, None),  # n_fft/2 = 192 = 2^6 3: taken since the mixed radices
    (4096, 1024, False, r"not even in \[128, 2048\]"),
    (64, 16, True, r"not even in \[128, 2048\]"),
    (512, 130, False, "multiple of 4"),
    (512, 1024, False, "multiple of 4"),
    (512, 96, True, "divide"),
    (2048, 64, True, "shared memory"),
    (398, 100, False, "prime factor above 5"),  # n_fft/2 = 199
    (1920, 480, False, "320 butterflies"),  # 960 = 16 4 5 3: a radix-3 stage of 320
    (1500, 100, True, "375 butterflies"),  # 750 = 2 5^3 3: a radix-2 stage of 375
    (130, 20, False, "prime factor above 5"),  # n_fft/2 = 65 = 5 13
])
def test_kernel_sizes_are_checked(n_fft, hop, inverse, match):
    """What K1 and K3 refuse before a launch (``match``: the reason), or
    take (None)."""
    cfg = STFTConfig(n_fft=n_fft, hop_length=hop, win_length=min(n_fft, 512))
    if match is None:
        assert cuda_stft.kernel_tile(cfg, inverse=inverse) == 16
        return
    with pytest.raises(ValueError, match=match):
        cuda_stft.kernel_tile(cfg, inverse=inverse)


def test_kernel_tiles_of_the_repo_configs():
    """512/128 (``config/*.yaml``): 16 frames a block for both kernels; the
    forward transform takes a hop that does not divide n_fft."""
    assert cuda_stft.kernel_tile(STFTConfig(), inverse=False) == 16
    assert cuda_stft.kernel_tile(STFTConfig(), inverse=True) == 16
    assert cuda_stft.kernel_tile(STFTConfig(hop_length=96), inverse=False) == 16
    for n_fft in (128, 256, 1024, 2048):
        cfg = STFTConfig(n_fft=n_fft, hop_length=n_fft // 4, win_length=n_fft)
        tile = cuda_stft.kernel_tile(cfg, inverse=True)
        assert tile > 3 and cuda_stft._smem_bytes(cfg, tile, True) <= 227 * 1024


def test_wrappers_check_sizes_before_a_launch(monkeypatch):
    """A CUDA-typed call checks its sizes before it reaches a kernel: the
    dispatch is forced to the kernel path on CPU tensors, so the checks run
    without a card. A signal too short for one reflection, once refused,
    is padded as ``jnp.pad`` pads it. n_fft 500 (250 = 2 5^3) goes to K1 and,
    with a hop that does not divide it, to K3g; zero padding to K1: the CUDA
    impls, with the launch recorded, launch those."""
    import contextlib

    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "uses_kernel", lambda t: True)
    launched = []
    monkeypatch.setattr(kernels, "launch", lambda name, *a: launched.append(name))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    assert cuda_stft.stft_mag(torch.zeros(1, 256), STFTConfig())[0].shape == (1, 257, 3)
    odd = STFTConfig(n_fft=500, hop_length=124, win_length=500)
    zero_pad = STFTConfig(pad_mode="constant")
    x, m = torch.zeros(1, 4000), torch.zeros(1, 251, 30)
    assert cuda_stft.stft_mag(x, odd)[0].shape == (1, 251, odd.num_frames(4000))
    assert cuda_stft.istft_polar(m, m, odd).shape == (1, 29 * 124)
    assert cuda_stft.stft_mag(x, zero_pad)[0].shape == (1, 257, zero_pad.num_frames(4000))
    assert launched == []  # the ops on CPU tensors run the plain versions
    cuda_stft._stft_cuda(x, *cuda_stft._cfg_args(odd))
    cuda_stft._istft_cuda(m, m, *cuda_stft._cfg_args(odd), None)
    cuda_stft._stft_cuda(x, *cuda_stft._cfg_args(zero_pad))
    assert launched == ["stft_mag", "istft_dft", "stft_mag"]
    assert [cuda_stft.route(c, inverse=i)[0] for c in (odd, zero_pad) for i in (False, True)] == [
        "stft_mag", "istft_dft", "stft_mag", "istft_polar"]
