"""The mixed-radix plan of K1's and K3's FFT, on the CPU.

K1 and K3 (``csrc/stft.cu``, ``csrc/istft.cu``) run a Stockham FFT of
M = n_fft/2 points whose stages follow a radix plan made on the host
(``cuda_stft.fft_stages``, packed by ``pack_radices``) from the butterflies
of ``csrc/fft_stages.cuh`` (radix 16, 8, 4, 2, 5 and 3). The kernels run only
on a card; this file holds, with the numpy model of ``test_torch_fft_plan.py``
(which indexes every stage as the kernel does):

- the plan of every M the route admits, and the model of its schedule in
  float64 against ``np.fft.fft``, forward and inverse;
- each butterfly alone, in fp32, against numpy's DFT;
- K1's untangle and K3's Hermitian pack at CMGAN's 400/100, the 320/160
  front end and 384/96 (a radix-3 stage), which K1 and K3 now take, and
  K1's at 450/100 (odd M), against the port's plain versions and
  the JAX package;
- the sources: the plan's bit width, the radices the stage switch takes, the
  block's threads and the butterflies' constants are the ones the host plans
  with, and each C entry checks the plan it is given.

Tolerances: the float64 model 1e-12 of the largest output (an FFT of at most
1024 points rounds ~log2 M times per value at 2^-53); an fp32 butterfly 1e-6
of its largest output; K1's and K3's fp32 models as ``test_torch_fft_plan.py``
(1e-5 of the largest value).
"""

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops.stft import (
    STFTConfig as JConfig,
    reconstruct as j_reconstruct,
    stft as j_stft,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
    cuda_stft,
    kernels,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import (
    STFTConfig,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fft_plan import (  # noqa: E402
    _dft,
    _stockham,
    model_istft_polar,
    model_stft_mag,
)

REL_TOL = 1e-5


def _admitted_m() -> list[int]:
    """Every M = n_fft/2 whose n_fft K1 takes at some hop."""
    lo, hi = cuda_stft.FFT_N_FFT
    return [n // 2 for n in range(lo, hi + 1, 2)
            if cuda_stft.route(STFTConfig(n_fft=n, hop_length=4, win_length=n),
                               inverse=False)[0] == "stft_mag"]


ADMITTED_M = _admitted_m()
GEOMS = [(400, 100), (320, 160), (384, 96)]  # M = 200, 160 and 192 (a radix-3 stage)
K1_GEOMS = GEOMS + [(450, 100)]  # M = 225, odd: K3 never has one (hop % 4 == 0, hop | n_fft)


@pytest.fixture(autouse=True)
def _two_threads():
    torch.set_num_threads(2)


def test_the_admitted_sizes():
    """n_fft 400 and 320 are in (M 200 and 160), every power of two from 128
    to 2048 still is, and an M with a prime factor above 5 or a stage wider
    than the block is not."""
    assert {200, 160, 64, 128, 256, 512, 1024} <= set(ADMITTED_M)
    assert 199 not in ADMITTED_M and 960 not in ADMITTED_M and 750 not in ADMITTED_M
    assert len(ADMITTED_M) == 54


@pytest.mark.parametrize("m", ADMITTED_M)
def test_radix_plan(m):
    """The plan's order (16s, one stage of 8, 4 or 2, the 5s, the 3s; a
    power of two: 16s, a 4, a 2, no 8), its product, its widest stage, and
    its packing round trip."""
    stages = cuda_stft.fft_stages(m)
    assert int(np.prod(stages)) == m
    twos = [r for r in stages if r in (16, 8, 4, 2)]
    assert list(stages) == twos + sorted((r for r in stages if r in (5, 3)), reverse=True)
    assert twos == sorted(twos, reverse=True)
    if m & (m - 1):
        assert twos.count(8) + twos.count(4) + twos.count(2) <= 1
    else:
        assert 8 not in twos and twos.count(4) <= 1 and twos.count(2) <= 1
    assert max(m // r for r in stages) <= cuda_stft.FFT_THREADS
    packed = cuda_stft.pack_radices(stages)
    mask = (1 << cuda_stft.RADIX_BITS) - 1
    unpacked = [(packed >> (cuda_stft.RADIX_BITS * i)) & mask for i in range(len(stages))]
    assert unpacked == list(stages) and packed < 2**31 and packed >> (
        cuda_stft.RADIX_BITS * len(stages)) == 0


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", ADMITTED_M)
def test_schedule_matches_numpy_fft_in_float64(m, inverse, rng):
    """The kernel's Stockham schedule along the host's plan, in float64,
    against ``np.fft.fft`` (unscaled inverse: M times ``np.fft.ifft``)."""
    z = rng.standard_normal((2, m)) + 1j * rng.standard_normal((2, m))
    tw = np.exp(-2j * np.pi * np.arange(m) / m)
    got = _stockham(z, tw, inverse)
    ref = np.fft.ifft(z) * m if inverse else np.fft.fft(z)
    assert got.dtype == np.complex128
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("r", cuda_stft.FFT_RADICES)
def test_each_butterfly_in_fp32(r, inverse, rng):
    """One radix-R butterfly in fp32, as ``dft()`` computes it, against
    numpy's R-point DFT of the same values."""
    x = (rng.standard_normal((r, 64)) + 1j * rng.standard_normal((r, 64))).astype(np.complex64)
    got = np.stack(_dft(list(x), r, inverse))
    ref = (np.fft.ifft(x, axis=0) * r) if inverse else np.fft.fft(x, axis=0)
    assert got.dtype == np.complex64
    assert np.abs(got - ref).max() < 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("n_fft,hop", K1_GEOMS)
def test_k1_untangle_at_mixed_radix_sizes(n_fft, hop, rng):
    """K1's model (even/odd pack, the plan's stages, the untangle into
    bins 0..M, whose middle pair is one bin at even M and two at odd M) at
    400/100, 320/160, 384/96 and 450/100, against the plain version and JAX,
    on a long row and on one of at most n_fft/2 samples (which the CUDA impl
    pads first, as ``jnp.pad`` does)."""
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft)
    cfg, jcfg = STFTConfig(**kw), JConfig(**kw)
    assert cuda_stft.route(cfg, inverse=False) == ("stft_mag", 16)
    for length in (9000, n_fft // 2):
        x = rng.standard_normal((2, length)).astype(np.float32)
        got = model_stft_mag(x, cfg)
        plain = [t.numpy() for t in cuda_stft.stft_mag_plain(torch.from_numpy(x), cfg)]
        jre, jim = (np.asarray(a) for a in j_stft(jnp.asarray(x), jcfg))
        scale = np.abs(plain[2]).max()
        for g, p, j in zip(got, plain, (jre, jim, np.hypot(jre, jim))):
            assert g.shape == p.shape == j.shape == (2, n_fft // 2 + 1, cfg.num_frames(length))
            assert np.abs(g - p).max() < REL_TOL * scale
            assert np.abs(g - j).max() < REL_TOL * scale


@pytest.mark.parametrize("n_fft,hop", GEOMS)
def test_k3_hermitian_pack_at_mixed_radix_sizes(n_fft, hop, rng):
    """K3's model (polar recombine, Hermitian pack, the plan's stages, the
    gather overlap-add at n_fft / hop = 4 and 2) at 400/100, 320/160 and 384/96,
    against the plain version and JAX, and the round trip."""
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft)
    cfg, jcfg = STFTConfig(**kw), JConfig(**kw)
    assert cuda_stft.route(cfg, inverse=True) == ("istft_polar", 16)
    length = 9000
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
    np.testing.assert_allclose(got, x, atol=1e-4 * scale)


def test_radix_plan_matches_the_sources():
    """The C side plans as the host does: ``RADIX_BITS`` bits a stage, a
    stage switch over exactly ``FFT_RADICES``, blocks of ``FFT_THREADS``
    threads, each C entry refusing a plan that ``fft_plan_ok`` rejects
    before it launches, and every butterfly constant the fp32 rounding of
    its cos or sin."""
    stages = (kernels.CSRC / "fft_stages.cuh").read_text()
    assert int(re.search(r"constexpr int RADIX_BITS = (\d+);", stages)[1]) == cuda_stft.RADIX_BITS
    body = stages[stages.index("void any_stage("):stages.index("void stockham_fft(")]
    pow2 = {int(r) for r in re.findall(r"case (\d+):", body)}
    radices = pow2 | {int(r) for r in re.findall(r"stockham_stage<(\d+), INV, IN_PLACE, false>",
                                                  body)}
    assert radices == set(cuda_stft.FFT_RADICES)
    assert pow2 == {r for m in ADMITTED_M if not m & (m - 1) for r in cuda_stft.fft_stages(m)}
    assert "if (r == 8 && pow2) return false;" in stages
    start = stages.index("inline bool fft_plan_ok(")
    ok = stages[start:stages.index("__device__", start)]
    assert {int(r) for r in re.findall(r"r != (\d+)", ok)} == set(cuda_stft.FFT_RADICES)
    for source in ("stft.cu", "istft.cu"):
        text = (kernels.CSRC / source).read_text()
        assert int(re.search(r"constexpr int THREADS = (\d+);", text)[1]) == cuda_stft.FFT_THREADS
        entry = text[text.index('extern "C"'):]
        assert entry.index("if (!fft_plan_ok(m, radices, THREADS)) return") < entry.index("<<<")
    consts = {"pi/8": np.pi / 8, "pi/4": np.pi / 4, "2 pi/5": 2 * np.pi / 5,
              "4 pi/5": 4 * np.pi / 5, "2 pi/3": 2 * np.pi / 3}
    found = re.findall(r"constexpr float \w+ = (-?[\d.]+)f;\s*// (cos|sin)\((.+?)\)", stages)
    assert len(found) == 8
    for value, fn, arg in found:
        want = np.float32(getattr(np, fn)(consts[arg]))
        assert np.float32(float(value)) == want, (fn, arg)
