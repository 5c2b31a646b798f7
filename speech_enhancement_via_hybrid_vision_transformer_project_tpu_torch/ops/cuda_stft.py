"""STFT and iSTFT of the serving path: CUDA kernels K1 and K3 beside their
plain PyTorch versions.

``stft_mag`` replaces the JAX package's ``pallas_stft(return_mag=True)``
(``ops/pallas_stft.py``) and ``istft_polar`` its
``pallas_istft(polar=True)``. Each calls its op, ``torch.ops.sevit.stft_mag``
or ``torch.ops.sevit.istft_polar``, on both devices, with the STFT config as
plain ints, a bool and strings. Dispatch is by the device of the input: on a
CPU tensor the op runs the plain version, on a CUDA tensor it launches the
kernel (``csrc/stft.cu``, ``csrc/istft.cu``) or raises. There is no
fallback from one to the other.

Both kernels are shared-memory FFTs (``csrc/fft_stages.cuh``) that read one
fp32 table built here in float64 (``fft_plan``). They take a power-of-two
``n_fft`` from 128 to 2048 and a ``hop_length`` that is a multiple of 4 (K3:
one that divides ``n_fft``); ``kernel_tile`` checks that and picks the frames
each block transforms. K1 reads the unpadded signal: its center (reflect)
padding is fused into the kernel's loads. The table and K3's window-sum
denominator are device constants that the CUDA impls fetch when they run
(``_device_const``); they never enter a traced graph.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import kernels
from .stft import (
    STFTConfig,
    implied_length,
    istft_output_span,
    reconstruct,
    stft,
    window_sumsquare_denominator,
)

FFT_SIZES = (128, 256, 512, 1024, 2048)  # the kernels' power-of-two n_fft
_TILE_POINTS = 4096  # complex points per shared-memory buffer of a block
_MAX_TILE = 32  # frames per block
_SMEM_LIMIT = 227 * 1024  # shared memory one H100 block may use


def fft_plan(cfg: STFTConfig) -> np.ndarray:
    """The table K1 and K3 read, ``3 * n_fft + 2`` float32 values built in
    float64: ``M = n_fft/2`` twiddles ``exp(-2 pi i k / M)`` as (re, im)
    pairs, ``M + 1`` untangle factors ``exp(-2 pi i k / n_fft)``, then the
    (zero-padded) window."""
    n = cfg.n_fft
    m = n // 2
    tw = np.exp(-2j * np.pi * np.arange(m) / m)
    ut = np.exp(-2j * np.pi * np.arange(m + 1) / n)
    pairs = [np.stack([c.real, c.imag], axis=-1).ravel() for c in (tw, ut)]
    return np.concatenate([*pairs, cfg.padded_window(np.float64)]).astype(np.float32)


def _smem_bytes(cfg: STFTConfig, tile: int, inverse: bool) -> int:
    """Shared memory of one K1 or K3 block (mirrors the C entries): one
    complex buffer of ``tile`` frames, each M = n_fft/2 points plus one pad
    slot per 16 and one more (``fft_row_stride``), K1's signal span, and
    the table."""
    n_fft, m = cfg.n_fft, cfg.n_fft // 2
    buf = (tile * (m + m // 16 + 1) + 1) & ~1
    span = 0 if inverse else (tile - 1) * cfg.hop_length + n_fft
    return 8 * buf + 4 * (span + 3 * n_fft + 2)


def kernel_tile(cfg: STFTConfig, *, inverse: bool) -> int:
    """Frames per block of K1 (``inverse=False``) or K3, after checking
    that the kernel takes ``cfg``; raises ``ValueError`` otherwise. Needs
    no card: the wrappers call it before they launch."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    name = "istft_polar" if inverse else "stft_mag"
    if n_fft not in FFT_SIZES:
        raise ValueError(f"{name} kernel: n_fft {n_fft} is not a power of two in {FFT_SIZES}")
    if hop <= 0 or hop % 4 or hop > n_fft:
        raise ValueError(f"{name} kernel: hop_length {hop} must be a multiple of 4, <= n_fft")
    if not inverse and cfg.center and cfg.pad_mode != "reflect":
        raise ValueError(f"{name} kernel: pad_mode {cfg.pad_mode!r} is not reflect")
    tile = min(_MAX_TILE, _TILE_POINTS // (n_fft // 2))
    if inverse:
        if n_fft % hop:
            raise ValueError(f"{name} kernel: hop_length {hop} must divide n_fft {n_fft}")
        tile = max(tile, 2 * (n_fft // hop))  # at least half the frames are not halo
    if _smem_bytes(cfg, tile, inverse) > _SMEM_LIMIT:
        raise ValueError(f"{name} kernel: n_fft / hop_length = {n_fft // hop} needs "
                         f"{_smem_bytes(cfg, tile, inverse)} bytes of shared memory")
    return tile


@functools.lru_cache(maxsize=64)
def _device_const(kind: str, cfg: STFTConfig, device: torch.device, n_frames: int = 0):
    a = fft_plan(cfg) if kind == "plan" else window_sumsquare_denominator(cfg, n_frames)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if t.is_cuda:  # other streams may read it next (the enhancer's replicas run on their own)
        torch.cuda.current_stream(t.device).synchronize()
    return t


def _cfg_args(cfg: STFTConfig) -> tuple:
    return (cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.window, cfg.center, cfg.pad_mode)


_CFG_SCHEMA = "int n_fft, int hop_length, int win_length, str window, bool center, str pad_mode"


# ---------------------------------------------------------------------------
# K1: STFT with fused magnitude
# ---------------------------------------------------------------------------


def stft_mag_plain(x: torch.Tensor, cfg: STFTConfig = STFTConfig()):
    """Plain version of K1: ``x [B, L]`` -> ``(re, im, mag)``, each
    ``[B, F, N]`` float32."""
    re, im = stft(x, cfg)
    return re, im, torch.sqrt(re * re + im * im)


def _check_stft_kernel(x: torch.Tensor, cfg: STFTConfig) -> int:
    """K1's argument checks (shapes and types only); returns its tile."""
    kernels.check_input("stft_mag x", x, 2)
    tile = kernel_tile(cfg, inverse=False)
    pad = cfg.n_fft // 2 if cfg.center else 0
    if x.shape[1] <= pad:
        raise ValueError(f"stft_mag: {x.shape[1]} samples cannot be reflect padded by {pad}")
    return tile


def _stft_plain(x, *cfg):
    # the plain re and im are views of one buffer, and an op's outputs may not
    # alias: clones, in the plain version's frames-major layout (the CPU
    # callers' reductions follow it; _stft_fake states it)
    re, im, mag = stft_mag_plain(x, STFTConfig(*cfg))
    return re.clone(), im.clone(), mag


def _stft_cuda(x, *cfg):
    cfg = STFTConfig(*cfg)
    tile = _check_stft_kernel(x, cfg)
    b, length = x.shape
    n_frames = cfg.num_frames(length)
    plan = _device_const("plan", cfg, x.device)
    re, im, mag = (
        torch.empty(b, cfg.num_bins, n_frames, device=x.device, dtype=torch.float32)
        for _ in range(3)
    )
    if b:
        with torch.cuda.device(x.device):
            kernels.launch(
                "stft_mag", x.data_ptr(), plan.data_ptr(), re.data_ptr(),
                im.data_ptr(), mag.data_ptr(), b, length,
                cfg.n_fft // 2 if cfg.center else 0, n_frames, cfg.n_fft, cfg.hop_length, tile,
            )
    return re, im, mag


def _stft_fake(x, *cfg):
    cfg = STFTConfig(*cfg)
    b, f, n = x.shape[0], cfg.num_bins, cfg.num_frames(x.shape[1])
    if x.device.type == "cpu":  # the plain version's [B, N, F] memory, viewed [B, F, N]
        return tuple(x.new_empty((b, n, f), dtype=torch.float32).transpose(1, 2)
                     for _ in range(3))
    return tuple(x.new_empty((b, f, n), dtype=torch.float32) for _ in range(3))


stft_mag_op = kernels.define_op(
    "stft_mag", f"(Tensor x, {_CFG_SCHEMA}) -> (Tensor, Tensor, Tensor)",
    cpu=_stft_plain, cuda=_stft_cuda, fake=_stft_fake)


def stft_mag(x: torch.Tensor, cfg: STFTConfig = STFTConfig()):
    """STFT of ``x [B, L]`` with its magnitude: ``(re, im, mag)``, each
    ``[B, F, N]`` float32 (bins first), through the op ``sevit::stft_mag``.
    CPU: plain version; CUDA: kernel K1."""
    if x.dim() != 2:
        raise ValueError(f"stft_mag: expected [B, L], got {tuple(x.shape)}")
    if kernels.uses_kernel(x):
        _check_stft_kernel(x, cfg)
    return stft_mag_op(x, *_cfg_args(cfg))


# ---------------------------------------------------------------------------
# K3: iSTFT from magnitude and phase
# ---------------------------------------------------------------------------


def istft_polar_plain(
    mag: torch.Tensor,
    phase: torch.Tensor,
    cfg: STFTConfig = STFTConfig(),
    *,
    length: int | None = None,
) -> torch.Tensor:
    """Plain version of K3: polar recombine, then ``istft``."""
    return reconstruct(mag, phase, cfg, length=length)


def _check_istft_kernel(mag: torch.Tensor, phase: torch.Tensor, cfg: STFTConfig) -> int:
    """K3's argument checks (shapes and types only); returns its tile."""
    kernels.check_input("istft_polar mag", mag, 3)
    kernels.check_input("istft_polar phase", phase, 3)
    tile = kernel_tile(cfg, inverse=True)
    if mag.shape[1] != cfg.num_bins:
        raise ValueError(f"istft_polar: {mag.shape[1]} bins, config has {cfg.num_bins}")
    return tile


def _istft_plain(mag, phase, *cfg_length):
    *cfg, length = cfg_length
    # the plain output is a crop, a view; _istft_fake states a contiguous tensor
    return istft_polar_plain(mag, phase, STFTConfig(*cfg), length=length).contiguous()


def _istft_cuda(mag, phase, *cfg_length):
    *cfg, length = cfg_length
    cfg = STFTConfig(*cfg)
    tile = _check_istft_kernel(mag, phase, cfg)
    b, _, n_frames = mag.shape
    offset, n_out = istft_output_span(cfg, n_frames, length)
    plan = _device_const("plan", cfg, mag.device)
    denom = _device_const("denom", cfg, mag.device, n_frames)
    y = torch.empty(b, n_out, device=mag.device, dtype=torch.float32)
    if b and n_out:
        with torch.cuda.device(mag.device):
            kernels.launch(
                "istft_polar", mag.data_ptr(), phase.data_ptr(), plan.data_ptr(),
                denom.data_ptr(), y.data_ptr(), b, n_frames, cfg.n_fft,
                cfg.hop_length, offset, n_out, tile,
            )
    return y


def _istft_fake(mag, phase, *cfg_length):
    *cfg, length = cfg_length
    n_out = istft_output_span(STFTConfig(*cfg), mag.shape[2], length)[1]
    return mag.new_empty((mag.shape[0], n_out), dtype=torch.float32)


istft_polar_op = kernels.define_op(
    "istft_polar", f"(Tensor mag, Tensor phase, {_CFG_SCHEMA}, int? length) -> Tensor",
    cpu=_istft_plain, cuda=_istft_cuda, fake=_istft_fake)


def istft_polar(
    mag: torch.Tensor,
    phase: torch.Tensor,
    cfg: STFTConfig = STFTConfig(),
    *,
    length: int | None = None,
) -> torch.Tensor:
    """Waveform ``[B, length]`` from magnitude and phase ``[B, F, N]``
    (librosa ``istft`` semantics: window-sum normalize, center crop,
    ``length`` trim or zero pad), through the op ``sevit::istft_polar``.
    CPU: plain version; CUDA: kernel K3."""
    if mag.dim() != 3 or mag.shape != phase.shape:
        raise ValueError(
            f"istft_polar: expected mag and phase [B, F, N], got "
            f"{tuple(mag.shape)} and {tuple(phase.shape)}"
        )
    if kernels.uses_kernel(mag) != kernels.uses_kernel(phase) or mag.device != phase.device:
        raise ValueError("istft_polar: mag and phase on different devices")
    if kernels.uses_kernel(mag):
        _check_istft_kernel(mag, phase, cfg)
    return istft_polar_op(mag, phase, *_cfg_args(cfg), length)


# ---------------------------------------------------------------------------
# Griffin-Lim through K3 and K1
# ---------------------------------------------------------------------------


def griffin_lim_polar(mag: torch.Tensor, phase: torch.Tensor,
                      cfg: STFTConfig = STFTConfig(), *, n_iter: int = 32,
                      length: int | None = None) -> torch.Tensor:
    """Griffin-Lim in polar form: each round ``istft_polar(mag, phase)`` at
    the implied length, then ``stft_mag`` and ``phase = atan2(im, re)``;
    the spectrum's magnitude is never formed again (K1 computes it, unused).
    ``mag, phase [..., F, N]`` -> ``[..., length]``. The rounds launch K3
    ``n_iter + 1`` and K1 ``n_iter`` times on CUDA tensors; on CPU tensors
    they run the kernels' plain versions."""
    lead, fn = mag.shape[:-2], mag.shape[-2:]
    mag = mag.float().reshape(-1, *fn).contiguous()
    phase = phase.float().reshape(-1, *fn).contiguous()
    implied = implied_length(cfg, fn[-1])
    for _ in range(n_iter):
        re, im, _ = stft_mag(istft_polar(mag, phase, cfg, length=implied), cfg)
        phase = torch.atan2(im, re)
    y = istft_polar(mag, phase, cfg, length=implied if length is None else length)
    return y.reshape(*lead, y.shape[-1])
