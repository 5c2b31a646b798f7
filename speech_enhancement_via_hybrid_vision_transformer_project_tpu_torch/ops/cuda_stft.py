"""STFT and iSTFT of the serving path: CUDA kernels K1 and K3, and K1g and
K3g for every other geometry, beside their plain PyTorch versions.

``stft_mag`` replaces the JAX package's ``pallas_stft(return_mag=True)``
(``ops/pallas_stft.py``) and ``istft_polar`` its
``pallas_istft(polar=True)``. Each calls its op, ``torch.ops.sevit.stft_mag``
or ``torch.ops.sevit.istft_polar``, on both devices, with the STFT config as
plain ints, a bool and strings. Dispatch is by the device of the input: on a
CPU tensor the op runs the plain version, on a CUDA tensor it launches a
kernel or raises. There is no fallback from one to the other.

Which kernel a CUDA tensor gets is fixed by the config alone (``route``),
before any launch:

- K1 and K3 (``csrc/stft.cu``, ``csrc/istft.cu``) are shared-memory
  mixed-radix FFTs (``csrc/fft_stages.cuh``) that read one fp32 table built
  here in float64 (``fft_plan``) and a radix plan made here
  (``fft_stages``). They take an even ``n_fft`` from 128 to 2048 whose
  M = n_fft/2 is 2^a 3^b 5^c and whose plan has no stage of more than 256
  butterflies a frame (a block's threads: such an M, 960 for one, is
  refused rather than looped), and a ``hop_length`` that is a multiple of 4
  (K3: one that divides ``n_fft`` and fits in shared memory, so that K3's
  M is even); ``kernel_tile`` checks that and picks the frames each block
  transforms.
  The repo's 512/128, CMGAN's 400/100 and the 320/160 front end run there.
- K1g and K3g (``csrc/stft_dft.cu``, ``csrc/istft_dft.cu``) take every other
  geometry: any ``n_fft`` and hop. They compute the windowed DFT as the TPU
  kernels do, a product against the window-folded DFT matrices of
  ``ops/stft.py`` (``window_dft``, ``inv_window_dft``), on the tensor cores
  in 3xTF32; the wrapper hands them the matrices cut into column tiles
  (``dft_tiles``, ``idft_tiles``).

K1 and K1g read the unpadded signal: reflect and zero (``constant``) center
padding are fused into their loads. A row too short for one reflection, and
numpy's other pad modes, are padded on the card first (``stft.center_pad``,
as ``jnp.pad`` pads) and launched with no padding. The tables, the matrices
and the iSTFT's window-sum denominator are device constants that the CUDA
impls fetch when they run (``_device_const``); they never enter a traced
graph.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import kernels
from .stft import (
    STFTConfig,
    center_pad,
    check_pad_mode,
    implied_length,
    inv_window_dft,
    istft_output_span,
    reconstruct,
    stft,
    window_dft,
    window_sumsquare_denominator,
)

FFT_N_FFT = (128, 2048)  # the even n_fft K1 and K3 take, at least and at most
FFT_RADICES = (16, 8, 4, 2, 5, 3)  # their butterflies (csrc/fft_stages.cuh)
FFT_THREADS = 256  # threads of a K1 or K3 block: the most butterflies a stage may have
RADIX_BITS = 5  # bits of one stage's radix in the packed plan (fft_stages.cuh)
_TILE_POINTS = 4096  # complex points per shared-memory buffer of a block, at most
_MAX_TILE = 32  # frames per block
_SMEM_LIMIT = 227 * 1024  # shared memory one H100 block may use
# the column tiles of K1g's and K3g's matrices; the C entries refuse a launch
# whose tiles are not their own BN and BK
DFT_BLOCK_BINS = 32  # K1g: bins a block (their re and im columns)
DFT_DEPTH = 32  # K1g: samples a step
IDFT_BLOCK_SAMPLES = 64  # K3g: frame samples a block
IDFT_DEPTH = 16  # K3g: bins a step
FUSED_PAD_MODES = ("reflect", "constant")  # the center padding K1's and K1g's loads do
MAX_BATCH = 65535  # rows of one STFT kernel launch (the grid's y, or K1g's and K3g's z)
# (n_fft, hop, win, pad_mode) of common 16 kHz front ends that K1 and K3 do
# not all take, which the port's checks run on both routes
GEOMETRIES = (
    (400, 100, 400, "reflect"),  # CMGAN on VoiceBank-DEMAND
    (320, 160, 320, "reflect"),  # the 20 ms / 10 ms front end
    (400, 160, 400, "reflect"),  # a hop that does not divide n_fft
    (512, 100, 400, "reflect"),  # DCCRN: window 400, hop 100, FFT 512
    (512, 100, 512, "reflect"),
    (4096, 1024, 4096, "reflect"),  # the JAX package's largest tested n_fft
    (512, 128, 512, "constant"),
    (384, 96, 384, "reflect"),  # M = 192: a radix-3 stage (16, 4, 3)
    (450, 100, 450, "reflect"),  # M = 225, odd: the span is 2 mod 4 samples
    (450, 100, 450, "edge"),  # padded first: K1's 16-byte span copy at odd M
)


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


def fft_stages(m: int) -> tuple[int, ...] | None:
    """The radices of K1's and K3's Stockham stages for an ``m``-point
    complex FFT, in order: 16 while 16 divides what is left of ``m``'s power
    of two, then 8, 4 or 2 for the rest of it, then the 5s, then the 3s
    (256: 16, 16; 200: 8, 5, 5; 160: 16, 2, 5). A power of two takes no 8,
    which its kernel instance leaves out for registers: 4s, then a 2
    (128: 16, 4, 2). None where ``m`` has a prime factor above 5."""
    twos = (m & -m).bit_length() - 1 if m > 0 else 0
    rest = m >> twos
    left = twos % 4
    if rest == 1:  # a power of two
        tail = [4] * (left // 2) + [2] * (left % 2)
    else:
        tail = [1 << left] if left else []
    stages = [16] * (twos // 4) + tail
    for r in (5, 3):
        while rest % r == 0:
            stages.append(r)
            rest //= r
    return tuple(stages) if m > 0 and rest == 1 else None


def pack_radices(stages) -> int:
    """The plan as the kernels take it: stage i's radix in bits
    ``RADIX_BITS * i`` and up."""
    return sum(r << (RADIX_BITS * i) for i, r in enumerate(stages))


def _smem_bytes(cfg: STFTConfig, tile: int, inverse: bool) -> int:
    """Shared memory of one K1 or K3 block (mirrors the C entries): one
    complex buffer of ``tile`` frames, each M = n_fft/2 points plus one pad
    slot per 16 and one more (``fft_row_stride``), K1's signal span, and
    the table."""
    n_fft, m = cfg.n_fft, cfg.n_fft // 2
    buf = (tile * (m + m // 16 + 1) + 1) & ~1
    span = 0 if inverse else (tile - 1) * cfg.hop_length + n_fft
    return 8 * buf + 4 * (span + 3 * n_fft + 2)


def _fft_tile(cfg: STFTConfig, inverse: bool) -> tuple[int, str | None]:
    """K1's (``inverse=False``) or K3's frames per block for ``cfg``, a
    power of two, and why the kernel does not take ``cfg`` (None where it
    does)."""
    n_fft, hop, m = cfg.n_fft, cfg.hop_length, cfg.n_fft // 2
    name = "istft_polar" if inverse else "stft_mag"
    lo, hi = FFT_N_FFT
    if n_fft % 2 or not lo <= n_fft <= hi:
        return 0, f"{name} kernel: n_fft {n_fft} is not even in [{lo}, {hi}]"
    stages = fft_stages(m)
    if stages is None:
        return 0, f"{name} kernel: n_fft / 2 = {m} has a prime factor above 5"
    if m // min(stages) > FFT_THREADS:
        return 0, (f"{name} kernel: n_fft / 2 = {m} needs a radix-{min(stages)} stage of "
                   f"{m // min(stages)} butterflies, more than a block's {FFT_THREADS} threads")
    if hop <= 0 or hop % 4 or hop > n_fft:
        return 0, f"{name} kernel: hop_length {hop} must be a multiple of 4, <= n_fft"
    tile = 1 << (min(_MAX_TILE, _TILE_POINTS // m).bit_length() - 1)  # a power of two
    if inverse:
        if n_fft % hop:
            return 0, f"{name} kernel: hop_length {hop} must divide n_fft {n_fft}"
        # at least half the frames are not halo
        tile = max(tile, 1 << (2 * (n_fft // hop) - 1).bit_length())
    if _smem_bytes(cfg, tile, inverse) > _SMEM_LIMIT:
        return 0, (f"{name} kernel: n_fft / hop_length = {n_fft // hop} needs "
                   f"{_smem_bytes(cfg, tile, inverse)} bytes of shared memory")
    return tile, None


def kernel_tile(cfg: STFTConfig, *, inverse: bool) -> int:
    """Frames per block of K1 (``inverse=False``) or K3, after checking
    that the FFT kernel takes ``cfg``; raises ``ValueError`` otherwise.
    Needs no card."""
    tile, refusal = _fft_tile(cfg, inverse)
    if refusal:
        raise ValueError(refusal)
    return tile


def route(cfg: STFTConfig, *, inverse: bool) -> tuple[str, int]:
    """The kernel a CUDA tensor gets for ``cfg``, by its ``kernels.KERNELS``
    name, and its frames per block: the FFT kernel (``stft_mag``,
    ``istft_polar``) and its tile where ``kernel_tile`` takes the config,
    else K1g (``stft_dft``) or K3g (``istft_dft``) and 0. Fixed by the
    config alone; needs no card."""
    tile, refusal = _fft_tile(cfg, inverse)
    if refusal is None:
        return ("istft_polar" if inverse else "stft_mag"), tile
    return ("istft_dft" if inverse else "stft_dft"), 0


def _column_tiles(top: np.ndarray, bottom: np.ndarray, width: int, depth: int) -> np.ndarray:
    """Two ``[K, C]`` matrices cut into ``ceil(C / width)`` column tiles,
    each ``[k_pad, 2 * width]``: the tile's columns of ``top``, then of
    ``bottom``, zero past column C - 1 and row K - 1 (``k_pad``: K rounded
    up to ``depth``). Flat float32."""
    k, c = top.shape
    n_tiles, k_pad = -(-c // width), -(-k // depth) * depth
    out = np.zeros((2, k_pad, n_tiles * width), np.float32)
    out[0, :k, :c], out[1, :k, :c] = top, bottom
    # [top/bottom, row, tile, column] -> [tile, row, top/bottom, column]
    out = out.reshape(2, k_pad, n_tiles, width).transpose(2, 1, 0, 3)
    return np.ascontiguousarray(out).reshape(-1)


def dft_tiles(cfg: STFTConfig) -> np.ndarray:
    """K1g's matrix: ``window_dft(cfg)`` ``[n_fft, 2F]`` cut into column
    tiles of ``DFT_BLOCK_BINS`` bins, their re columns, then their im
    columns (``_column_tiles``)."""
    w, f = window_dft(cfg), cfg.num_bins
    return _column_tiles(w[:, :f], w[:, f:], DFT_BLOCK_BINS, DFT_DEPTH)


def idft_tiles(cfg: STFTConfig) -> np.ndarray:
    """K3g's matrix: ``inv_window_dft(cfg)``'s ``Wa`` and ``Wb`` (each
    ``[F, n_fft]``) cut into column tiles of ``IDFT_BLOCK_SAMPLES`` samples,
    Wa's columns, then Wb's (``_column_tiles``)."""
    return _column_tiles(*inv_window_dft(cfg), IDFT_BLOCK_SAMPLES, IDFT_DEPTH)


@functools.lru_cache(maxsize=64)
def _device_const(kind: str, cfg: STFTConfig, device: torch.device, n_frames: int = 0):
    if kind == "denom":
        a = window_sumsquare_denominator(cfg, n_frames)
    else:
        a = {"plan": fft_plan, "dft": dft_tiles, "idft": idft_tiles}[kind](cfg)
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


def _check_batch(name: str, b: int) -> None:
    if b > MAX_BATCH:
        raise ValueError(f"{name}: batch {b} > {MAX_BATCH} rows a launch")


def _check_stft_kernel(x: torch.Tensor, cfg: STFTConfig) -> tuple[str, int]:
    """The argument checks of the kernel that ``route`` picks (shapes and
    types only); returns its name and, for K1, its tile."""
    kernels.check_input("stft_mag x", x, 2)
    if cfg.center:
        check_pad_mode(cfg.pad_mode)
    _check_batch("stft_mag", x.shape[0])
    return route(cfg, inverse=False)


def _pads_first(cfg: STFTConfig, length: int) -> bool:
    """Whether the CUDA impl center-pads rows of ``length`` samples itself
    before the launch: a pad mode the kernels' loads do not do, or a reflect
    pad of at least the length, which numpy reflects more than once."""
    if not cfg.center:
        return False
    return cfg.pad_mode not in FUSED_PAD_MODES or (
        cfg.pad_mode == "reflect" and length <= cfg.n_fft // 2)


def _stft_plain(x, *cfg):
    # the plain re and im are views of one buffer, and an op's outputs may not
    # alias: clones, in the plain version's frames-major layout (the CPU
    # callers' reductions follow it; _stft_fake states it)
    re, im, mag = stft_mag_plain(x, STFTConfig(*cfg))
    return re.clone(), im.clone(), mag


def _stft_cuda(x, *cfg):
    cfg = STFTConfig(*cfg)
    name, tile = _check_stft_kernel(x, cfg)
    b, length = x.shape
    n_frames = cfg.num_frames(length)
    pad = cfg.n_fft // 2 if cfg.center else 0
    if b and _pads_first(cfg, length):
        with torch.cuda.device(x.device):
            x = center_pad(x, cfg).contiguous()
        length, pad = x.shape[1], 0
    reflect = int(cfg.pad_mode == "reflect")
    table = _device_const("plan" if name == "stft_mag" else "dft", cfg, x.device)
    re, im, mag = (
        torch.empty(b, cfg.num_bins, n_frames, device=x.device, dtype=torch.float32)
        for _ in range(3)
    )
    if b:
        ptrs = (x.data_ptr(), table.data_ptr(), re.data_ptr(), im.data_ptr(), mag.data_ptr())
        with torch.cuda.device(x.device):
            if name == "stft_mag":
                kernels.launch(name, *ptrs, b, length, pad, reflect, n_frames, cfg.n_fft,
                               cfg.hop_length, tile, pack_radices(fft_stages(cfg.n_fft // 2)))
            else:
                kernels.launch(name, *ptrs, b, length, pad, reflect, n_frames, cfg.n_fft,
                               cfg.hop_length, DFT_BLOCK_BINS, DFT_DEPTH)
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
    CPU: plain version; CUDA: kernel K1, or K1g where ``route`` says so,
    after padding the rows on the card first where their loads cannot
    (``_pads_first``)."""
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


def _check_istft_kernel(mag: torch.Tensor, phase: torch.Tensor,
                        cfg: STFTConfig) -> tuple[str, int]:
    """The argument checks of the kernel that ``route`` picks (shapes and
    types only); returns its name and, for K3, its tile."""
    kernels.check_input("istft_polar mag", mag, 3)
    kernels.check_input("istft_polar phase", phase, 3)
    name, tile = route(cfg, inverse=True)
    if mag.shape[1] != cfg.num_bins:
        raise ValueError(f"istft_polar: {mag.shape[1]} bins, config has {cfg.num_bins}")
    _check_batch("istft_polar", mag.shape[0])
    return name, tile


def _istft_plain(mag, phase, *cfg_length):
    *cfg, length = cfg_length
    # the plain output is a crop, a view; _istft_fake states a contiguous tensor
    return istft_polar_plain(mag, phase, STFTConfig(*cfg), length=length).contiguous()


def _istft_cuda(mag, phase, *cfg_length):
    *cfg, length = cfg_length
    cfg = STFTConfig(*cfg)
    name, tile = _check_istft_kernel(mag, phase, cfg)
    b, _, n_frames = mag.shape
    offset, n_out = istft_output_span(cfg, n_frames, length)
    table = _device_const("plan" if name == "istft_polar" else "idft", cfg, mag.device)
    denom = _device_const("denom", cfg, mag.device, n_frames)
    y = torch.empty(b, n_out, device=mag.device, dtype=torch.float32)
    if b and n_out:
        with torch.cuda.device(mag.device):
            if name == "istft_polar":
                kernels.launch(name, mag.data_ptr(), phase.data_ptr(), table.data_ptr(),
                               denom.data_ptr(), y.data_ptr(), b, n_frames, cfg.n_fft,
                               cfg.hop_length, offset, n_out, tile,
                               pack_radices(fft_stages(cfg.n_fft // 2)))
            else:  # K3g's frames go through a scratch [B, N, n_fft]
                frames = torch.empty(b, n_frames, cfg.n_fft, device=mag.device,
                                     dtype=torch.float32)
                kernels.launch(name, mag.data_ptr(), phase.data_ptr(), table.data_ptr(),
                               denom.data_ptr(), frames.data_ptr(), y.data_ptr(), b, n_frames,
                               cfg.n_fft, cfg.hop_length, offset, n_out, IDFT_BLOCK_SAMPLES,
                               IDFT_DEPTH)
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
    CPU: plain version; CUDA: kernel K3, or K3g where ``route`` says so."""
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
    (or K3g) ``n_iter + 1`` and K1 (or K1g) ``n_iter`` times on CUDA
    tensors; on CPU tensors
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
