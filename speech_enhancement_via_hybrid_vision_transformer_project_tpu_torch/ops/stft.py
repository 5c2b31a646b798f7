"""STFT / iSTFT in plain PyTorch (counterpart of the JAX ``ops/stft.py``).

The DFT is a matmul against window-folded DFT matrices, framing is a strided
view after center/reflect padding, and the inverse is a phase-split
overlap-add followed by librosa's window-sum normalization and ``length``
trim. These are the plain versions the CPU runs and the CUDA kernels in
``ops/cuda_stft.py`` are held against; the enhancer calls the wrappers
there, not these functions.

``method=`` on ``stft``, ``istft``, ``spectrogram`` and ``reconstruct``, as in
the JAX package: ``"matmul"`` (the default, differentiable), ``"fft"``
(``torch.fft``, a cross-check), and ``"auto"`` or ``"pallas"``, which name the
hand-written kernels (``stft_mag``, ``istft_polar``): a CUDA tensor launches
them, a CPU tensor runs their plain versions. Every geometry has a kernel:
the FFT kernels K1 and K3 where they take the config, K1g and K3g (DFT
products on the tensor cores) elsewhere (``cuda_stft.route``). A kernel's
refusal (a pad mode numpy does not have, a tensor that needs grad) is
raised, never replaced by the matmul path.

Center padding follows ``jnp.pad`` (``center_pad``): numpy's mode names
(``PAD_MODES``; PyTorch's ``replicate`` and ``circular`` are refused, as
``jnp.pad`` refuses them), and a reflection repeated where the pad is at
least the signal's length.

Float32 matmuls on a CUDA device must not run in TF32 for parity: the
port's entry points set ``torch.backends.cuda.matmul.allow_tf32 = False``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels
from .windows import get_window


@dataclass(frozen=True)
class STFTConfig:
    """Static STFT parameters (the JAX package's ``STFTConfig``)."""

    n_fft: int = 512
    hop_length: int = 128
    win_length: int = 512
    window: str = "hann"
    center: bool = True
    pad_mode: str = "reflect"

    def __post_init__(self):
        if self.win_length > self.n_fft:
            raise ValueError("win_length must be <= n_fft")

    @property
    def num_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, length: int) -> int:
        pad = self.n_fft // 2 if self.center else 0
        total = length + 2 * pad
        if total < self.n_fft:
            raise ValueError(f"signal too short: {length}")
        return 1 + (total - self.n_fft) // self.hop_length

    def padded_window(self, dtype=np.float32) -> np.ndarray:
        """Analysis window, zero-padded (centered) to n_fft like librosa."""
        w = get_window(self.window, self.win_length, dtype=np.float64)
        if self.win_length < self.n_fft:
            lpad = (self.n_fft - self.win_length) // 2
            w = np.pad(w, (lpad, self.n_fft - self.win_length - lpad))
        return w.astype(dtype)


# ---------------------------------------------------------------------------
# DFT matrices and window sums (numpy constants, computed once per config)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _forward_dft_mats(n_fft: int):
    """Real-DFT as two [n_fft, n_bins] matrices: re = x@C, im = x@S."""
    n = np.arange(n_fft)[:, None].astype(np.float64)
    k = np.arange(n_fft // 2 + 1)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang), -np.sin(ang)


@functools.lru_cache(maxsize=None)
def _inverse_dft_mats(n_fft: int):
    """Inverse real-DFT as two [n_bins, n_fft] matrices: x = re@A + im@B."""
    nb = n_fft // 2 + 1
    k = np.arange(nb)[:, None].astype(np.float64)
    n = np.arange(n_fft)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * k * n / n_fft
    c = np.full((nb, 1), 2.0)
    c[0] = 1.0
    c[-1] = 1.0  # DC and Nyquist counted once
    return c * np.cos(ang) / n_fft, -c * np.sin(ang) / n_fft


@functools.lru_cache(maxsize=None)
def window_dft(cfg: STFTConfig) -> np.ndarray:
    """Analysis window folded into the forward DFT: ``[n_fft, 2F]`` float32,
    real part in columns ``[:F]``, imaginary part in ``[F:]``."""
    c, s = _forward_dft_mats(cfg.n_fft)
    w = cfg.padded_window(np.float64)
    return np.concatenate([w[:, None] * c, w[:, None] * s], axis=1).astype(
        np.float32
    )


@functools.lru_cache(maxsize=None)
def inv_window_dft(cfg: STFTConfig) -> tuple[np.ndarray, np.ndarray]:
    """Synthesis window folded into the inverse DFT: ``(Wa, Wb)``, each
    ``[F, n_fft]`` float32, so that ``frame = re@Wa + im@Wb``."""
    a, b = _inverse_dft_mats(cfg.n_fft)
    w = cfg.padded_window(np.float64)
    return (
        (a * w[None, :]).astype(np.float32),
        (b * w[None, :]).astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def window_sumsquare_denominator(cfg: STFTConfig, n_frames: int) -> np.ndarray:
    """librosa's ``window_sumsquare`` at each overlap-added sample, with
    values at or below float32 ``tiny`` replaced by 1 (the divisor iSTFT
    normalizes by). ``[n_fft + (n_frames-1)*hop]`` float32."""
    w2 = cfg.padded_window(np.float64) ** 2
    out_len = cfg.n_fft + (n_frames - 1) * cfg.hop_length
    s = np.zeros(out_len)
    for i in range(n_frames):
        s[i * cfg.hop_length : i * cfg.hop_length + cfg.n_fft] += w2
    s = s.astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    return np.where(s > tiny, s, np.float32(1.0)).astype(np.float32)


def istft_output_span(cfg: STFTConfig, n_frames: int, length: int | None):
    """(first overlap-added sample kept, number of output samples) for
    librosa's center crop and ``length`` trim. Samples past the
    overlap-added signal are zeros (the ``length`` pad)."""
    out_len = cfg.n_fft + (n_frames - 1) * cfg.hop_length
    offset = cfg.n_fft // 2 if cfg.center else 0
    if length is not None:
        return offset, int(length)
    if cfg.center:
        return offset, max(out_len - offset - cfg.n_fft // 2, 0)
    return 0, out_len


# ---------------------------------------------------------------------------
# Framing / overlap-add
# ---------------------------------------------------------------------------


# numpy's pad modes, which the JAX package's center padding (``jnp.pad``) takes
PAD_MODES = ("constant", "edge", "linear_ramp", "maximum", "mean", "median", "minimum",
             "reflect", "symmetric", "wrap", "empty")


def check_pad_mode(mode: str) -> None:
    """Raise ``ValueError`` unless ``mode`` is one of numpy's pad modes
    (PyTorch's ``replicate`` and ``circular`` are ``edge`` and ``wrap``)."""
    if mode not in PAD_MODES:
        raise ValueError(f"pad_mode {mode!r} is not one of numpy's {PAD_MODES}")


def _pad_source(mode: str, length: int, half: int, device) -> torch.Tensor:
    """For ``edge``, ``wrap``, ``reflect`` and ``symmetric``: the sample of
    the row that each sample of the padded row copies, as numpy repeats the
    reflection or the wrap while the pad is longer than the row."""
    j = torch.arange(-half, length + half, device=device)
    if mode == "edge":
        return j.clamp(0, length - 1)
    if mode == "wrap":
        return j.remainder(length)
    period = 2 * length if mode == "symmetric" else max(2 * (length - 1), 1)
    m = j.remainder(period)
    return torch.where(m < length, m, period - m - int(mode == "symmetric"))


def center_pad(x: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """Center-pad the last axis by ``n_fft//2`` on each side with the
    configured pad mode (librosa ``center=True``), as ``jnp.pad`` pads it:
    numpy's mode names, the reflection repeated while the pad is at least
    the length."""
    if not cfg.center:
        return x
    check_pad_mode(cfg.pad_mode)
    mode, half, length = cfg.pad_mode, cfg.n_fft // 2, x.shape[-1]
    if mode in ("constant", "empty"):
        return F.pad(x, (half, half))
    if length == 0:
        raise ValueError(f"stft: cannot {mode} pad an empty signal")
    if mode == "reflect" and half < length:  # one reflection: PyTorch's own
        y = F.pad(x.reshape(-1, 1, length), (half, half), mode="reflect")
        return y.reshape(*x.shape[:-1], y.shape[-1])
    if mode in ("edge", "wrap", "reflect", "symmetric"):
        return x.index_select(-1, _pad_source(mode, length, half, x.device))
    if mode == "linear_ramp":  # from 0 at the far ends to the edge samples
        ramp = torch.arange(half, device=x.device, dtype=x.dtype) / half
        return torch.cat([x[..., :1] * ramp, x, x[..., -1:] * ramp.flip(0)], dim=-1)
    if mode == "median":  # of an even count, the mean of the middle two
        s = x.sort(dim=-1).values
        fill = (s[..., (length - 1) // 2] + s[..., length // 2]) / 2
    else:
        fill = {"maximum": torch.amax, "minimum": torch.amin, "mean": torch.mean}[mode](x, dim=-1)
    side = fill[..., None].expand(*x.shape[:-1], half)
    return torch.cat([side, x, side], dim=-1)


def frame_signal(x: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """Slice ``x [..., L]`` into overlapped frames ``[..., N, n_fft]``
    after center padding."""
    x = center_pad(x, cfg)
    return x.unfold(-1, cfg.n_fft, cfg.hop_length)


def overlap_add(frames: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """Inverse of framing: ``[..., N, n_fft] -> [..., n_fft + (N-1)*hop]``."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    n_frames = frames.shape[-2]
    out_len = n_fft + (n_frames - 1) * hop
    lead = frames.shape[:-2]
    if n_fft % hop == 0:
        # phase split: chunk p of frame j lands on output hop-block j+p
        r = n_fft // hop
        m = n_frames - 1 + r
        total = frames.new_zeros(*lead, m, hop)
        for p in range(r):
            total[..., p : p + n_frames, :] += frames[..., p * hop : (p + 1) * hop]
        return total.reshape(*lead, m * hop)[..., :out_len]
    out = frames.new_zeros(*lead, out_len)
    for i in range(n_frames):
        out[..., i * hop : i * hop + n_fft] += frames[..., i, :]
    return out


# ---------------------------------------------------------------------------
# STFT / iSTFT
# ---------------------------------------------------------------------------


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


KERNEL_METHODS = ("auto", "pallas")


def stft(x: torch.Tensor, cfg: STFTConfig = STFTConfig(), *, method: str = "matmul"):
    """Short-time Fourier transform of ``x [..., L]``. Returns ``(re, im)``,
    each ``[..., F, N]`` float32 (bins first, librosa's ``[F, T]``).
    ``method``: ``"matmul"`` (windowed-DFT matmuls), ``"fft"``
    (``torch.fft.rfft``), ``"auto"``/``"pallas"`` (K1)."""
    if method in KERNEL_METHODS:
        from .cuda_stft import stft_mag

        re, im, _ = stft_mag(x.float().reshape(-1, x.shape[-1]).contiguous(), cfg)
        return (re.reshape(*x.shape[:-1], *re.shape[1:]),
                im.reshape(*x.shape[:-1], *im.shape[1:]))
    frames = frame_signal(x.float(), cfg)  # [..., N, n_fft]
    f = cfg.num_bins
    if method == "matmul":
        spec = frames @ _const(window_dft(cfg), frames)  # [..., N, 2F]
        re, im = spec[..., :f], spec[..., f:]
    elif method == "fft":
        spec = torch.fft.rfft(frames * _const(cfg.padded_window(), frames), n=cfg.n_fft)
        re, im = spec.real, spec.imag
    else:
        raise ValueError(f"unknown stft method {method!r}")
    return re.transpose(-1, -2), im.transpose(-1, -2)


def istft(
    re: torch.Tensor,
    im: torch.Tensor,
    cfg: STFTConfig = STFTConfig(),
    *,
    length: int | None = None,
    method: str = "matmul",
) -> torch.Tensor:
    """Inverse STFT with synthesis-window overlap-add and window-sum
    normalization (librosa ``istft`` semantics incl. ``length`` trim).
    ``re, im: [..., F, N]`` -> ``[..., length]``. ``method``: ``"matmul"``,
    ``"fft"`` (``torch.fft.irfft``), ``"auto"``/``"pallas"`` (K3, which
    takes the spectrum in polar form: ``magphase`` first)."""
    if method in KERNEL_METHODS:
        return reconstruct(*magphase(re.float(), im.float()), cfg, length=length,
                           method=method)
    re = re.float().transpose(-1, -2)  # [..., N, F]
    im = im.float().transpose(-1, -2)
    n_frames = re.shape[-2]
    if method == "matmul":
        wa, wb = inv_window_dft(cfg)
        frames = re @ _const(wa, re) + im @ _const(wb, im)  # window folded in
    elif method == "fft":
        frames = torch.fft.irfft(torch.complex(re, im), n=cfg.n_fft)
        frames = frames * _const(cfg.padded_window(), frames)
    else:
        raise ValueError(f"unknown istft method {method!r}")
    y = overlap_add(frames, cfg)
    y = y / _const(window_sumsquare_denominator(cfg, n_frames), y)
    offset, n_out = istft_output_span(cfg, n_frames, length)
    y = y[..., offset : offset + n_out]
    deficit = n_out - y.shape[-1]
    if deficit > 0:
        y = F.pad(y, (0, deficit))
    return y


def magphase(re: torch.Tensor, im: torch.Tensor, eps: float = 0.0):
    """Magnitude and phase from a complex spectrum."""
    return torch.sqrt(re * re + im * im + eps), torch.atan2(im, re)


def polar(mag: torch.Tensor, phase: torch.Tensor):
    """Recombine magnitude and phase into ``(re, im)``."""
    return mag * torch.cos(phase), mag * torch.sin(phase)


def spectrogram(x: torch.Tensor, cfg: STFTConfig = STFTConfig(), *,
                method: str = "matmul"):
    """Waveform -> ``(magnitude, phase)``, the dataset's front-end transform."""
    return magphase(*stft(x, cfg, method=method))


def reconstruct(
    mag: torch.Tensor,
    phase: torch.Tensor,
    cfg: STFTConfig = STFTConfig(),
    *,
    length: int | None = None,
    method: str = "matmul",
) -> torch.Tensor:
    """(magnitude, phase) -> waveform: polar recombine, then ``istft``; with
    ``method="auto"``/``"pallas"`` K3, which recombines as it loads."""
    if method in KERNEL_METHODS:
        from .cuda_stft import istft_polar

        lead, fn = mag.shape[:-2], mag.shape[-2:]
        y = istft_polar(mag.float().reshape(-1, *fn).contiguous(),
                        phase.float().reshape(-1, *fn).contiguous(), cfg, length=length)
        return y.reshape(*lead, y.shape[-1])
    re, im = polar(mag, phase)
    return istft(re, im, cfg, length=length, method=method)


def implied_length(cfg: STFTConfig, n_frames: int) -> int:
    """The largest signal length whose STFT has ``n_frames`` frames, as
    Griffin-Lim's rounds take it."""
    if cfg.center:
        return (n_frames - 1) * cfg.hop_length
    return cfg.n_fft + (n_frames - 1) * cfg.hop_length


def draw_griffin_lim_phase(shape, generator: torch.Generator) -> torch.Tensor:
    """Griffin-Lim's initial phase: uniform in [0, 2 pi) on the generator's
    device (the JAX package draws it from its ``key``)."""
    return torch.rand(tuple(shape), generator=generator, device=generator.device) * (
        2.0 * np.pi)


def griffin_lim_plain(mag: torch.Tensor, phase: torch.Tensor,
                      cfg: STFTConfig = STFTConfig(), *, n_iter: int = 32,
                      length: int | None = None) -> torch.Tensor:
    """The JAX package's Griffin-Lim on ``(re, im)`` with the matmul STFT:
    each round is an iSTFT at the implied length, an STFT, and a rescale of
    the spectrum to ``mag`` by ``mag / max(|X|, 1e-16)``."""
    mag = mag.float()
    implied = implied_length(cfg, mag.shape[-1])
    re, im = polar(mag, phase.float())
    for _ in range(n_iter):
        r2, i2 = stft(istft(re, im, cfg, length=implied), cfg)
        scale = mag / torch.clamp_min(torch.sqrt(r2 * r2 + i2 * i2), 1e-16)
        re, im = r2 * scale, i2 * scale
    return istft(re, im, cfg, length=implied if length is None else length)


def griffin_lim(mag: torch.Tensor, cfg: STFTConfig = STFTConfig(), *, n_iter: int = 32,
                length: int | None = None, phase: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Griffin-Lim phase reconstruction of ``mag [..., F, N]`` from
    ``phase`` (the initial phase; else drawn by ``draw_griffin_lim_phase``
    from ``generator``, by default one seeded 0 on ``mag``'s device).

    A CPU tensor runs ``griffin_lim_plain``. A CUDA tensor runs each round
    as ``istft_polar`` then ``stft_mag``, keeping ``mag`` and the new phase
    ``atan2(im, re)``: ``n_iter`` launches of K1 (or K1g) and ``n_iter + 1``
    of K3 (or K3g), as ``cuda_stft.route`` picks them. The polar form equals the plain rescale wherever
    ``|X| >= 1e-16``; where a frame's STFT is exactly 0 and ``mag`` is not,
    the plain version gives 0 and the kernels give ``mag`` at phase 0."""
    if phase is None:
        if generator is None:
            generator = torch.Generator(device=mag.device).manual_seed(0)
        phase = draw_griffin_lim_phase(mag.shape, generator)
    if not kernels.uses_kernel(mag):
        return griffin_lim_plain(mag, phase, cfg, n_iter=n_iter, length=length)
    from .cuda_stft import griffin_lim_polar

    return griffin_lim_polar(mag, phase, cfg, n_iter=n_iter, length=length)
