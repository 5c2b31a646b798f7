"""Loss functions of the train step (JAX ``training/losses.py``).

``combined_loss`` returns ``(total, components)`` with the components as
0-d tensors, so nothing syncs with the host inside a step. ``sample_valid``
excludes the loader's padding rows; ``frame_mask`` (with
``use_frame_mask``) excludes padded frames. ``spectrogram_loss`` and the
waveform ``multi_resolution_stft_loss`` are the JAX package's standalone
losses, which the trainer does not call.

Data parallelism: the masked means take ``count_sum``, which sums a count
over the data-parallel ranks. Each rank's term is then its own sum over the
global count, so the ranks' terms add up to the global batch's mean, as the
JAX package's SPMD step computes it; a mean per rank, averaged over ranks,
would not equal it once the ranks hold different numbers of valid rows (a
lockstep padding batch, a short last batch). None: this rank's count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch

from ..ops.stft import STFTConfig, stft


def log_compress(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """NaN-safe log compression ``log(|x| + eps)``."""
    return torch.log(torch.abs(x) + eps)


CountSum = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _count(c: torch.Tensor, count_sum: CountSum) -> torch.Tensor:
    return c if count_sum is None else count_sum(c)


def masked_mean(err: torch.Tensor, mask: Optional[torch.Tensor],
                count_sum: CountSum = None) -> torch.Tensor:
    """Mean of ``err [B, F, T, C]``, optionally over the frames of ``mask
    [B, T]`` only."""
    if mask is None:
        if count_sum is None:
            return err.mean()
        return err.sum() / count_sum(err.new_full((), err.numel()))
    m = mask[:, None, :, None].expand(err.shape).to(err.dtype)
    return (err * m).sum() / torch.clamp(_count(m.sum(), count_sum), min=1.0)


def spectrogram_loss(pred: torch.Tensor, target: torch.Tensor, loss_type: str = "l1",
                     use_log_compression: bool = False,
                     frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1, MSE or L1+MSE of ``[B, F, T, C]`` spectrograms, optionally
    log-compressed and over the frames of ``frame_mask [B, T]`` only."""
    if use_log_compression:
        pred, target = log_compress(pred), log_compress(target)
    if loss_type == "l1":
        return masked_mean(torch.abs(pred - target), frame_mask)
    if loss_type == "mse":
        return masked_mean((pred - target) ** 2, frame_mask)
    if loss_type == "l1+mse":
        return (masked_mean(torch.abs(pred - target), frame_mask)
                + masked_mean((pred - target) ** 2, frame_mask))
    raise ValueError(f"Unknown loss type: {loss_type}")


def multi_resolution_stft_loss(pred_wav: torch.Tensor, target_wav: torch.Tensor,
                               fft_sizes: Sequence[int] = (512, 1024, 2048),
                               hop_sizes: Sequence[int] = (128, 256, 512),
                               win_sizes: Sequence[int] = (512, 1024, 2048)) -> torch.Tensor:
    """Spectral convergence plus log-magnitude L1 of ``[..., L]`` waveforms,
    averaged over the resolutions (periodic Hann, reflect centre padding,
    magnitudes ``sqrt(re^2 + im^2 + 1e-12)``). Through the plain
    differentiable STFT, not kernel K1, which has no backward: the JAX
    package takes its matmul STFT here for the same reason."""
    total = torch.zeros((), device=pred_wav.device)
    for n_fft, hop, win in zip(fft_sizes, hop_sizes, win_sizes):
        cfg = STFTConfig(n_fft=n_fft, hop_length=hop, win_length=win)
        re_p, im_p = stft(pred_wav, cfg)
        re_t, im_t = stft(target_wav, cfg)
        mp = torch.sqrt(re_p**2 + im_p**2 + 1e-12)
        mt = torch.sqrt(re_t**2 + im_t**2 + 1e-12)
        sc = torch.linalg.vector_norm(mt - mp) / torch.clamp(torch.linalg.vector_norm(mt),
                                                              min=1e-12)
        log_l1 = torch.abs(torch.log(mp + 1e-5) - torch.log(mt + 1e-5)).mean()
        total = total + sc + log_l1
    return total / len(fft_sizes)


def stoi_proxy_loss(pred: torch.Tensor, target: torch.Tensor,
                    frame_mask: Optional[torch.Tensor] = None,
                    sample_weight: Optional[torch.Tensor] = None,
                    count_sum: CountSum = None) -> torch.Tensor:
    """1 - cosine similarity of the flattened spectrograms, per sample,
    averaged (weighted by ``sample_weight``): the reference's
    differentiable "STOI" proxy."""
    b = pred.shape[0]
    p = pred.reshape(b, -1).float()
    t = target.reshape(b, -1).float()
    if frame_mask is not None:
        m = frame_mask[:, None, :, None].expand(pred.shape).reshape(b, -1)
        p = torch.where(m, p, 0.0)
        t = torch.where(m, t, 0.0)
    # F.normalize's clamp of the norm at 1e-12
    pn = p / torch.clamp(torch.linalg.vector_norm(p, dim=1, keepdim=True), min=1e-12)
    tn = t / torch.clamp(torch.linalg.vector_norm(t, dim=1, keepdim=True), min=1e-12)
    per_sample = 1.0 - (pn * tn).sum(dim=1)
    if sample_weight is None:
        w = torch.ones_like(per_sample) if count_sum is not None else None
        if w is None:
            return per_sample.mean()
    else:
        w = sample_weight.float()
    return (per_sample * w).sum() / torch.clamp(_count(w.sum(), count_sum), min=1.0)


def perceptual_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The reference's placeholder perceptual loss, an L1."""
    return torch.abs(pred - target).mean()


@dataclass(frozen=True)
class LossConfig:
    l1_weight: float = 1.0
    mse_weight: float = 0.0
    stoi_weight: float = 0.1
    perceptual_weight: float = 0.0
    log_l1_weight: float = 0.0  # blended log-magnitude L1, floored by log_eps
    log_eps: float = 1e-2
    use_log_compression: bool = False
    use_frame_mask: bool = False
    si_sdr_weight: float = 0.0  # applied by the trainer (needs phase and waveforms)

    @classmethod
    def from_config(cls, config: dict) -> "LossConfig":
        lc = config.get("training", config).get("loss", {})
        return cls(
            l1_weight=lc.get("l1_weight", 1.0),
            mse_weight=lc.get("mse_weight", 0.0),
            stoi_weight=lc.get("stoi_weight", 0.1),
            perceptual_weight=lc.get("perceptual_weight", 0.0),
            log_l1_weight=lc.get("log_l1_weight", 0.0),
            log_eps=lc.get("log_eps", 1e-2),
            use_log_compression=lc.get("use_log_compression", False),
            use_frame_mask=lc.get("use_frame_mask", False),
            si_sdr_weight=lc.get("si_sdr_weight", 0.0),
        )


def batch_si_sdr_db(ref: torch.Tensor, est: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    count_sum: CountSum = None) -> torch.Tensor:
    """Differentiable mean SI-SDR (dB) over the valid rows of ``[B, L]``
    waveforms, with eps floors so a silent row gives a large negative finite
    value rather than NaN."""
    ref = ref.float()
    est = est.float()
    ref = ref - ref.mean(dim=-1, keepdim=True)
    est = est - est.mean(dim=-1, keepdim=True)
    ref_energy = torch.clamp((ref * ref).sum(dim=-1), min=1e-8)
    alpha = (ref * est).sum(dim=-1) / ref_energy
    proj = alpha[:, None] * ref
    noise = est - proj
    ratio = (proj * proj).sum(dim=-1) / torch.clamp((noise * noise).sum(dim=-1), min=1e-8)
    si = 10.0 * torch.log10(torch.clamp(ratio, min=1e-8))
    if valid is None and count_sum is None:
        return si.mean()
    w = torch.ones_like(si) if valid is None else valid.float()
    return (si * w).sum() / torch.clamp(_count(w.sum(), count_sum), min=1.0)


def combined_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    cfg: LossConfig = LossConfig(),
    frame_mask: Optional[torch.Tensor] = None,
    sample_valid: Optional[torch.Tensor] = None,
    count_sum: CountSum = None,
) -> tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of the enabled losses over ``[B, F, T, C]`` and its
    components (``count_sum``: see the module docstring)."""
    mask = frame_mask if cfg.use_frame_mask else None
    if sample_valid is not None:
        row = sample_valid[:, None]
        mask = row.expand(pred.shape[0], pred.shape[2]) if mask is None else mask & row
    pred = pred.float()
    target = target.float()
    if cfg.use_log_compression:
        pred_in, target_in = log_compress(pred), log_compress(target)
    else:
        pred_in, target_in = pred, target
    components: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=pred.device)
    if cfg.l1_weight > 0:
        components["l1"] = masked_mean(torch.abs(pred_in - target_in), mask, count_sum)
        total = total + cfg.l1_weight * components["l1"]
    if cfg.mse_weight > 0:
        components["mse"] = masked_mean((pred_in - target_in) ** 2, mask, count_sum)
        total = total + cfg.mse_weight * components["mse"]
    if cfg.log_l1_weight > 0:
        components["log_l1"] = masked_mean(
            torch.abs(log_compress(pred, cfg.log_eps) - log_compress(target, cfg.log_eps)), mask,
            count_sum)
        total = total + cfg.log_l1_weight * components["log_l1"]
    if cfg.stoi_weight > 0:
        components["stoi"] = stoi_proxy_loss(pred, target, mask, sample_weight=sample_valid,
                                             count_sum=count_sum)
        total = total + cfg.stoi_weight * components["stoi"]
    if cfg.perceptual_weight > 0:
        components["perceptual"] = masked_mean(torch.abs(pred - target), None, count_sum)
        total = total + cfg.perceptual_weight * components["perceptual"]
    components["total"] = total
    return total, components


def create_loss_function(config: dict):
    """``loss_fn(pred, target, frame_mask=None, sample_valid=None) ->
    (total, components)`` from the config, with the config at
    ``loss_fn.config``."""
    cfg = LossConfig.from_config(config)

    def loss_fn(pred, target, frame_mask=None, sample_valid=None):
        return combined_loss(pred, target, cfg, frame_mask, sample_valid)

    loss_fn.config = cfg
    return loss_fn
