"""Plots (the JAX ``utils/visualization.py``): waveforms, dB spectrograms,
noisy/clean/enhanced grids, loss curves, attention heatmaps and metric bars.

matplotlib is imported by each plot, with the headless Agg backend, so this
module imports without it; a plot call without matplotlib raises
``ImportError``. Spectrograms come from the port's ``ops.stft.stft``.
Each function returns the figure, or writes it to ``save_path`` and returns
the path.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.stft import STFTConfig, magphase, stft


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save_or_return(plt, fig, save_path):
    if save_path is None:
        return fig
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return save_path


def _to_db(mag: np.ndarray, floor_db: float = -80.0) -> np.ndarray:
    ref = max(float(np.max(mag)), 1e-10)
    return np.maximum(20.0 * np.log10(np.maximum(mag, 1e-10) / ref), floor_db)


def plot_waveform(audio: np.ndarray, sample_rate: int = 16000, title: str = "Waveform",
                  save_path=None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 3))
    ax.plot(np.arange(len(audio)) / sample_rate, audio, linewidth=0.5)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Amplitude")
    ax.set_title(title)
    ax.grid(alpha=0.3)
    return _save_or_return(plt, fig, save_path)


def plot_spectrogram(audio_or_mag: np.ndarray, sample_rate: int = 16000,
                     stft_config: STFTConfig = STFTConfig(), title: str = "Spectrogram",
                     save_path=None, ax=None):
    """dB spectrogram of a waveform ``[L]`` or a magnitude ``[F, T]``; drawn
    on ``ax`` when given (and ``ax`` returned)."""
    plt = _plt()
    if audio_or_mag.ndim == 1:
        x = torch.as_tensor(np.asarray(audio_or_mag, np.float32))
        mag = magphase(*stft(x, stft_config))[0].numpy()
    else:
        mag = np.asarray(audio_or_mag)
    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(10, 4))
    else:
        fig = ax.figure
    extent = [0, mag.shape[1] * stft_config.hop_length / sample_rate, 0,
              sample_rate / 2 / 1000.0]
    image = ax.imshow(_to_db(mag), origin="lower", aspect="auto", extent=extent, cmap="magma")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Frequency (kHz)")
    ax.set_title(title)
    if own_fig:
        fig.colorbar(image, ax=ax, format="%+2.0f dB")
        return _save_or_return(plt, fig, save_path)
    return ax


def plot_comparison(noisy: np.ndarray, clean: np.ndarray, enhanced: np.ndarray,
                    sample_rate: int = 16000, stft_config: STFTConfig = STFTConfig(),
                    save_path=None):
    """3x2 grid: waveform and spectrogram of noisy, clean and enhanced."""
    plt = _plt()
    fig, axes = plt.subplots(3, 2, figsize=(14, 10))
    for row, (name, sig) in enumerate(zip(("Noisy", "Clean", "Enhanced"),
                                          (noisy, clean, enhanced))):
        axes[row, 0].plot(np.arange(len(sig)) / sample_rate, sig, linewidth=0.4)
        axes[row, 0].set_title(f"{name} waveform")
        axes[row, 0].set_xlabel("Time (s)")
        plot_spectrogram(sig, sample_rate, stft_config, title=f"{name} spectrogram",
                         ax=axes[row, 1])
    fig.tight_layout()
    return _save_or_return(plt, fig, save_path)


def plot_loss_curves(train_losses: Sequence[float],
                     val_losses: Optional[Sequence[float]] = None,
                     title: str = "Training Progress", save_path=None):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(train_losses, label="train")
    if val_losses is not None:
        ax.plot(val_losses, label="val")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss")
    ax.set_title(title)
    ax.legend()
    ax.grid(alpha=0.3)
    return _save_or_return(plt, fig, save_path)


def plot_attention_map(attention: np.ndarray, head: int = 0, title: str = "Attention",
                       save_path=None):
    """Heatmap of one head's ``[N, N]`` attention, from ``[N, N]``,
    ``[H, N, N]`` or ``[B, H, N, N]`` (first batch element)."""
    plt = _plt()
    a = np.asarray(attention)
    while a.ndim > 2:
        a = a[0] if a.shape[0] != a.shape[-1] or a.ndim > 3 else a[head]
        if a.ndim == 3:
            a = a[head]
    fig, ax = plt.subplots(figsize=(6, 5))
    image = ax.imshow(a, cmap="viridis", aspect="auto")
    ax.set_xlabel("Key position")
    ax.set_ylabel("Query position")
    ax.set_title(title)
    fig.colorbar(image, ax=ax)
    return _save_or_return(plt, fig, save_path)


def plot_metrics_comparison(metrics: Dict[str, Dict[str, float]], title: str = "Metrics",
                            save_path=None):
    """Bars of ``{metric: {"noisy": x, "enhanced": y}}``, or of flat means."""
    plt = _plt()
    keys = list(metrics)
    fig, ax = plt.subplots(figsize=(max(6, len(keys) * 1.2), 5))
    x = np.arange(len(keys))
    if keys and isinstance(next(iter(metrics.values())), dict):
        ax.bar(x - 0.2, [metrics[k].get("noisy", np.nan) for k in keys], width=0.4,
               label="noisy")
        ax.bar(x + 0.2, [metrics[k].get("enhanced", np.nan) for k in keys], width=0.4,
               label="enhanced")
        ax.legend()
    else:
        ax.bar(x, [float(metrics[k]) for k in keys], width=0.6)
    ax.set_xticks(x)
    ax.set_xticklabels(keys, rotation=30, ha="right")
    ax.set_title(title)
    ax.grid(alpha=0.3, axis="y")
    return _save_or_return(plt, fig, save_path)
