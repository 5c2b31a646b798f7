"""Self-contained end-to-end demo, the port's counterpart of the
repository's ``examples/demo.py``: build a small Hybrid ViT, synthesize a
tiny noisy/clean dataset, train briefly, enhance, report the SNR
improvement and plot the loss curves and one clip.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.demo \\
        [--epochs 5] [--files 16] [--device cuda|cpu] [--outdir DIR] [--data-root DIR]

``--device cuda`` (the default) trains and enhances through the CUDA
kernels; ``cpu`` through their plain versions. ``--data-root`` trains on the
training pairs of an existing VoiceBank-layout directory (``cli.synth_dataset``
writes one) instead of synthesizing ``--files`` pairs into ``OUTDIR/data``.
The plots need matplotlib; without it the demo says so and writes the rest.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np

from ._runtime import use_device

SR = 16000


def make_dataset(root: Path, n_files: int, seed: int = 0, sr: int = SR) -> None:
    """``n_files`` clean/noisy training pairs of 1-2 s under ``root`` in the
    VoiceBank layout: three harmonics of a random pitch, plus white noise."""
    from ..data.wavio import save_wav

    rng = np.random.default_rng(seed)
    for i in range(n_files):
        dur = int(sr * rng.uniform(1.0, 2.0))
        t = np.arange(dur) / sr
        f0 = rng.uniform(120, 320)
        clean = (
            0.5 * np.sin(2 * np.pi * f0 * t)
            + 0.25 * np.sin(2 * np.pi * 2.3 * f0 * t + 0.7)
            + 0.12 * np.sin(2 * np.pi * 4.1 * f0 * t)
        ).astype(np.float32)
        noisy = clean + 0.2 * rng.standard_normal(dur).astype(np.float32)
        save_wav(root / "clean_trainset_28spk_wav" / f"p{i:03d}.wav", clean, sr)
        save_wav(root / "noisy_trainset_28spk_wav" / f"p{i:03d}.wav", noisy, sr)


def demo_config(epochs: int, outdir: Path) -> dict:
    """The demo's training config (small batches, AdamW 2e-3 on a cosine
    schedule, L1 + 0.1 STOI loss, no augmentation, no early stopping)."""
    return {
        "data": {"sample_rate": SR, "train_val_split": 0.85,
                 "augmentation": {"enabled": False}},
        "audio": {"n_fft": 512, "hop_length": 128, "win_length": 512},
        "training": {
            "num_epochs": epochs,
            "batch_size": 8,
            "seed": 0,
            "optimizer": {"name": "adamw", "lr": 2e-3},
            "scheduler": {"name": "cosine", "min_lr": 1e-4},
            "loss": {"l1_weight": 1.0, "stoi_weight": 0.1},
            "early_stopping": {"enabled": False},
            "checkpoint": {"save_dir": str(outdir / "ckpt"), "save_every_n_epochs": 0},
            "logging": {"log_dir": str(outdir / "logs"), "use_tensorboard": False},
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--files", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--outdir", default=str(Path(tempfile.gettempdir()) / "sevit_demo"))
    ap.add_argument("--data-root", default=None,
                    help="train on this VoiceBank-layout directory's pairs")
    args = ap.parse_args(argv)
    use_device(args.device)

    import torch

    from ..data import DataLoader, VoiceBankDataset
    from ..data.wavio import save_wav
    from ..evaluation import compute_all_metrics, print_metrics
    from ..inference import AudioEnhancer
    from ..models import HybridViT, count_parameters, init_weights
    from ..training import Trainer

    outdir = Path(args.outdir)
    data_root = Path(args.data_root) if args.data_root else outdir / "data"
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"[demo] device: {args.device} ({name})")

    if args.data_root is None:
        print(f"[demo] synthesizing {args.files} training pairs ...")
        make_dataset(data_root, args.files)

    # small config close to the notebook's (256-dim / 4-head / 3-layer)
    model = init_weights(HybridViT(
        encoder_channels=(16, 32, 64),
        embed_dim=256,
        num_heads=4,
        num_layers=3,
        decoder_channels=(64, 32, 16, 1),
        dropout=0.0,
        attn_dropout=0.0,
        drop_path_rate=0.0,
        max_patches=4000,
    ), torch.Generator().manual_seed(0))
    config = demo_config(args.epochs, outdir)

    train_ds = VoiceBankDataset(data_root, "train", config)
    val_ds = VoiceBankDataset(data_root, "val", config)
    buckets = (128, 192, 256)
    trainer = Trainer(
        model,
        config,
        DataLoader(train_ds, batch_size=8, buckets=buckets, seed=0),
        DataLoader(val_ds, batch_size=8, buckets=buckets, shuffle=False),
        device=args.device,
    )
    print(f"[demo] model: {count_parameters(trainer.model)['total'] / 1e6:.2f}M params")

    print(f"[demo] training {args.epochs} epochs ...")
    history = trainer.train()
    print("[demo] train loss: " + " -> ".join(f"{v:.4f}" for v in history["train_loss"]))

    enhancer = AudioEnhancer(trainer.model, config, device=args.device, buckets=buckets)
    noisy, clean = train_ds.load_pair(0)
    enhanced = enhancer.enhance(noisy)
    for stem, wav in (("noisy", noisy), ("enhanced", enhanced), ("clean", clean)):
        save_wav(outdir / f"{stem}.wav", wav, SR)

    metrics = compute_all_metrics(clean, enhanced, noisy, include_pesq=False)
    print_metrics(metrics)
    print(
        f"[demo] SNR improvement: {metrics['snr_improvement']:+.2f} dB "
        f"(noisy {metrics['noisy_snr']:.2f} -> enhanced {metrics['snr']:.2f})"
    )

    from ..utils.visualization import plot_comparison, plot_loss_curves

    try:
        plot_loss_curves(history["train_loss"], history["val_loss"],
                         save_path=outdir / "loss.png")
        plot_comparison(noisy, clean, enhanced, save_path=outdir / "comparison.png")
    except ImportError as e:
        print(f"[demo] plots skipped: {e}")
    print(f"[demo] artifacts in {outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
