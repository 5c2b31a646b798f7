"""Training CLI (the JAX ``cli/train.py``'s flags), on a CUDA card or the CPU.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.train \\
        --config-dir config --data-root data/voicebank_demand --device cuda

The config directory holds the three YAML files of ``config/``; the shipped
ones train as they are. ``compute_dtype`` is chosen as the JAX CLI chooses
it: bf16 when ``training.use_amp`` and ``tpu.compute_dtype: bfloat16`` (the
shipped config), else float32. bf16 means what it means in the JAX package:
the model's input is rounded to bf16 once and every layer computes in
float32 (``models/hybrid_vit.py``). ``tpu.remat`` (or
``model.transformer.remat``) rematerializes the transformer blocks.
``tpu.use_pallas_attention`` is ignored: on the card attention is always
kernel K2. ``--profile-dir`` writes a ``torch.profiler`` trace of steps 1-5
of the first epoch. Data and model parallelism and multi-host training are
not ported yet and are refused (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

from ._runtime import use_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the Hybrid ViT speech enhancer (PyTorch)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--config-dir", default="config", help="YAML config dir")
    p.add_argument("--data-root", default=None, help="VoiceBank-DEMAND root")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max-files", type=int, default=None, help="truncate the dataset (smoke runs)")
    p.add_argument("--data-parallel", type=int, default=None)
    p.add_argument("--model-parallel", type=int, default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of training steps 1-5 here")
    p.add_argument("--mask-padding", action="store_true",
                   help="exclude bucket-padding patches from attention")
    p.add_argument("--pos-embed", default=None, choices=["learned_1d", "factored_2d", "sinusoidal"])
    p.add_argument("--output-mode", default=None, choices=["magnitude", "mask"])
    p.add_argument("--head", default=None, choices=["resize", "fullres_mask"])
    p.add_argument("--log-l1-weight", type=float, default=None)
    p.add_argument("--si-sdr-weight", type=float, default=None)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if (args.data_parallel or 1) > 1 or (args.model_parallel or 1) > 1 or (
            args.num_processes or 1) > 1 or args.coordinator or args.process_id is not None:
        raise SystemExit("data/model parallelism and multi-host training are not ported yet "
                         "(ROADMAP queue 1 item 10): train on one device")

    import numpy as np
    import torch

    from ..data.dataset import DataLoader, VoiceBankDataset
    from ..models import create_hybrid_vit, init_weights
    from ..training.trainer import Trainer
    from ..utils.config import load_all_configs, set_config_value, validate_config

    use_device(args.device)

    config = load_all_configs(args.config_dir)
    overrides = (
        ("data.data_root", args.data_root), ("training.num_epochs", args.epochs),
        ("training.batch_size", args.batch_size), ("training.optimizer.lr", args.lr),
        ("training.seed", args.seed), ("training.mask_padding", True if args.mask_padding else None),
        ("model.transformer.pos_embed", args.pos_embed), ("model.output_mode", args.output_mode),
        ("model.head", args.head), ("training.loss.log_l1_weight", args.log_l1_weight),
        ("training.loss.si_sdr_weight", args.si_sdr_weight),
    )
    for key, value in overrides:
        if value is not None:
            set_config_value(config, key, value)
    problems = validate_config(config)
    if problems:
        raise SystemExit("Invalid config:\n  " + "\n  ".join(problems))
    tc = config.get("training", {})
    compute_dtype = (torch.bfloat16 if tc.get("use_amp", True) and config.get("tpu", {}).get(
        "compute_dtype", "bfloat16") == "bfloat16" else torch.float32)

    seed = tc.get("seed", 42)
    random.seed(seed)
    np.random.seed(seed)

    data_root = Path(config.get("data", {}).get("data_root", "data/voicebank_demand"))
    train_ds = VoiceBankDataset(data_root, "train", config)
    val_ds = VoiceBankDataset(data_root, "val", config)
    if args.max_files:
        train_ds.file_pairs = train_ds.file_pairs[: args.max_files]
        val_ds.file_pairs = val_ds.file_pairs[: max(args.max_files // 4, 1)]
    print(f"train files: {len(train_ds)}  val files: {len(val_ds)}")
    buckets = tuple(config.get("data", {}).get("bucketing", {}).get(
        "frame_buckets", (128, 256, 384, 512, 768, 1024)))
    # PCM16 batches halve the host-to-device bytes on the card (the sources
    # are PCM16 WAVs); 'auto' keeps float32 on the CPU
    tdtype = tc.get("transfer_dtype", "auto")
    if tdtype == "auto":
        tdtype = "int16" if args.device == "cuda" else "float32"
    loader_kw = dict(batch_size=tc.get("batch_size", 16), num_workers=tc.get("num_workers", 4),
                     buckets=buckets, transfer_dtype=tdtype)
    train_loader = DataLoader(train_ds, seed=seed, **loader_kw)
    val_loader = DataLoader(val_ds, shuffle=False, **loader_kw) if len(val_ds) else None

    model = init_weights(create_hybrid_vit(config, compute_dtype=compute_dtype),
                         torch.Generator().manual_seed(seed))
    print(f"compute dtype: {compute_dtype} (the input rounded to it; layers in float32)")
    trainer = Trainer(model, config, train_loader, val_loader, device=args.device,
                      checkpoint_dir=args.checkpoint_dir, log_dir=args.log_dir,
                      resume_from=args.resume, profile_dir=args.profile_dir)
    trainer.train()
    trainer.logger.close()
    print(f"done: best val loss {trainer.best_val_loss:.5f} after {trainer.current_epoch} epochs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
