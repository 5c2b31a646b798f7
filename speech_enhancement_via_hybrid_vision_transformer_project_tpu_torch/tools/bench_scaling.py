"""Data-parallel weak scaling of the train step (the port's
``benchmarks/bench_scaling.py``, with its model and flags).

Runs the train step (``training.trainer.make_step_fns`` on a data mesh:
BatchNorm synced, gradients all-reduced) over 1, 2, 4, ... data ranks with
the per-rank batch held constant, and reports each world size's step time
and its efficiency against one rank (ideal 100%). Each world size is its own
set of processes, one a rank, started by ``parallel.launch``; every rank
steps the same numpy batch's own rows, as the JAX script steps one host
batch.

``--device cuda`` (the default) runs one rank a visible card over NCCL, up
to every visible card (or ``--max-ranks``); each rank's step is timed on the
host clock around ``--iters`` steps that end in a synchronize, after one
warm-up step. ``--device cpu`` runs gloo ranks (up to 8, the JAX script's
virtual CPU devices, or ``--max-ranks``): a functional check of the
collectives, as the JAX script's ``--device cpu``, with no time.

The model is the JAX script's small HybridViT (encoder 16/32/64, embed 256,
8 heads, 4 layers, decoder 64/32/16/1, dropouts 0.1: attention takes the
explicit-weights path, so kernel K1 runs in featurize and K2 does not).

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.bench_scaling \\
        [--device cuda|cpu] [--per-device-batch 4] [--frames 128] [--iters 10] [--max-ranks N]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

TIMEOUT = 900.0  # seconds a world size may take, its start-up included


def scaling_model():
    from ..models import HybridViT

    return HybridViT(encoder_channels=(16, 32, 64), embed_dim=256, num_heads=8, num_layers=4,
                     decoder_channels=(64, 32, 16, 1), max_patches=4000)


def rank_main(rank: int, world: int, device: str, per_device_batch: int, frames: int,
              iters: int, tmp: str) -> None:
    """One rank: joins the ``world``-rank data mesh, steps its rows of the
    global batch ``iters`` times after one warm-up step, and writes its ms a
    step (None on the CPU) and the launches of its timed steps to
    ``<tmp>/rank<r>.json``."""
    import torch.distributed as dist

    from ..data.augmentation import SpecAugmentConfig
    from ..models import init_weights
    from ..ops import kernels
    from ..ops.stft import STFTConfig
    from ..parallel import initialize_distributed, make_mesh, rank_seed
    from ..training.losses import LossConfig
    from ..training.optimizer import Optimizer, parameters
    from ..training.trainer import make_step_fns, parallelize

    cuda = device == "cuda"
    if cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    devices = [torch.device("cuda", r) if cuda else torch.device("cpu") for r in range(world)]
    mesh = initialize_distributed(make_mesh(world, 1, devices), rank,
                                  backend="nccl" if cuda else "gloo",
                                  init_method=f"file://{tmp}/store", timeout=TIMEOUT)
    try:
        dev = mesh.device
        torch.manual_seed(rank_seed(0, mesh.data_rank))
        model = parallelize(init_weights(scaling_model(), torch.Generator().manual_seed(0)).to(dev),
                            mesh)
        opt = Optimizer(parameters(model), "adamw", lr=1e-4, weight_decay=0.01, max_norm=1.0)
        aug = torch.Generator(device=dev).manual_seed(rank_seed(1, mesh.data_rank))
        step, _ = make_step_fns(model, opt, LossConfig(), STFTConfig(), SpecAugmentConfig(),
                                generator=aug, mesh=mesh)
        # the global batch from the JAX script's numpy stream; this rank's rows
        b = per_device_batch * world
        wav_len = (frames - 1) * STFTConfig().hop_length
        rng = np.random.default_rng(0)
        noisy = rng.standard_normal((b, wav_len)).astype(np.float32)
        clean = rng.standard_normal((b, wav_len)).astype(np.float32)
        rows = slice(rank * per_device_batch, (rank + 1) * per_device_batch)
        batch = {"noisy_audio": torch.from_numpy(noisy[rows]).to(dev),
                 "clean_audio": torch.from_numpy(clean[rows]).to(dev),
                 "length": torch.full((per_device_batch,), wav_len, dtype=torch.int32, device=dev),
                 "valid": torch.ones(per_device_batch, dtype=torch.bool, device=dev)}
        loss = float(step(batch)["total"])  # warm-up
        kernels.reset_launch_counts()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = iters if cuda else 1
        for _ in range(n):
            metrics = step(batch)
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3 if cuda else None
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps({
            "ms": ms, "loss": loss, "last_loss": float(metrics["total"]),
            "launches": {k: v.launches / n for k, v in kernels.KERNELS.items()}}))
    finally:
        dist.destroy_process_group()


def world_sizes(device: str, max_ranks: int | None) -> list:
    if device == "cuda":
        limit = torch.cuda.device_count()
        if max_ranks is not None:
            limit = min(limit, max_ranks)
    else:
        limit = max_ranks or 8
    return [d for d in (1, 2, 4, 8, 16, 32) if d <= limit]


def run(device: str, per_device_batch: int = 4, frames: int = 128, iters: int = 10,
        max_ranks: int | None = None) -> list:
    """Each world size's ranks' results (``rank_main``), in order."""
    from ..parallel import launch
    from .bench_scaling import rank_main as target  # by its module's name, also under -m

    out = []
    for world in world_sizes(device, max_ranks):
        with tempfile.TemporaryDirectory() as tmp:
            launch(target, (world, device, per_device_batch, frames, iters, tmp),
                   nprocs=world, timeout=TIMEOUT)
            out.append([json.loads((Path(tmp) / f"rank{r}.json").read_text())
                        for r in range(world)])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--per-device-batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--max-ranks", type=int, default=None,
                    help="the largest world size (default: every visible card; 8 on cpu)")
    args = ap.parse_args(argv)

    from ..cli._runtime import use_device
    from .flops import card_line, describe_device

    use_device(args.device)
    sizes = world_sizes(args.device, args.max_ranks)
    print(f"{'cards' if args.device == 'cuda' else 'gloo ranks'} available: "
          f"{torch.cuda.device_count() if args.device == 'cuda' else args.max_ranks or 8}; "
          f"testing {sizes}; {card_line(describe_device(args.device))}")
    base = None
    for ranks in run(args.device, args.per_device_batch, args.frames, args.iters, args.max_ranks):
        nd = len(ranks)
        ms = max(r["ms"] for r in ranks) if ranks[0]["ms"] is not None else None
        losses = sorted({round(r["last_loss"], 6) for r in ranks})
        if ms is None:
            print(f"devices={nd:>2}  global_batch={args.per_device_batch * nd:>3}  step=not "
                  f"measured (cpu)  loss {losses}")
            continue
        base = base or ms
        print(f"devices={nd:>2}  global_batch={args.per_device_batch * nd:>3}  step={ms:8.2f} ms  "
              f"weak-scaling efficiency={100 * base / ms:5.1f}%  loss {losses}  launches a step "
              f"{ranks[0]['launches']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
