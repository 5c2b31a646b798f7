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
of the first epoch, whose ranges are the recorder's ``train.*`` spans
(``utils/tracing.py``).

The mesh (config ``mesh``, or ``--data-parallel`` and ``--model-parallel``;
``data_parallel: -1`` is every device: each visible card, or on the CPU one
device per host and model rank) runs one process per device, started here
with the ``spawn`` method, over NCCL on ``cuda`` and gloo on ``cpu``. The
batch size is the global one, and the ranks' rows together are the batch
the JAX CLI steps: on one host every data rank runs the loader over every
file and keeps its block of each batch's rows, padded to that batch's
bucket (``data/dataset.py``). Several hosts run this CLI with the same
flags and ``--coordinator host:port`` (process 0's rendezvous),
``--num-processes`` and their own ``--process-id``; a host's ranks are
``process_id x local devices + local device``, each host reads its stride
of the files in lockstep, as the JAX CLI's hosts do, and its data ranks
split its batches' rows. With one device there is one process, as without
a mesh.
"""

from __future__ import annotations

import argparse
import random
import shutil
import tempfile
from dataclasses import dataclass
from pathlib import Path

from ._runtime import use_device


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (the model's
    initialization and the trainer draw from their own ``torch.Generator``s)."""
    import numpy as np
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


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
                   help="write a torch.profiler Chrome trace of training steps 1-5 here, "
                        "with the train.* spans (train.step, train.featurize, ...) as ranges")
    p.add_argument("--mask-padding", action="store_true",
                   help="exclude bucket-padding patches from attention")
    p.add_argument("--pos-embed", default=None, choices=["learned_1d", "factored_2d", "sinusoidal"])
    p.add_argument("--output-mode", default=None, choices=["magnitude", "mask"])
    p.add_argument("--head", default=None, choices=["resize", "fullres_mask"])
    p.add_argument("--log-l1-weight", type=float, default=None)
    p.add_argument("--si-sdr-weight", type=float, default=None)
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (multi-host), or a file:// rendezvous path "
                        "every host sees")
    p.add_argument("--num-processes", type=int, default=None, help="number of hosts")
    p.add_argument("--process-id", type=int, default=None,
                   help="this host's index in [0, num-processes)")
    return p


@dataclass(frozen=True)
class MeshPlan:
    """The mesh (every rank's device), and the hosts that run it."""

    mesh: object  # parallel.Mesh, before any process joins it
    processes: int  # hosts
    process_id: int

    @property
    def local(self) -> int:
        """Ranks (devices) on each host."""
        return self.mesh.size // self.processes


def load_config(args):
    """The config directory's configs with the flags' overrides, validated."""
    from ..models import architecture
    from ..utils.config import load_all_configs, set_config_value, validate_config

    config = load_all_configs(args.config_dir)
    overrides = (
        ("data.data_root", args.data_root), ("training.num_epochs", args.epochs),
        ("training.batch_size", args.batch_size), ("training.optimizer.lr", args.lr),
        ("training.seed", args.seed), ("training.mask_padding", True if args.mask_padding else None),
        ("model.transformer.pos_embed", args.pos_embed), ("model.output_mode", args.output_mode),
        ("model.head", args.head), ("training.loss.log_l1_weight", args.log_l1_weight),
        ("training.loss.si_sdr_weight", args.si_sdr_weight),
        ("mesh.data_parallel", args.data_parallel), ("mesh.model_parallel", args.model_parallel),
    )
    for key, value in overrides:
        if value is not None:
            set_config_value(config, key, value)
    arch = architecture(config)
    if arch != "hybrid_vit":
        raise SystemExit(
            f"model.architecture {arch!r}: the train CLI trains the HybridViT only; CMGAN "
            "training (its metric discriminator with PESQ in the loop and a backward for its "
            "attention kernel K2r) is ROADMAP item 23")
    problems = validate_config(config)
    if problems:
        raise SystemExit("Invalid config:\n  " + "\n  ".join(problems))
    return config


def plan_mesh(args, config) -> MeshPlan:
    """``mesh_from_config`` over every host's devices: each visible card, or
    on the CPU one device per rank (``data_parallel: -1``: one per model
    rank). ``SystemExit`` where the mesh cannot be run: more cards than
    visible, axes the devices, hosts, batch or heads do not divide,
    multi-host flags missing."""
    import torch

    from ..parallel import mesh_from_config

    hosts = args.num_processes or 1
    if hosts > 1 and (not args.coordinator or args.process_id is None
                      or not 0 <= args.process_id < hosts):
        raise SystemExit(f"--num-processes {hosts} needs --coordinator host:port and "
                         f"--process-id in [0, {hosts})")
    if hosts == 1 and args.process_id:
        raise SystemExit(f"--process-id {args.process_id} needs --num-processes above it")
    mc = config.get("mesh", {})
    data, model = int(mc.get("data_parallel", -1)), max(int(mc.get("model_parallel", 1) or 1), 1)
    if args.device == "cuda":
        local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        local = [torch.device("cpu")] * model
    if data != -1:  # this host's share of the data x model devices
        if data < 1 or (data * model) % hosts:
            raise SystemExit(f"a {data}x{model} mesh cannot be split evenly over {hosts} hosts")
        per_host = data * model // hosts
        if args.device == "cuda" and per_host > len(local):
            raise SystemExit(f"the {data}x{model} mesh needs {per_host} CUDA devices on this "
                             f"host, but {len(local)} visible")
        local = local[:per_host] if args.device == "cuda" else [torch.device("cpu")] * per_host
    try:
        mesh = mesh_from_config(config, local * hosts)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if mesh.data % hosts:
        raise SystemExit(f"the data axis ({mesh.data}) must be a multiple of the hosts "
                         f"({hosts}): each host feeds whole data ranks")
    bs = config.get("training", {}).get("batch_size", 16)
    if bs % mesh.data:
        raise SystemExit(f"batch_size ({bs}) must be divisible by the data-parallel axis "
                         f"({mesh.data} devices); pass --batch-size or --data-parallel")
    heads = config.get("model", {}).get("transformer", {}).get("num_heads", 8)
    if heads % model:
        raise SystemExit(f"num_heads ({heads}) must be divisible by model_parallel ({model}): "
                         "tensor parallelism splits whole heads")
    return MeshPlan(mesh, hosts, args.process_id or 0)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    use_device(args.device)
    config = load_config(args)
    plan = plan_mesh(args, config)
    if plan.mesh.size == 1:
        return train(args, config)
    from ..parallel import launch

    if plan.processes > 1:
        # host:port of process 0's TCP store, or a shared file:// path
        rendezvous = args.coordinator if "://" in args.coordinator else f"tcp://{args.coordinator}"
        launch(worker, (args, config, plan, rendezvous), nprocs=plan.local,
               process_id=plan.process_id)
        return 0
    rendezvous = tempfile.mkdtemp(prefix="sevit-rendezvous-")
    try:
        launch(worker, (args, config, plan, f"file://{rendezvous}/store"), nprocs=plan.local)
    finally:
        shutil.rmtree(rendezvous, ignore_errors=True)
    return 0


def worker(rank: int, args, config, plan: MeshPlan, init_method: str) -> None:
    """One rank of the mesh: its device (``cuda:<local rank>``, or the CPU),
    the process group (NCCL on cuda, gloo on cpu), then ``train``."""
    import os

    import torch
    import torch.distributed as dist

    from ..parallel import initialize_distributed

    use_device(args.device)
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // plan.local))
    mesh = initialize_distributed(plan.mesh, rank,
                                  backend="nccl" if args.device == "cuda" else "gloo",
                                  init_method=init_method)
    try:
        train(args, config, mesh)
    finally:
        dist.destroy_process_group()


def train(args, config, mesh=None) -> int:
    """Train on this process's device (``mesh.device`` on a mesh)."""
    import torch

    from ..data.dataset import DataLoader, VoiceBankDataset
    from ..models import create_hybrid_vit, init_weights
    from ..training.trainer import Trainer

    say = print if mesh is None else (lambda msg: print(f"rank {mesh.rank}: {msg}", flush=True))
    tc = config.get("training", {})
    compute_dtype = (torch.bfloat16 if tc.get("use_amp", True) and config.get("tpu", {}).get(
        "compute_dtype", "bfloat16") == "bfloat16" else torch.float32)

    seed = tc.get("seed", 42)
    set_seed(seed)

    data_root = Path(config.get("data", {}).get("data_root", "data/voicebank_demand"))
    train_ds = VoiceBankDataset(data_root, "train", config)
    val_ds = VoiceBankDataset(data_root, "val", config)
    if args.max_files:
        train_ds.file_pairs = train_ds.file_pairs[: args.max_files]
        val_ds.file_pairs = val_ds.file_pairs[: max(args.max_files // 4, 1)]
    buckets = tuple(config.get("data", {}).get("bucketing", {}).get(
        "frame_buckets", (128, 256, 384, 512, 768, 1024)))
    # the JAX CLI's batches, their rows split over the data ranks: on one
    # host the global batches, each rank its block of their rows; on several
    # the JAX multi-host bookkeeping (each host's batch of global / hosts
    # rows in one bucket, as many train batches as the smallest host shard
    # fills, validation padded to the largest and dropped where a shard
    # would be empty), each of the host's data ranks its block of its rows
    batch_size = tc.get("batch_size", 16)
    fixed_bucket = train_max_batches = val_max_batches = part = None
    if mesh is not None and mesh.data > 1:
        hosts = args.num_processes or 1
        batch_size //= hosts
        if hosts > 1:
            fixed_bucket = buckets[-1]
            train_max_batches = (len(train_ds) // hosts) // batch_size
            largest_shard = -(-len(val_ds) // hosts)
            val_max_batches = -(-largest_shard // batch_size) if len(val_ds) >= hosts else 0
            if train_max_batches < 1:
                raise SystemExit(f"{len(train_ds)} train files cannot feed {hosts} hosts at "
                                 f"local batch {batch_size}")
            train_ds = train_ds.shard(args.process_id, hosts)
            val_ds = val_ds.shard(args.process_id, hosts)
        per_host = mesh.data // hosts
        part = (mesh.data_rank % per_host, per_host)
    say(f"train files: {len(train_ds)}  val files: {len(val_ds)}" + (
        f"  rows {part[0] * batch_size // part[1]}-{(part[0] + 1) * batch_size // part[1] - 1} "
        f"of each batch of {batch_size}" if part else ""))
    # PCM16 batches halve the host-to-device bytes on the card (the sources
    # are PCM16 WAVs); 'auto' keeps float32 on the CPU
    tdtype = tc.get("transfer_dtype", "auto")
    if tdtype == "auto":
        tdtype = "int16" if args.device == "cuda" else "float32"
    loader_kw = dict(batch_size=batch_size, num_workers=tc.get("num_workers", 4),
                     buckets=buckets, transfer_dtype=tdtype, fixed_bucket=fixed_bucket, part=part)
    train_loader = DataLoader(train_ds, seed=seed, max_batches=train_max_batches, **loader_kw)
    val_loader = DataLoader(val_ds, shuffle=False, max_batches=val_max_batches or None,
                            **loader_kw) if len(val_ds) and val_max_batches != 0 else None
    if val_max_batches == 0:
        say("warning: validation set smaller than the host count — skipping validation "
            "(best_model tracks the train loss)")

    model = init_weights(create_hybrid_vit(config, compute_dtype=compute_dtype),
                         torch.Generator().manual_seed(seed))
    say(f"compute dtype: {compute_dtype} (the input rounded to it; layers in float32)")
    if mesh is not None:
        say(f"mesh: {mesh.shape} on {mesh.device}")
    trainer = Trainer(model, config, train_loader, val_loader,
                      device=args.device if mesh is None else mesh.device, mesh=mesh,
                      checkpoint_dir=args.checkpoint_dir, log_dir=args.log_dir,
                      resume_from=args.resume, profile_dir=args.profile_dir)
    trainer.train()
    trainer.logger.close()
    say(f"done: best val loss {trainer.best_val_loss:.5f} after {trainer.current_epoch} epochs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
