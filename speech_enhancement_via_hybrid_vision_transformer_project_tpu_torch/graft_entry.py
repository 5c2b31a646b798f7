"""Single-card export check and multi-process dry run: the port's
counterpart of the repository's ``__graft_entry__.py``.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.graft_entry \\
        [--device cuda|cpu] [--ranks N]

``entry()`` gives the flagship forward (the 28M HybridViT with the
``fullres_mask`` head, mask output, ``compute_dtype=torch.bfloat16`` as the
port defines it: the input rounded once, every layer in float32) and its
example input; exporting it with ``utils.checkpoint.export_program`` is the
port's compile check (the JAX hook jits it). ``dryrun_multichip(n)`` runs
the JAX hook's sequence on a tiny model over ``n`` ranks, one process each
(``parallel.launch``; NCCL on ``n`` cards, gloo on the CPU), tensor-parallel
over 2 ranks when ``n`` is even: one train step, one eval step, the
short-shard validation (1 valid row, the rest padding), and a checkpoint
save -> load -> exact compare -> one resumed step.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

_FLAGSHIP = {"model": {"head": "fullres_mask", "output_mode": "mask"}}


def entry(device: str | torch.device = "cuda"):
    """``(module, example_args)``: the flagship forward in eval mode on
    ``device``, its weights seeded, and a ``[2, 257, 256, 1]`` input."""
    from .models import create_hybrid_vit, init_weights

    model = init_weights(create_hybrid_vit(_FLAGSHIP, compute_dtype=torch.bfloat16),
                         torch.Generator().manual_seed(0))
    return model.to(device).eval(), (torch.zeros(2, 257, 256, 1, device=device),)


def _tiny_model():
    """The JAX hook's dry-run model: tiny widths, the flagship head,
    attention dropout 0 so that attention runs through K2 and its heads are
    split under tensor parallelism."""
    from .models import HybridViT

    return HybridViT(
        encoder_channels=(4, 8, 16),
        embed_dim=64,
        num_heads=4,
        num_layers=2,
        decoder_channels=(16, 8, 4, 1),
        dropout=0.1,
        attn_dropout=0.0,
        drop_path_rate=0.1,
        max_patches=2000,
        head_type="fullres_mask",
        head_channels=4,
    )


def _dryrun_batch(batch_size: int) -> dict:
    """The JAX hook's batch: PCM16 noise of 63 hops (the 64-frame bucket),
    every row valid, from ``numpy.random.default_rng(0)``."""
    wav_len = 63 * 128
    rng = np.random.default_rng(0)

    def pcm(x):
        return np.clip(np.rint(x * 0.1 * 32768.0), -32768, 32767).astype(np.int16)

    return {
        "noisy_audio": pcm(rng.standard_normal((batch_size, wav_len))),
        "clean_audio": pcm(rng.standard_normal((batch_size, wav_len))),
        "length": np.full((batch_size,), wav_len, np.int32),
        "valid": np.ones((batch_size,), bool),
    }


def _rank_rows(batch: dict, mesh) -> dict:
    rows = len(batch["valid"]) // mesh.data
    lo = mesh.data_rank * rows
    return {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + rows])).to(mesh.device)
            for k, v in batch.items()}


def _dryrun_rank(rank: int, n: int, tp: int, device: str, init_method: str, tmp: str) -> None:
    """One rank of ``dryrun_multichip``."""
    from .data.augmentation import SpecAugmentConfig
    from .models import init_weights
    from .ops.stft import STFTConfig
    from .parallel import initialize_distributed, make_mesh, rank_seed
    from .parallel.sharding import gather_state_dict, tp_gather, tp_split
    from .training.losses import LossConfig
    from .training.optimizer import Optimizer, parameters
    from .training.trainer import make_step_fns, parallelize
    from .utils.checkpoint import load_checkpoint, save_checkpoint

    import torch.distributed as dist

    devices = ([torch.device("cuda", i) for i in range(n)] if device == "cuda"
               else [torch.device("cpu")] * n)
    mesh = initialize_distributed(make_mesh(n // tp, tp, devices), rank,
                                  backend="nccl" if device == "cuda" else "gloo",
                                  init_method=init_method)
    dev, main = mesh.device, rank == 0
    torch.manual_seed(rank_seed(0, mesh.data_rank))

    def fresh():
        gen = torch.Generator(device=dev).manual_seed(rank_seed(1, mesh.data_rank, mesh.model_rank))
        model = parallelize(init_weights(_tiny_model(), torch.Generator().manual_seed(0)).to(dev),
                            mesh, tensor_parallel=tp > 1, generator=gen if tp > 1 else None)
        opt = Optimizer.from_config(parameters(model), {})
        steps = make_step_fns(model, opt, LossConfig(), STFTConfig(), SpecAugmentConfig(),
                              output_mode="mask", mesh=mesh,
                              generator=torch.Generator(device=dev).manual_seed(
                                  rank_seed(2, mesh.data_rank)))
        return model, opt, *steps

    def finite(what: str, metrics: dict) -> float:
        total = float(metrics["total"])
        if not np.isfinite(total):
            raise AssertionError(f"non-finite {what} loss {total}")
        return total

    batch_size = mesh.data * 2
    batch = _dryrun_batch(batch_size)
    model, opt, train_step, eval_step = fresh()
    total = finite("train", train_step(_rank_rows(batch, mesh)))
    if main:
        print(f"dryrun_multichip train OK: mesh={mesh.shape} batch={batch_size} "
              f"loss={total:.4f}", flush=True)
    total_eval = finite("eval", eval_step(_rank_rows(batch, mesh)))
    if main:
        print(f"dryrun_multichip eval OK: loss={total_eval:.4f}", flush=True)

    # short-shard validation: 1 real clip, the rest padding rows of silence
    short = {k: v.copy() for k, v in batch.items()}
    short["valid"][1:] = False
    short["noisy_audio"][1:] = 0
    short["clean_audio"][1:] = 0
    total_short = finite("short-shard val", eval_step(_rank_rows(short, mesh)))
    if main:
        print(f"dryrun_multichip short-shard val OK: 1/{batch_size} valid rows "
              f"loss={total_short:.4f}", flush=True)

    # checkpoint (the tensor-parallel shards gathered, rank 0 writes) -> load
    # (each rank keeps its shard) -> exact compare -> one resumed step
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    sd, opt_sd = model.state_dict(), opt.state_dict()
    if tp > 1:
        sd = gather_state_dict(sd, mesh)
        opt_sd = {k: ([tp_gather(n, t, mesh) for n, t in zip(names, v)]
                      if isinstance(v, list) else v) for k, v in opt_sd.items()}
    path = Path(tmp) / "ckpt"
    if main:
        save_checkpoint(path, model, state_dict=sd, step=opt.count, optimizer_state=opt_sd,
                        best_val_loss=total)
    dist.barrier()
    r_model, r_opt, r_train_step, _ = fresh()
    shard = (lambda name, t: tp_split(name, t, tp, mesh.model_rank)) if tp > 1 else None
    step, r_opt_sd, meta = load_checkpoint(path, r_model, r_opt.name, shard=shard)
    r_opt.load_state_dict(r_opt_sd)
    if int(meta["epoch"]) != 0:
        raise AssertionError(f"restored epoch {meta['epoch']}")
    live = model.state_dict()
    for k, v in r_model.state_dict().items():
        if not k.endswith("num_batches_tracked") and not torch.equal(v, live[k]):
            raise AssertionError(f"restored {k} differs from the live weights")
    total2 = finite("post-resume", r_train_step(_rank_rows(batch, mesh)))
    if r_opt.count != step + 1 or step != 1:
        raise AssertionError(f"resumed at step {step}, now {r_opt.count}: not 1 then 2")
    if main:
        print(f"dryrun_multichip ckpt-resume OK: post-resume loss={total2:.4f} "
              f"step={r_opt.count}", flush=True)
    dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 600.0) -> None:
    """The JAX hook's dry run over ``n_devices`` ranks on ``device``
    (``cuda``: one card a rank, NCCL; ``cpu``: gloo), ``tp = 2`` when
    ``n_devices`` is even, else 1, and the rest on the data axis. Raises
    when a rank fails or the run outlasts ``timeout`` seconds."""
    from .parallel import launch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < n_devices):
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise RuntimeError(f"dryrun_multichip({n_devices}) on cuda: {visible} CUDA devices visible")
    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    with tempfile.TemporaryDirectory() as tmp:
        launch(_dryrun_rank, (n_devices, tp, device, f"file://{tmp}/rendezvous", tmp),
               nprocs=n_devices, timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=None,
                    help="dry-run ranks (default: the visible cards; 2 on the CPU)")
    args = ap.parse_args(argv)
    from .cli._runtime import use_device
    from .utils.checkpoint import export_program

    use_device(args.device)
    module, example = entry(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        export_program(Path(tmp) / "entry.pt2", module, example)
    with torch.no_grad():
        out = module(*example)
    print("entry OK:", tuple(out.shape), out.dtype, "(exported)", flush=True)
    ranks = args.ranks or (torch.cuda.device_count() if args.device == "cuda" else 2)
    dryrun_multichip(ranks, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
