"""Worker processes of the port's multi-process CPU tests (not a test file).

``run_job`` starts one gloo process per rank with the port's launcher. Each
joins a ``file://`` rendezvous, runs the job's cases on its rank and saves
what they return to ``<out>/rank<r>.pt``. This module imports torch and the
port only: the test files, which import JAX (as ``tests/conftest.py`` does),
stay out of the workers.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.augmentation import (
    SpecAugmentConfig,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import HybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.parallel import (
    Mesh,
    initialize_distributed,
    launch,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.parallel.collectives import (
    all_reduce_,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.parallel.sharding import (
    gather_state_dict,
    tp_gather,
    unshard_model,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.losses import (
    LossConfig,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
    Trainer,
    make_step_fns,
    parallelize,
)

TIMEOUT = 240  # seconds for a whole job


class Capture:
    """Stands in for the optimizer: keeps the gradients it is handed."""

    def __init__(self, params):
        self.params = params
        self.grads = None

    def step(self, grads):
        self.grads = grads


def run_job(job: dict, data: int, model: int, tmp: Path) -> list:
    """Run ``job`` (``{"cases": [...]}``, and ``"device"``: every rank's, the
    CPU by default) on a ``data x model`` mesh of gloo processes; returns
    each rank's results."""
    tmp = Path(tmp)
    torch.save(job, tmp / "job.pt")
    rendezvous = tempfile.mkdtemp(dir=tmp)
    world = data * model
    launch(_worker, (data, model, f"file://{rendezvous}/store", str(tmp)), nprocs=world,
           timeout=TIMEOUT)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _worker(rank: int, data: int, model: int, init_method: str, tmp: str) -> None:
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False  # float32 end to end, as the tests' own process
    torch.backends.cuda.matmul.allow_tf32 = False
    job = torch.load(Path(tmp) / "job.pt", weights_only=False)
    device = torch.device(job.get("device", "cpu"))  # gloo runs on CUDA tensors too
    mesh = initialize_distributed(Mesh(data, model, (device,) * (data * model)),
                                  rank, backend="gloo", init_method=init_method, timeout=TIMEOUT)
    try:
        out = [CASES[case["kind"]](mesh, case) for case in job["cases"]]
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def exit_on_rank(rank: int, bad: int, code: int, sleep: float) -> None:
    """Exit with ``code`` on rank ``bad``; sleep ``sleep`` s on the others."""
    if rank == bad:
        raise SystemExit(code)
    time.sleep(sleep)


def _rows(batch: dict, mesh: Mesh, device: torch.device) -> dict:
    """This data rank's contiguous rows of the global batch (as the JAX
    mesh shards the batch axis), on ``device``."""
    n = len(batch["valid"]) // mesh.data
    return {k: torch.from_numpy(np.asarray(v[mesh.data_rank * n:(mesh.data_rank + 1) * n]))
            .to(device) for k, v in batch.items()}


def step_case(mesh: Mesh, case: dict) -> dict:
    """One train step of ``HybridViT(**case["model"])`` from
    ``case["state"]`` on this rank's rows of ``case["batch"]``, on
    ``case["device"]`` (default the CPU): the metrics, the gradients the
    optimizer is handed (gathered over the model axis), the new BatchNorm
    statistics, and with ``case["spec"]`` the eval-mode output on it first."""
    dev = torch.device(case.get("device", "cpu"))
    m = HybridViT(**case["model"])
    m.load_state_dict(case["state"])
    parallelize(m.to(dev), mesh, tensor_parallel=case.get("tensor_parallel", False))
    out = {}
    if "spec" in case:
        with torch.no_grad():
            out["forward"] = m.eval()(torch.from_numpy(case["spec"]).to(dev)).cpu()
    cap = Capture(list(m.parameters()))
    step, _ = make_step_fns(m, cap, LossConfig(**case["loss"]), STFTConfig(), SpecAugmentConfig(),
                            augment=False, mesh=mesh, **case["step"])
    out["metrics"] = {k: float(v) for k, v in step(_rows(case["batch"], mesh, dev)).items()}
    names = [n for n, _ in m.named_parameters()]
    out["grads"] = {n: tp_gather(n, g, mesh).cpu() for n, g in zip(names, cap.grads)}
    out["stats"] = {k: v.cpu() for k, v in gather_state_dict(m.state_dict(), mesh).items()
                    if "running" in k}
    return out


def dropout_case(mesh: Mesh, case: dict) -> dict:
    """The ``Trainer``'s random streams on this rank: the train-mode output of
    its model (dropouts 0.5) on one input shared by every rank, the mask of
    ``F.dropout`` drawn next from the default generator, and one draw from
    the tensor-parallel generator (None without one). Then its checkpoint:
    every rank saves to its own path (rank 0 alone writes), and a second
    ``Trainer`` resumes from rank 0's, a third from ``case["jax_checkpoint"]``
    where given; the gathered weights of each, and the output of the
    unsharded copy."""
    def trainer(resume=None):
        m = HybridViT(**case["model"])
        m.load_state_dict(case["state"])
        config = {"training": {"seed": 3, "logging": {"use_tensorboard": False}},
                  "mesh": {"use_tensor_parallel": True}}
        return Trainer(m, config, [], device="cpu", mesh=mesh, checkpoint_dir=case["dir"],
                       log_dir=case["dir"], resume_from=resume)

    tr = trainer()
    tr.model.train()
    with torch.no_grad():
        out = tr.model(torch.from_numpy(case["spec"]))
    tp = tr.model.transformer.blocks[0].attn.tp
    res = {"out": out, "default": F.dropout(torch.ones(4096), 0.5, True) > 0,
           "tp": None if tp is None else torch.rand(4096, generator=tp.generator)}
    tr.save(Path(case["dir"]) / f"saved_by_{mesh.rank}", 0)
    all_reduce_(torch.zeros(1), None)  # every rank waits for rank 0's write
    res["gathered"] = gather_state_dict(tr.model.state_dict(), mesh)
    with torch.no_grad():  # the one-device copy the audio samples enhance with
        res["unsharded"] = unshard_model(tr._detached_copy(), res["gathered"]).eval()(
            torch.from_numpy(case["spec"]))
    res["resumed"] = gather_state_dict(
        trainer(Path(case["dir"]) / "saved_by_0").model.state_dict(), mesh)
    if "jax_checkpoint" in case:  # the JAX trainer's format, optax state included
        res["from_jax"] = gather_state_dict(
            trainer(case["jax_checkpoint"]).model.state_dict(), mesh)
    return res


CASES = {"step": step_case, "dropout": dropout_case}
