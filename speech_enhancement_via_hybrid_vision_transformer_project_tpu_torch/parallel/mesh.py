"""The ``('data', 'model')`` device mesh (JAX ``parallel/mesh.py``), one
process per device.

The JAX package runs one SPMD program over a ``jax.sharding.Mesh``: the
batch sharded over ``data``, the scaled ViT's weights over ``model``, and
XLA inserting the collectives. Here every device of the mesh is driven by
its own process (``parallel/launch.py`` starts them), and the collectives are
explicit: ``torch.distributed`` process groups, ``all_reduce`` and
``broadcast`` only (the two collectives gloo runs on CUDA tensors as well as
on CPU ones). A process's rank is its device's index in the mesh, model
index innermost (the JAX layout), so rank ``r`` sits at data index
``r // model`` and model index ``r % model``.

Each rank holds two groups: ``data_group``, the ranks that hold the same
model shard (gradients, BatchNorm statistics and loss denominators are
summed over it), and ``model_group``, the ranks that hold the same data
shard (tensor parallelism's collectives). Inference uses a mesh without
process groups: one replica of the model per data-axis device, in one
process (``inference/enhancer.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from datetime import timedelta
from typing import Optional, Sequence

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """``data x model`` devices (``devices[r]`` is rank ``r``'s), this
    process's rank, and its two process groups (None outside a
    ``torch.distributed`` run)."""

    data: int
    model: int
    devices: tuple
    rank: int = 0
    data_group: Optional[object] = field(default=None, compare=False)
    model_group: Optional[object] = field(default=None, compare=False)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def replicas(self) -> list:
        """The data axis's devices (model index 0): one inference replica each."""
        return [self.devices[i * self.model] for i in range(self.data)]


def default_devices() -> list:
    """Every visible CUDA device, or the one CPU device where there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(data_parallel: int = -1, model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``data x model`` mesh over ``devices`` (default: ``default_devices()``).
    ``data_parallel=-1`` puts every device not on the model axis on the data
    axis. Raises ``ValueError`` as the JAX ``make_mesh`` does."""
    devices = [torch.device(d) for d in (devices if devices is not None else default_devices())]
    n = len(devices)
    if model_parallel <= 0:
        model_parallel = 1
    if n % model_parallel != 0:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n} devices")
    if data_parallel == -1:
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} != {n} devices")
    return Mesh(data_parallel, model_parallel, tuple(devices))


def mesh_for_data_parallel(n: Optional[int], device: str = "cuda") -> Optional[Mesh]:
    """The inference CLIs' ``--data-parallel N``: ``cuda:0`` .. ``cuda:N-1``
    (``ValueError`` naming both counts where fewer are visible), or N times
    the CPU device; None for N <= 1 (one device, no mesh)."""
    if n is None or n <= 1:
        return None
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > visible:
            raise ValueError(f"data parallelism over {n} CUDA devices asked for, "
                             f"but {visible} visible")
        return make_mesh(n, 1, [torch.device("cuda", i) for i in range(n)])
    return make_mesh(n, 1, [torch.device(device)] * n)


def mesh_from_config(config: dict, devices: Optional[Sequence] = None) -> Mesh:
    """``make_mesh`` from the config's ``mesh`` section."""
    mc = config.get("mesh", {})
    return make_mesh(mc.get("data_parallel", -1), mc.get("model_parallel", 1), devices)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Rows of the global batch on each data rank."""
    if global_batch % mesh.data != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {mesh.data}")
    return global_batch // mesh.data


def initialize_distributed(mesh: Mesh, rank: int, *, backend: str, init_method: str,
                           timeout: float = 1800.0) -> Mesh:
    """Join the ``mesh.size``-process group as ``rank`` (``backend``: ``nccl``
    for CUDA devices, ``gloo`` for the CPU; ``init_method``:
    ``tcp://host:port`` or ``file:///path``) and return the mesh with this
    rank and its data and model groups. Every rank creates every group, in
    the same order, as ``new_group`` requires."""
    import torch.distributed as dist

    dev = mesh.devices[rank]
    if dev.type == "cuda" and dev.index is not None:  # (no index: the current device)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=mesh.size, rank=rank,
                            timeout=timedelta(seconds=timeout))
    data_group = model_group = None
    for m in range(mesh.model):
        g = dist.new_group([d * mesh.model + m for d in range(mesh.data)])
        if rank % mesh.model == m:
            data_group = g
    for d in range(mesh.data):
        g = dist.new_group([d * mesh.model + m for m in range(mesh.model)])
        if rank // mesh.model == d:
            model_group = g
    return replace(mesh, rank=rank, data_group=data_group, model_group=model_group)


def rank_seed(seed: int, data_rank: int, model_rank: Optional[int] = None) -> int:
    """The seed of a rank's random stream: ``seed`` itself on data rank 0,
    another for each data rank, and with ``model_rank`` one more for each
    model rank (the tensor-parallel stream of dropout on a rank's own shard).
    Ranks that hold the same data shard share the stream without
    ``model_rank``, so dropout after a tensor-parallel reduce, drop-path and
    SpecAugment draw the same masks on each of them."""
    s = seed + 1_000_003 * data_rank
    return s if model_rank is None else s + 7_919 * (model_rank + 1)
