"""Parallelism: the ``('data', 'model')`` mesh, one process per device, its
collectives, and the tensor-parallel sharding of the scaled ViT (JAX
``parallel/``)."""

from .launch import launch  # noqa: F401
from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    default_devices,
    initialize_distributed,
    local_batch_size,
    make_mesh,
    mesh_for_data_parallel,
    mesh_from_config,
    rank_seed,
)
from .sharding import (  # noqa: F401
    gather_state_dict,
    join_state_dicts,
    shard_model,
    split_state_dict,
    tp_param_specs,
    unshard_model,
)
