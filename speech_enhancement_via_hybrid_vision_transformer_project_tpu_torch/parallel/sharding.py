"""Tensor parallelism for the scaled ViT (JAX ``parallel/sharding.py``).

The JAX package shards, in each standard transformer block, the qkv and MLP
``Dense_0`` kernels and biases by output column and the attention output
projection's and MLP ``Dense_1`` kernels by input row; everything else is
replicated (``_tp_spec_for``). The port shards the same leaves, under their
``state_dict`` names (torch ``Linear`` weights are ``[out, in]``):

* ``attn.qkv.weight`` ``[3D, D]`` and ``.bias`` ``[3D]``: whole heads. Rank
  ``m`` of ``p`` takes the ``m``-th ``p``-th of q's rows, of k's and of v's,
  so that it computes attention on its own heads. (JAX splits the ``[D, 3D]``
  kernel into contiguous blocks and XLA's partitioner inserts the
  collectives that make that layout right; a rank computing attention on
  its own needs whole heads.)
* ``attn.proj.weight`` and ``mlp.fc2.weight``: by input column (dim 1).
* ``mlp.fc1.weight`` and ``.bias``: by output row (dim 0).

``attn.proj.bias`` and ``mlp.fc2.bias`` stay whole and are added after the
reduce. The linear-attention branch (``lin_attn_i``, ``lin_mlp_i``) stays
replicated: the same arithmetic, run whole on every model rank (a limit of
the port; JAX shards its kernels too). Heads must divide by the model axis.

``shard_model`` shards a model in place and wires its blocks' ``tp``;
``split_state_dict`` / ``join_state_dicts`` are the pure splitter and joiner
of full and per-rank state dicts, ``gather_state_dict`` the collective one
(every model rank takes part; checkpoints are written gathered, as the JAX
trainer writes them), and ``unshard_model`` puts full weights back.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import torch

from .collectives import TPGroup, all_reduce_
from .mesh import Mesh

_BLOCK = r"^transformer\.blocks\.\d+\."
_SPECS = (
    (re.compile(_BLOCK + r"attn\.qkv\.(weight|bias)$"), "heads"),
    (re.compile(_BLOCK + r"attn\.proj\.weight$"), 1),
    (re.compile(_BLOCK + r"mlp\.fc1\.(weight|bias)$"), 0),
    (re.compile(_BLOCK + r"mlp\.fc2\.weight$"), 1),
)


def tp_spec(name: str):
    """How the ``state_dict`` entry ``name`` splits: ``"heads"`` (q, k and v
    each split along dim 0), 0 or 1 (the dim split), or None (replicated)."""
    for pat, spec in _SPECS:
        if pat.match(name):
            return spec
    return None


def tp_param_specs(names: Sequence[str]) -> Dict[str, object]:
    """``tp_spec`` of every name (a ``state_dict`` or its keys)."""
    return {n: tp_spec(n) for n in names}


def _slot(full: torch.Tensor, spec, parts: int, index: int) -> torch.Tensor:
    """The view of ``full`` that shard ``index`` of ``parts`` covers."""
    if spec == "heads":
        thirds = full.view(3, full.shape[0] // 3, *full.shape[1:])
        k = thirds.shape[1] // parts
        return thirds[:, index * k:(index + 1) * k]
    k = full.shape[spec] // parts
    return full.narrow(spec, index * k, k)


def tp_split(name: str, full: torch.Tensor, parts: int, index: int) -> torch.Tensor:
    """Shard ``index`` of ``parts`` of the entry ``name`` (a copy)."""
    spec = tp_spec(name)
    if spec is None or parts == 1:
        return full
    shard = _slot(full, spec, parts, index)
    return shard.reshape(-1, *full.shape[1:]).clone() if spec == "heads" else shard.clone()


def tp_join(name: str, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The full entry ``name`` from its shards in rank order."""
    spec = tp_spec(name)
    if spec is None or len(shards) == 1:
        return shards[0]
    if spec == "heads":
        parts = [s.reshape(3, s.shape[0] // 3, *s.shape[1:]) for s in shards]
        return torch.cat(parts, dim=1).reshape(-1, *shards[0].shape[1:])
    return torch.cat(list(shards), dim=spec)


def tp_gather(name: str, shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full entry ``name`` on every model rank: each rank writes its shard
    into a zero-filled full tensor, and an ``all_reduce`` over the model
    group sums them."""
    spec = tp_spec(name)
    if spec is None or mesh.model == 1:
        return shard
    shape = list(shard.shape)
    shape[0 if spec == "heads" else spec] *= mesh.model
    full = shard.new_zeros(shape)
    slot = _slot(full, spec, mesh.model, mesh.model_rank)
    slot.copy_(shard.reshape(slot.shape))
    return all_reduce_(full, mesh.model_group)


def split_state_dict(sd: Dict[str, torch.Tensor], parts: int, index: int) -> Dict[str, torch.Tensor]:
    return {k: tp_split(k, v, parts, index) for k, v in sd.items()}


def join_state_dicts(sds: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: tp_join(k, [sd[k] for sd in sds]) for k in sds[0]}


def gather_state_dict(sd: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    return {k: tp_gather(k, v, mesh) for k, v in sd.items()}


def _blocks(model: torch.nn.Module) -> list:
    transformer = model.transformer
    return [] if transformer.linear else list(transformer.blocks)


@torch.no_grad()
def shard_model(model: torch.nn.Module, mesh: Mesh,
                generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """Keep this rank's shard of each sharded parameter of ``model`` (a
    ``HybridViT``, in place) and run its standard blocks tensor-parallel over
    ``mesh.model_group``; ``generator`` draws dropout on this rank's own
    heads and hidden units. Raises ``ValueError`` unless the model axis
    divides the heads."""
    blocks = _blocks(model)
    if mesh.model == 1 or not blocks:
        return model
    heads = blocks[0].attn.num_heads
    if heads % mesh.model != 0:
        raise ValueError(f"num_heads ({heads}) is not divisible by model_parallel "
                         f"({mesh.model}): tensor parallelism splits whole heads")
    for name, p in model.named_parameters():
        if tp_spec(name) is not None:
            p.data = tp_split(name, p.data, mesh.model, mesh.model_rank)
            p.tp_group = mesh.model_group  # global_norm sums its squares over the group
    tp = TPGroup(mesh.model_group, mesh.model, mesh.model_rank, generator)
    for block in blocks:
        block.attn.tp = block.mlp.tp = tp
    return model


@torch.no_grad()
def unshard_model(model: torch.nn.Module, full: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """Give a sharded ``model`` (in place) the full ``state_dict`` ``full``
    and run it on one device again."""
    for name, p in model.named_parameters():
        if tp_spec(name) is not None:
            p.data = torch.empty_like(full[name], device=p.device)
            p.__dict__.pop("tp_group", None)
    for block in _blocks(model):
        block.attn.tp = block.mlp.tp = None
    model.load_state_dict(full)
    return model
