"""Autograd Functions around ``all_reduce`` (a sum over a process group).

* ``all_reduce_sum``: the group's sum forward, and backward, since every
  rank's loss depends on the sum, the group's sum of the gradients (synced
  BatchNorm's statistics).
* ``copy_to_group``: identity forward, the gradients' sum backward; it stands
  before a column-parallel layer, whose replicated input each rank's shard
  of the output depends on (Megatron's ``f``).
* ``reduce_from_group``: the sum forward, identity backward; it stands after
  a row-parallel layer, whose partial products it adds up (Megatron's ``g``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass
class TPGroup:
    """A tensor-parallel layer's group: its process group, the number of
    shards (``size``), this rank's shard (``rank``), and the random stream
    (``generator``) of dropout on this rank's own shard, which differs from
    the other model ranks' (None: the default generator)."""

    group: object
    size: int
    rank: int
    generator: Optional[torch.Generator] = None


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no autograd) and return it."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)
