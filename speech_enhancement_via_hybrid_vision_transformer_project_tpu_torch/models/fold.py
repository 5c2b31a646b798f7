"""Inference-time BatchNorm folding (JAX ``models/fold.py``).

In eval mode BatchNorm is a per-channel affine map with frozen statistics:
``y = gamma * (x - mean) / sqrt(var + eps) + beta``. Following a bias-free
conv it is absorbed exactly into the conv itself:

    s  = gamma / sqrt(var + eps)
    W' = W * s          (per output channel)
    b' = beta - mean*s

``fold_batchnorm`` returns a clone of a HybridViT in that form: the state
of a ``HybridViT(fold_bn=True)`` (``conv.weight`` and ``conv.bias`` per
block, no ``bn.*``), which the checkpoint reader and writer map to the JAX
folded model's ``Conv_0/kernel`` and ``Conv_0/bias``. The folded output
equals the unfolded one to fp32 rounding: cuDNN may pick another algorithm
for a conv with a bias.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn as nn

from .components import BN_EPS


def _fold_into(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> nn.Conv2d:
    """A biased conv equal to ``bn(conv(x))`` in eval mode, on ``conv``'s
    device. The arithmetic is the JAX fold's, float32 in numpy (torch's CPU
    division of the scale can round the last place the other way)."""
    gamma, beta, mean, var, weight = (t.detach().cpu().float().numpy() for t in (
        bn.weight, bn.bias, bn.running_mean, bn.running_var, conv.weight))
    s = gamma / np.sqrt(var + BN_EPS)
    folded = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size,
                       stride=conv.stride, padding=conv.padding, bias=True)
    with torch.no_grad():
        folded.weight.copy_(torch.from_numpy(weight * s[:, None, None, None]))
        folded.bias.copy_(torch.from_numpy(beta - mean * s))
    return folded.to(conv.weight.device)


def fold_batchnorm(model: nn.Module) -> nn.Module:
    """A copy of ``model`` in eval mode with every ``bn`` that follows a
    bias-free ``conv`` in the same block folded into it; ``model`` itself is
    left as it was. Blocks without a BatchNorm (the final decoder layer)
    pass through. Raises ``ValueError`` when a BatchNorm is left unfolded
    (one outside a conv block, or after a conv that already has a bias)."""
    folded = copy.deepcopy(model).eval()
    for block in list(folded.modules()):
        conv, bn = getattr(block, "conv", None), getattr(block, "bn", None)
        if isinstance(conv, nn.Conv2d) and isinstance(bn, nn.BatchNorm2d) and conv.bias is None:
            block.conv, block.bn = _fold_into(conv, bn), None
    leftover = [name for name, m in folded.named_modules() if isinstance(m, nn.BatchNorm2d)]
    if leftover:
        raise ValueError(f"fold_batchnorm could not fold BatchNorm {leftover} "
                         "(not after a bias-free conv of its block)")
    folded.fold_bn = True
    return folded
