"""Building blocks of the HybridViT (JAX ``models/components.py``), NCHW.

``module.train()`` switches them as flax's ``train=True`` does: BatchNorm
normalizes with the batch statistics (flax's: the biased variance, as
E[x^2] - E[x]^2) and moves its running statistics by 0.1 (flax's momentum
0.9), dropout draws its masks (channel dropout on conv features: one draw
per (sample, channel), ``F.dropout2d``; elementwise in the MLP and after
the positional embedding), and ``DropPath`` drops a whole residual branch
per sample, scaling kept ones by 1/keep. In eval all of them are identity
but BatchNorm, which uses its running statistics.

Data parallelism (``parallel/``): a BatchNorm whose ``group`` is set (by
``sync_batchnorm``) takes its train-mode statistics over the whole global
batch, as the JAX package's SPMD step does; ``dropout_from`` draws from a given
generator where tensor parallelism needs its own random stream.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import upsample_nearest
from ..parallel.collectives import all_reduce_sum, copy_to_group, reduce_from_group

BN_EPS = 1e-5
LN_EPS = 1e-5


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with flax's train-mode arithmetic: the batch mean and the
    biased variance E[x^2] - E[x]^2 (clipped at 0) normalize, and the
    running statistics move by 0.1 towards them (torch's own train mode
    would keep the unbiased variance, n/(n-1) off flax's). Eval: the running
    statistics, as ``nn.BatchNorm2d``."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=0.1)
        self.group = None  # the data-parallel group whose batches it normalizes over

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is None:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        else:
            # the global batch's statistics: one all-reduce of [sum x, sum x^2,
            # count], whose backward all-reduces the statistics' gradients
            c = x.shape[1]
            sums = torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                              x.new_full((1,), x.numel() // c)])
            sums = all_reduce_sum(sums, self.group)
            mean = sums[:c] / sums[2 * c]
            var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] + self.bias[None, :, None, None]


def sync_batchnorm(model: nn.Module, group) -> nn.Module:
    """Set every ``BatchNorm`` of ``model`` to take its train-mode statistics
    over ``group``'s batches (None: its own batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return model


def dropout_from(x: torch.Tensor, p: float, training: bool,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """``F.dropout``, drawing the mask from ``generator`` when one is given."""
    if generator is None:
        return F.dropout(x, p, training)
    if not training or p == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


class ConvBlock(nn.Module):
    """Conv3x3 -> BatchNorm -> ReLU -> channel dropout -> MaxPool (floor).
    The conv has no bias under BatchNorm; with ``use_batchnorm=False`` (a
    model whose BatchNorm was folded into its convs) the conv has a bias
    and no BatchNorm follows."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 pool_size: Optional[int] = 2, dropout: float = 0.0,
                 use_batchnorm: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size,
                              padding=kernel_size // 2, bias=not use_batchnorm)
        self.bn = BatchNorm(out_ch) if use_batchnorm else None
        self.pool_size = pool_size if pool_size and pool_size > 1 else None
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        x = F.relu(x)
        if self.dropout > 0:
            x = F.dropout2d(x, self.dropout, self.training)
        if self.pool_size:
            x = F.max_pool2d(x, self.pool_size, self.pool_size)
        return x


class TransposeConvBlock(nn.Module):
    """Decoder block: nearest upsample -> Conv3x3 -> BN -> ReLU -> channel
    dropout. The final layer has no BN or dropout and applies Tanh, and its
    conv keeps no bias (the reference's no-bias final-conv quirk), with or
    without ``use_batchnorm``. Other blocks with ``use_batchnorm=False``
    have a conv bias and no BN, as ``ConvBlock``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 upsample_factor: Optional[int] = 2, final_layer: bool = False,
                 dropout: float = 0.0, use_batchnorm: bool = True):
        super().__init__()
        self.upsample_factor = upsample_factor if upsample_factor and upsample_factor > 1 else 1
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, padding=kernel_size // 2,
                              bias=not (use_batchnorm or final_layer))
        self.final_layer = final_layer
        self.bn = BatchNorm(out_ch) if use_batchnorm and not final_layer else None
        self.dropout = 0.0 if final_layer else dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(upsample_nearest(x, self.upsample_factor))
        if self.final_layer:
            return torch.tanh(x)
        if self.bn is not None:
            x = self.bn(x)
        x = F.relu(x)
        if self.dropout > 0:
            x = F.dropout2d(x, self.dropout, self.training)
        return x


class FeedForward(nn.Module):
    """Transformer MLP: Linear -> exact GELU -> Dropout -> Linear -> Dropout."""

    def __init__(self, dim: int, hidden_dim: Optional[int] = None, dropout: float = 0.0):
        super().__init__()
        hidden = hidden_dim or 4 * dim
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.dropout = dropout
        self.tp = None  # a TPGroup: fc1 split by column, fc2 by row (parallel/sharding.py)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            x = F.dropout(F.gelu(self.fc1(x), approximate="none"), self.dropout, self.training)
            return F.dropout(self.fc2(x), self.dropout, self.training)
        tp = self.tp
        x = F.gelu(self.fc1(copy_to_group(x, tp.group)), approximate="none")
        x = dropout_from(x, self.dropout, self.training, tp.generator)  # this rank's hidden units
        x = reduce_from_group(F.linear(x, self.fc2.weight), tp.group) + self.fc2.bias
        return F.dropout(x, self.dropout, self.training)  # the same mask on every model rank


class PatchEmbedding(nn.Module):
    """Non-overlapping conv patchify: ``[B, C, H, W]`` ->
    ``([B, H'*W', D], (H', W'))`` with H-major token order."""

    def __init__(self, in_ch: int, embed_dim: int, patch_size: int = 4):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor):
        x = self.proj(x)
        h, w = x.shape[-2:]
        return x.flatten(2).transpose(1, 2), (h, w)


class PositionalEncoding(nn.Module):
    """Learned (or sinusoidal) 1-D positional table sliced to the sequence
    length, then dropout."""

    def __init__(self, embed_dim: int, max_len: int = 10000, learnable: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.max_len = max_len
        self.dropout = dropout
        if learnable:
            self.pos_embed = nn.Parameter(torch.zeros(1, max_len, embed_dim))
        else:
            self.register_buffer(
                "pos_embed",
                torch.from_numpy(self.sinusoidal_table(max_len, embed_dim)),
                persistent=False,
            )

    @staticmethod
    def sinusoidal_table(max_len: int, embed_dim: int) -> np.ndarray:
        pos = np.arange(max_len)[:, None].astype(np.float64)
        div = np.exp(np.arange(0, embed_dim, 2) * (-np.log(10000.0) / embed_dim))
        tab = np.zeros((1, max_len, embed_dim), np.float32)
        tab[0, :, 0::2] = np.sin(pos * div)
        tab[0, :, 1::2] = np.cos(pos * div)
        return tab

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[1]
        if n > self.max_len:
            raise ValueError(
                f"sequence length {n} exceeds positional table ({self.max_len})"
            )
        return F.dropout(x + self.pos_embed[:, :n, :], self.dropout, self.training)


class PositionalEncoding2D(nn.Module):
    """Factored learned 2-D positional table: patch (i, j) of the
    (freq, time) patch grid gets ``freq_tab[i] + time_tab[j]``, so a valid
    patch's embedding does not depend on the padded bucket width. Dropout
    after the sum."""

    def __init__(self, embed_dim: int, max_freq_patches: int = 64,
                 max_time_patches: int = 4096, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.pos_embed_freq = nn.Parameter(torch.zeros(max_freq_patches, embed_dim))
        self.pos_embed_time = nn.Parameter(torch.zeros(max_time_patches, embed_dim))

    def forward(self, x: torch.Tensor, spatial: tuple[int, int]) -> torch.Tensor:
        h, w = spatial
        if h > self.pos_embed_freq.shape[0] or w > self.pos_embed_time.shape[0]:
            raise ValueError(
                f"patch grid {spatial} exceeds positional tables "
                f"({self.pos_embed_freq.shape[0]}, {self.pos_embed_time.shape[0]})"
            )
        emb = self.pos_embed_freq[:h, None, :] + self.pos_embed_time[None, :w, :]
        return F.dropout(x + emb.reshape(1, h * w, -1), self.dropout, self.training)


class DropPath(nn.Module):
    """Stochastic depth: in training, drop the whole residual branch of a
    sample with probability ``drop_prob``, and divide kept ones by the
    keep probability."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.drop_prob == 0.0 or not self.training:
            return x
        keep = 1.0 - self.drop_prob
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def patch_validity_mask(
    lengths: torch.Tensor,
    f_dim: int,
    t_dim: int,
    hop_length: int,
    pool_sizes=(2, 2, 1),
    patch_size: int = 4,
) -> torch.Tensor:
    """``[B, N]`` bool patch-validity mask from per-row true sample lengths:
    a patch column is valid iff it overlaps at least one real STFT frame
    (the model's pools floor F and T, then patchify tiles them)."""
    down_t = patch_size
    for p in pool_sizes:
        if p and p > 1:
            f_dim //= p
            t_dim //= p
            down_t *= p
    h, w = f_dim // patch_size, t_dim // patch_size
    frames_valid = 1 + torch.ceil(
        torch.clamp(lengths, min=1).to(torch.float32) / hop_length
    ).to(torch.int32)
    col_start = torch.arange(w, dtype=torch.int32, device=lengths.device) * down_t
    col_valid = col_start[None, :] < frames_valid[:, None]  # [B, w]
    return col_valid[:, None, :].expand(-1, h, w).reshape(col_valid.shape[0], h * w)
