"""Self-attention stack of the HybridViT (JAX ``models/attention.py``).

Attention runs through ``ops.cuda_attention.attention``: kernel K2 for CUDA
tensors (its backward too, in training), its plain version on the CPU.
Two cases take the explicit-weights path instead, as in the JAX package:
``return_attention=True``, which returns the softmax weights, and training
with ``attn_dropout > 0``, which drops weights. Each block's drop-path rate
is ``np.linspace(0, drop_path_rate, num_layers)[i]``.

``remat=True`` recomputes each transformer block's activations in the
backward (``torch.utils.checkpoint``, the JAX ``nn.remat``) in training.
``attention_type="linear"`` swaps in the JAX package's O(N)
``EfficientAttention`` blocks, which take no mask and no drop-path.

Tensor parallelism (``parallel/sharding.py`` sets ``tp``): a standard
block's attention runs this rank's whole heads (its share of q, of k and of
v from its rows of the qkv projection) and its rows of the output
projection's input; the MLP its columns of ``fc1`` and rows of ``fc2``. The
layers' input passes through ``copy_to_group`` and their output through
``reduce_from_group``, and the row-parallel bias is added once, after the
reduce. Dropout on the rank's own heads or hidden units draws from the
group's generator; dropout after the reduce and drop-path from the default
one, which the model ranks of one data shard seed alike.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.cuda_attention import NEG_INF, attention, attention_plain
from ..parallel.collectives import copy_to_group, reduce_from_group
from .components import LN_EPS, DropPath, FeedForward, dropout_from


class MultiHeadSelfAttention(nn.Module):
    """Fused-QKV multi-head self-attention, with dropout on the attention
    weights (``attn_dropout``, training only) and on the projection."""

    def __init__(self, embed_dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 attn_dropout: float = 0.0, proj_dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(
                f"embed_dim ({embed_dim}) must be divisible by num_heads ({num_heads})"
            )
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim, bias=qkv_bias)
        self.proj = nn.Linear(embed_dim, embed_dim)
        self.attn_dropout = attn_dropout
        self.proj_dropout = proj_dropout
        self.tp = None  # a TPGroup: this rank's heads only
        # True: attention's plain version on CUDA tensors too, in place of
        # kernel K2 (a caller's explicit choice: tools.bench_infer --attention xla)
        self.plain = False

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        return_attention: bool = False,
    ):
        b, n, _ = x.shape
        tp = self.tp
        h = self.num_heads if tp is None else self.num_heads // tp.size
        d = self.embed_dim // self.num_heads
        scale = d**-0.5
        if tp is not None:
            x = copy_to_group(x, tp.group)
        # [B, N, 3, H, D] -> [3, B, H, N, D]: one copy, q/k/v contiguous views
        qkv = self.qkv(x).reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
        q, k, v = qkv[0], qkv[1], qkv[2]
        weights = None
        if return_attention or (self.training and self.attn_dropout > 0):
            logits = torch.matmul(q, k.transpose(-1, -2)) * scale
            if mask is not None:
                logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
            weights = torch.softmax(logits, dim=-1)
            w = dropout_from(weights, self.attn_dropout, self.training,
                             None if tp is None else tp.generator)
            out = torch.matmul(w, v)
        else:
            out = (attention_plain if self.plain else attention)(q, k, v, scale=scale, mask=mask)
        out = out.transpose(1, 2).reshape(b, n, h * d)
        if tp is None:
            out = self.proj(out)
        else:
            out = reduce_from_group(F.linear(out, self.proj.weight), tp.group) + self.proj.bias
        out = F.dropout(out, self.proj_dropout, self.training)
        if return_attention:
            return out, weights
        return out


class TransformerEncoderBlock(nn.Module):
    """Pre-norm block: x += DropPath(MHSA(LN(x))); x += DropPath(MLP(LN(x)))."""

    def __init__(self, embed_dim: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, dropout: float = 0.0, attn_dropout: float = 0.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.attn = MultiHeadSelfAttention(embed_dim, num_heads, qkv_bias,
                                           attn_dropout, proj_dropout=dropout)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.mlp = FeedForward(embed_dim, int(embed_dim * mlp_ratio), dropout)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, mask=None, return_attention: bool = False):
        if return_attention:
            y, weights = self.attn(self.norm1(x), mask=mask, return_attention=True)
        else:
            y, weights = self.attn(self.norm1(x), mask=mask), None
        x = x + self.drop_path(y)
        x = x + self.drop_path(self.mlp(self.norm2(x)))
        if return_attention:
            return x, weights
        return x


class EfficientAttention(nn.Module):
    """O(N) linear attention (JAX ``EfficientAttention``): ``softmax(K)``
    over tokens, ``softmax(V)`` over features, ``Q (K^T V)``, then the
    output projection and dropout. No mask."""

    def __init__(self, embed_dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim, bias=qkv_bias)
        self.proj = nn.Linear(embed_dim, embed_dim)
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h = self.num_heads
        d = self.embed_dim // h
        q, k, v = self.qkv(x).reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        k = torch.softmax(k, dim=-2)
        v = torch.softmax(v, dim=-1)
        out = torch.matmul(q, torch.matmul(k.transpose(-1, -2), v))  # [B, H, N, D]
        out = self.proj(out.transpose(1, 2).reshape(b, n, self.embed_dim))
        return F.dropout(out, self.dropout, self.training)


class VisionTransformer(nn.Module):
    """Stack of pre-norm blocks and a final LayerNorm. ``attention_type``
    ``"linear"`` builds the JAX package's linear branch instead: residual
    blocks ``lin_norm1_i``/``lin_attn_i``/``lin_norm2_i``/``lin_mlp_i``
    (no drop-path, no mask)."""

    def __init__(self, embed_dim: int, num_layers: int = 6, num_heads: int = 8,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, dropout: float = 0.0,
                 attn_dropout: float = 0.0, drop_path_rate: float = 0.0,
                 attention_type: str = "standard", remat: bool = False):
        super().__init__()
        if attention_type not in ("standard", "linear"):
            raise ValueError(
                f"unknown attention_type {attention_type!r} (expected 'standard' or 'linear')"
            )
        self.linear = attention_type == "linear"
        self.num_layers = num_layers
        self.remat = remat
        hidden = int(embed_dim * mlp_ratio)
        if self.linear:
            for i in range(num_layers):
                self.add_module(f"lin_norm1_{i}", nn.LayerNorm(embed_dim, eps=LN_EPS))
                self.add_module(f"lin_attn_{i}",
                                EfficientAttention(embed_dim, num_heads, qkv_bias, dropout))
                self.add_module(f"lin_norm2_{i}", nn.LayerNorm(embed_dim, eps=LN_EPS))
                self.add_module(f"lin_mlp_{i}", FeedForward(embed_dim, hidden, dropout))
        else:
            dpr = np.linspace(0.0, drop_path_rate, num_layers)
            self.blocks = nn.ModuleList(
                TransformerEncoderBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, dropout,
                                        attn_dropout, drop_path=float(dpr[i]))
                for i in range(num_layers)
            )
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def _linear_forward(self, x):
        for i in range(self.num_layers):
            x = x + getattr(self, f"lin_attn_{i}")(getattr(self, f"lin_norm1_{i}")(x))
            x = x + getattr(self, f"lin_mlp_{i}")(getattr(self, f"lin_norm2_{i}")(x))
        return x

    def forward(self, x, mask=None, return_all_attentions: bool = False):
        if self.linear:  # the JAX linear branch ignores the mask
            x = self.norm(self._linear_forward(x))
            return (x, []) if return_all_attentions else x
        # as the JAX nn.remat: rematerialized blocks unless weights are asked
        # for; the recompute replays the global generators' dropout draws
        remat = self.remat and self.training and not return_all_attentions
        attentions = []
        for block in self.blocks:
            if return_all_attentions:
                x, w = block(x, mask=mask, return_attention=True)
                attentions.append(w)
            elif remat:
                x = checkpoint(block, x, mask, use_reentrant=False, **_replaying(block))
            else:
                x = block(x, mask=mask)
        x = self.norm(x)
        if return_all_attentions:
            return x, attentions
        return x


def _replaying(block: TransformerEncoderBlock) -> dict:
    """``checkpoint``'s keyword arguments for ``block``: under tensor
    parallelism, a ``context_fn`` that has the recompute draw from the
    tensor-parallel generator what the forward drew (``checkpoint`` itself
    replays only the default generators)."""
    tp = block.attn.tp
    if tp is None or tp.generator is None:
        return {}
    gen, saved = tp.generator, []

    @contextlib.contextmanager
    def forward():
        saved.append(gen.get_state())
        yield

    @contextlib.contextmanager
    def recompute():
        now = gen.get_state()
        gen.set_state(saved[0])
        try:
            yield
        finally:
            gen.set_state(now)

    return {"context_fn": lambda: (forward(), recompute())}
