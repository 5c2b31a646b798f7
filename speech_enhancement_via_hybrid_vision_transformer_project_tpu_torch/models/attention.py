"""Self-attention stack of the HybridViT (JAX ``models/attention.py``).

Attention runs through ``ops.cuda_attention.attention``: kernel K2 for CUDA
tensors (its backward too, in training), its plain version on the CPU.
Two cases take the explicit-weights path instead, as in the JAX package:
``return_attention=True``, which returns the softmax weights, and training
with ``attn_dropout > 0``, which drops weights. Each block's drop-path rate
is ``np.linspace(0, drop_path_rate, num_layers)[i]``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda_attention import NEG_INF, attention
from .components import LN_EPS, DropPath, FeedForward


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

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        return_attention: bool = False,
    ):
        b, n, _ = x.shape
        h = self.num_heads
        d = self.embed_dim // h
        scale = d**-0.5
        # [B, N, 3, H, D] -> [3, B, H, N, D]: one copy, q/k/v contiguous views
        qkv = self.qkv(x).reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
        q, k, v = qkv[0], qkv[1], qkv[2]
        weights = None
        if return_attention or (self.training and self.attn_dropout > 0):
            logits = torch.matmul(q, k.transpose(-1, -2)) * scale
            if mask is not None:
                logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
            weights = torch.softmax(logits, dim=-1)
            w = F.dropout(weights, self.attn_dropout, self.training)
            out = torch.matmul(w, v)
        else:
            out = attention(q, k, v, scale=scale, mask=mask)
        out = self.proj(out.transpose(1, 2).reshape(b, n, self.embed_dim))
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


class VisionTransformer(nn.Module):
    """Stack of pre-norm blocks and a final LayerNorm (standard attention;
    the JAX package's linear ``EfficientAttention`` is not ported yet)."""

    def __init__(self, embed_dim: int, num_layers: int = 6, num_heads: int = 8,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, dropout: float = 0.0,
                 attn_dropout: float = 0.0, drop_path_rate: float = 0.0):
        super().__init__()
        dpr = np.linspace(0.0, drop_path_rate, num_layers)
        self.blocks = nn.ModuleList(
            TransformerEncoderBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, dropout,
                                    attn_dropout, drop_path=float(dpr[i]))
            for i in range(num_layers)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x, mask=None, return_all_attentions: bool = False):
        attentions = []
        for block in self.blocks:
            if return_all_attentions:
                x, w = block(x, mask=mask, return_attention=True)
                attentions.append(w)
            else:
                x = block(x, mask=mask)
        x = self.norm(x)
        if return_all_attentions:
            return x, attentions
        return x
