"""HybridViT in PyTorch (NCHW inside, the JAX package's [B, F, T, C] at the
public forward), with the JAX package's ``models`` names. ``sdpa_reference``
is the plain attention that kernel K2 is held against."""

from ..ops.cuda_attention import attention_plain as sdpa_reference  # noqa: F401
from .attention import (  # noqa: F401
    EfficientAttention,
    MultiHeadSelfAttention,
    TransformerEncoderBlock,
    VisionTransformer,
)
from .components import (  # noqa: F401
    ConvBlock,
    DropPath,
    FeedForward,
    PatchEmbedding,
    PositionalEncoding,
    PositionalEncoding2D,
    TransposeConvBlock,
    patch_validity_mask,
)
from .fold import fold_batchnorm  # noqa: F401
from .hybrid_vit import HybridViT, count_parameters, create_hybrid_vit, init_weights  # noqa: F401

__all__ = [
    "HybridViT",
    "create_hybrid_vit",
    "init_weights",
    "count_parameters",
    "fold_batchnorm",
    "ConvBlock",
    "TransposeConvBlock",
    "FeedForward",
    "PatchEmbedding",
    "PositionalEncoding",
    "PositionalEncoding2D",
    "patch_validity_mask",
    "DropPath",
    "MultiHeadSelfAttention",
    "TransformerEncoderBlock",
    "VisionTransformer",
    "EfficientAttention",
    "sdpa_reference",
]
