"""HybridViT in PyTorch (NCHW inside, the JAX package's [B, F, T, C] at the
public forward), with the JAX package's ``models`` names. ``sdpa_reference``
is the plain attention that kernel K2 is held against. CMGAN's generator
(``cmgan.TSCNet``) is the port's second architecture; ``create_model``
builds either from a config's ``model.architecture``."""

from typing import Dict, Optional

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
from .cmgan import TSCNet, create_cmgan  # noqa: F401
from .fold import fold_batchnorm  # noqa: F401
from .hybrid_vit import HybridViT, count_parameters, create_hybrid_vit, init_weights  # noqa: F401

ARCHITECTURES = ("hybrid_vit", "cmgan")


def architecture(config: Optional[Dict]) -> str:
    """The config's ``model.architecture`` (``hybrid_vit`` when unset);
    ``ValueError`` for one the port does not have."""
    arch = ((config or {}).get("model") or {}).get("architecture", "hybrid_vit")
    if arch not in ARCHITECTURES:
        raise ValueError(f"model.architecture {arch!r}: the port has {ARCHITECTURES}")
    return arch


def create_model(config: Optional[Dict] = None, **overrides):
    """The model of the merged config, in eval mode: ``create_hybrid_vit``
    (``overrides`` are its keyword overrides) or ``create_cmgan``, by
    ``model.architecture``."""
    if architecture(config) == "cmgan":
        if overrides:
            raise ValueError(f"create_model: cmgan takes no overrides, got {sorted(overrides)}")
        return create_cmgan(config)
    return create_hybrid_vit(config, **overrides)


__all__ = [
    "ARCHITECTURES",
    "architecture",
    "create_model",
    "TSCNet",
    "create_cmgan",
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
