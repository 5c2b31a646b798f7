"""HybridViT in PyTorch (NCHW inside, the JAX package's [B, F, T, C] at the
public forward), with the JAX package's ``models`` names. ``sdpa_reference``
is the plain attention that kernel K2 is held against. CMGAN's generator
(``cmgan.TSCNet``) and SEMamba's (``semamba.SEMamba``) are the port's other
architectures; ``create_model`` builds any of them from a config's
``model.architecture``."""

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
from .semamba import SEMamba, create_semamba  # noqa: F401

ARCHITECTURES = ("hybrid_vit", "cmgan", "semamba")
# the builders of the architectures that take no keyword overrides
_BUILDERS = {"cmgan": create_cmgan, "semamba": create_semamba}


def architecture(config: Optional[Dict]) -> str:
    """The config's ``model.architecture`` (``hybrid_vit`` when unset);
    ``ValueError`` for one the port does not have."""
    arch = ((config or {}).get("model") or {}).get("architecture", "hybrid_vit")
    if arch not in ARCHITECTURES:
        raise ValueError(f"model.architecture {arch!r}: the port has {ARCHITECTURES}")
    return arch


def create_model(config: Optional[Dict] = None, **overrides):
    """The model of the merged config, in eval mode: ``create_hybrid_vit``
    (``overrides`` are its keyword overrides), ``create_cmgan`` or
    ``create_semamba``, by ``model.architecture``."""
    arch = architecture(config)
    if arch in _BUILDERS:
        if overrides:
            raise ValueError(f"create_model: {arch} takes no overrides, got {sorted(overrides)}")
        return _BUILDERS[arch](config)
    return create_hybrid_vit(config, **overrides)


__all__ = [
    "ARCHITECTURES",
    "architecture",
    "create_model",
    "TSCNet",
    "create_cmgan",
    "SEMamba",
    "create_semamba",
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
