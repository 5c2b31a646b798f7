"""Enhancer and batched HTTP server."""

from .enhancer import (
    AudioEnhancer,
    EnhancerCore,
    PendingBatch,
    enhance_audio,
    enhance_file,
    load_model_for_inference,
)
from .server import DynamicBatcher, make_server

__all__ = ["AudioEnhancer", "DynamicBatcher", "EnhancerCore", "PendingBatch", "enhance_audio",
           "enhance_file", "load_model_for_inference", "make_server"]
