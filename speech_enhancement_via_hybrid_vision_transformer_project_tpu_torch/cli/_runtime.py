"""Set-up shared by the serve, enhance and evaluate CLIs: the device they
run on and the caller's config directory."""

from __future__ import annotations

from typing import Dict


def use_device(device: str) -> None:
    """Refuse ``cuda`` without a CUDA device, and turn TF32 off: float32
    end to end, or cuDNN's convolutions would run in TF32."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def caller_config(config_dir: str) -> Dict:
    """The merged YAML configs of ``config_dir`` ({} where it holds none).
    The checkpoint's ``meta.json`` still decides the model and audio
    sections; this supplies the runtime ones (``inference``, ``data``)."""
    from ..utils.config import load_all_configs

    try:
        return load_all_configs(config_dir)
    except (OSError, ValueError) as e:
        print(f"warning: config load failed ({e}); using defaults")
        return {}
