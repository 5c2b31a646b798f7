"""Set-up shared by the serve, enhance and evaluate CLIs: the device they
run on, their data-parallel mesh and the caller's config directory."""

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


def data_parallel_mesh(n: int, device: str):
    """``--data-parallel n``: a mesh of n replicas (``cuda:0`` .. ``cuda:n-1``,
    or n times the CPU), None for n <= 1; ``SystemExit`` naming both counts
    where fewer cards are visible."""
    from ..parallel import mesh_for_data_parallel

    try:
        return mesh_for_data_parallel(n, device)
    except ValueError as e:
        raise SystemExit(f"--data-parallel {n}: {e}") from None


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
