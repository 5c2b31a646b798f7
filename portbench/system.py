"""The system under test: the PyTorch/CUDA port, built from a configuration
file, with the benchmark's weights. Only this module and the traffic
modules import the port."""

from __future__ import annotations

import importlib

import torch

from . import weights

PORT = "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch"


def port(module: str = ""):
    """A module of the port, e.g. ``port("inference")``."""
    return importlib.import_module(f"{PORT}.{module}" if module else PORT)


def port_config(config: dict) -> dict:
    """The sections of a configuration file that the port's builders read."""
    return {"model": config["model"], "audio": config["audio"]}


def stft_config(config: dict):
    a = config["audio"]
    return port("ops.stft").STFTConfig(n_fft=a["n_fft"], hop_length=a["hop_length"],
                                       win_length=a["win_length"], window=a["window"])


def use_precision(config: dict) -> None:
    """The arithmetic the configuration states: fp32 is TF32 off for cuBLAS
    and cuDNN, as the port's entry points set it."""
    if config["precision"] != "fp32":
        raise ValueError(f"unknown precision {config['precision']!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_model(config: dict, seed: int, device) -> tuple:
    """``(model, weights)``: the port's HybridViT of ``config`` on
    ``device`` in eval mode, loaded with the seed's weights (which are
    returned too, for the reference)."""
    model = port("models").create_hybrid_vit(port_config(config)).to(device)
    w = weights.draw(weights.float_shapes(model), seed, device)
    missing = set(weights.float_shapes(model)) - set(w)
    if missing:
        raise RuntimeError(f"no weights drawn for {sorted(missing)}")
    with torch.no_grad():
        state = model.state_dict()
        for name, t in w.items():
            state[name].copy_(t)
    return model.eval(), w


def count_params(model) -> int:
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
