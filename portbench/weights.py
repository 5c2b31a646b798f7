"""Weights from the seed, drawn on the device in one call, and handed alike
to the program and to the reference."""

from __future__ import annotations

import math

import torch


def _scale(name: str, v: torch.Tensor, shapes: dict) -> torch.Tensor:
    """One leaf's values from standard normal ``v``, by its role."""
    if name.endswith("running_mean"):
        return 0.1 * v
    if name.endswith("running_var"):
        return torch.exp(0.2 * v)
    if v.dim() == 4 and not name.startswith("skip_proj."):
        fan_out = v.shape[0] * v.shape[2] * v.shape[3]
        return math.sqrt(2.0 / fan_out) * v
    if v.dim() >= 2:  # dense layers, 1x1 skip projections, positional tables
        return 0.02 * v
    sibling = shapes.get(name.rsplit(".", 1)[0] + ".weight")
    norm = sibling is not None and len(sibling) == 1  # LayerNorm or BatchNorm
    if name.endswith(".weight"):
        return 1.0 + 0.1 * v
    return (0.1 if norm else 0.02) * v


def draw(shapes: dict, seed: int, device) -> dict:
    """``{name: tensor}`` for ``shapes`` (``{name: shape}`` of the float
    leaves, parameters and BatchNorm statistics), float32 on ``device``,
    from ``seed``: one normal draw, then each leaf scaled by its role (see
    the configuration files' ``assumed.weights``)."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    z = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out, i = {}, 0
    for name, n in zip(names, sizes):
        out[name] = _scale(name, z[i:i + n].view(shapes[name]), shapes)
        i += n
    return out


def float_shapes(module: torch.nn.Module) -> dict:
    """``{name: shape}`` of a module's float parameters and buffers."""
    return {n: tuple(t.shape) for n, t in module.state_dict().items() if t.is_floating_point()}
