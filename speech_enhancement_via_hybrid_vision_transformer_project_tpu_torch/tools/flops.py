"""Analytic FLOP count of the HybridViT compute path, the card's peaks, and
PyTorch's own count as the cross-check (the port's ``benchmarks/flops.py``).

The count is the JAX script's, term for term (``tests/test_torch_bench_tools.py``
holds the two equal, float for float), in the multiply-add = 2 FLOPs
convention:

  * conv2d (stride 1, same-pad):      2 · H · W · Cin · Cout · kh · kw
  * 1x1 skip projections:             2 · Hs · Ws · Cin · Cout     (at the
                                      skip's own resolution, pre-resize)
  * separable bilinear resize         2 · C · (out_h·in_h·in_w  +
    (as the JAX package's matmuls):        out_w·in_w·out_h)
  * attention (per layer):            qkv 6·N·D² + scores/AV 4·N²·D +
                                      proj 2·N·D² + MLP 4·ratio·N·D²
  * DFT STFT:                         2 · frames · n_fft · 2(n_fft/2+1)
                                      per signal (re+im banks)

A train step counts 3x the forward (the backward does two products per
forward product), two STFTs (featurize) and 10 FLOPs a parameter (AdamW).

``torch_program_flops`` is PyTorch's own count of a program run under
``torch.utils.flop_counter.FlopCounterMode``. The kernels K1, K2 and K3 are
the ops ``torch.ops.sevit.*`` on both devices, and the counter counts 0 for
an op it has no formula for, so this module registers one for each
(``register_flop_formula``), counting the same work as the analytic count:
``sevit::stft_mag`` and ``sevit::istft_polar`` ``stft_flops`` each,
``sevit::attention_fwd`` QK^T and AV (4·B·H·N·Nk·Dh), and
``sevit::attention_bwd`` twice that (dP, dV, dQ, dK; the recomputed scores
are not counted, as the 3x-forward convention does not count them), and
``sevit::attention_relpos_fwd`` (K2r) 6·B·H·N·N·Dh, every key (the counter
sees no mask), ``sevit::selective_scan`` its multiply-adds over every step
(``scan_flops``; the counter sees no lengths), and ``sevit::conv1d_silu`` its
depthwise conv, 2·k a (step, channel), as PyTorch counts ``F.conv1d``.
``cmgan_forward_flops`` and ``semamba_forward_flops`` are CMGAN's and
SEMamba's generators' counts. The
port computes its bilinear resizes with ``F.interpolate``, which the counter
counts as 0: PyTorch's count lies below the analytic one by the resize terms
(0.9% of the forward at 28M with the ``resize`` head, 3.1% with
``fullres_mask``).

The peaks are the published dense rates of the card's data sheet (NVIDIA
H100 SXM, 700 W), by ``torch.cuda.get_device_name()``, for the arithmetic a
step is allowed to use (``math_mode``): float32 outside the tensor cores
while TF32 is off (the port's entry points turn it off), TF32 when PyTorch
allows it for both cuBLAS and cuDNN, bf16 on request. Any other card has no
entry, and its share reads "not measured": a peak is never guessed.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.flops \\
        [--scaled] [--batch 8] [--frames 256] [--device cuda|cpu]
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode, flop_registry, register_flop_formula

from .. import ops  # noqa: F401  (defines torch.ops.sevit.*)


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k


def _resize(in_h: int, in_w: int, out_h: int, out_w: int, c: int) -> float:
    """A bilinear resize as the JAX package computes it: separable dense
    matmuls (H then W)."""
    f = 0.0
    h = in_h
    if in_h != out_h:
        f += 2.0 * out_h * in_h * in_w * c
        h = out_h
    if in_w != out_w:
        f += 2.0 * out_w * in_w * h * c
    return f


@dataclass
class ModelSpec:
    """Static architecture description (the HybridViT defaults)."""

    encoder_channels: Tuple[int, ...] = (64, 128, 256)
    encoder_kernel_sizes: Tuple[int, ...] = (3, 3, 3)
    encoder_pool_sizes: Tuple[int, ...] = (2, 2, 1)
    embed_dim: int = 512
    num_heads: int = 8
    num_layers: int = 6
    mlp_ratio: float = 4.0
    patch_size: int = 4
    decoder_channels: Tuple[int, ...] = (256, 128, 64, 1)
    decoder_kernel_sizes: Tuple[int, ...] = (3, 3, 3, 3)
    decoder_upsample_factors: Tuple[int, ...] = (1, 2, 2, 1)
    use_skip_connections: bool = True
    input_channels: int = 1
    head_type: str = "resize"
    head_channels: int = 16
    head_freq_up: int = 4
    head_time_up: int = 4
    output_channels: int = 1
    extras: Dict[str, float] = field(default_factory=dict)


def forward_flops(
    spec: ModelSpec, batch: int, f_bins: int = 257, frames: int = 256
) -> Dict[str, float]:
    """Analytic forward-pass FLOPs, itemized per stage, for one forward of
    HybridViT on ``[batch, f_bins, frames, C]``."""
    out: Dict[str, float] = {}
    b = batch

    # ---- encoder (ConvBlock: same-pad conv + VALID maxpool) ----
    f, t, cin = f_bins, frames, spec.input_channels
    enc = 0.0
    skips = []  # (f, t, ch) after the pool: what the decoder consumes
    for ch, k, p in zip(
        spec.encoder_channels, spec.encoder_kernel_sizes, spec.encoder_pool_sizes
    ):
        enc += b * _conv(f, t, cin, ch, k)
        if p > 1:
            f, t = f // p, t // p
        skips.append((f, t, ch))
        cin = ch
    out["encoder"] = enc

    # ---- patch embedding (VALID conv, k = s = patch) ----
    d, ps = spec.embed_dim, spec.patch_size
    h, w = f // ps, t // ps
    out["patch_embed"] = b * 2.0 * h * w * cin * d * ps * ps

    # ---- transformer ----
    n = h * w
    per_layer = (
        2.0 * n * d * 3 * d  # fused qkv
        + 4.0 * n * n * d  # QK^T + AV (2·N²·D each)
        + 2.0 * n * d * d  # output projection
        + 2.0 * 2.0 * n * d * (spec.mlp_ratio * d)  # MLP up + down
    )
    out["attention"] = b * spec.num_layers * (2.0 * n * d * 3 * d + 4.0 * n * n * d + 2.0 * n * d * d)
    out["mlp"] = b * spec.num_layers * per_layer - out["attention"]
    out["to_feature_map"] = b * 2.0 * n * d * spec.encoder_channels[-1]

    # ---- decoder (skip 1x1 proj at skip resolution -> bilinear resize to
    # x's pre-block size -> concat -> nearest upsample -> same-pad conv) ----
    dec = 0.0
    resize = 0.0
    cx = spec.encoder_channels[-1]
    rev = skips[::-1]
    n_dec = len(spec.decoder_channels)
    fullres = spec.head_type == "fullres_mask"
    for i, (ch, k, up) in enumerate(
        zip(
            spec.decoder_channels,
            spec.decoder_kernel_sizes,
            spec.decoder_upsample_factors,
        )
    ):
        is_final = i == n_dec - 1
        if is_final and fullres:
            break  # the fullres head replaces the final 1-channel block
        cat = cx
        if spec.use_skip_connections and not is_final and i < len(rev):
            sf, st, sc = rev[i]
            dec += b * _conv(sf, st, sc, ch, 1)  # 1x1 projection
            if (sf, st) != (h, w):
                resize += b * _resize(sf, st, h, w, ch)
            cat = cx + ch
        if up and up > 1:
            h, w = h * up, w * up  # nearest repeat: no FLOPs
        dec += b * _conv(h, w, cat, ch, k)
        cx = ch
    out["decoder"] = dec

    if fullres:
        # ---- fullres head: sub-pixel conv + bilinear nudge + refine ----
        hc, fu, tu = spec.head_channels, spec.head_freq_up, spec.head_time_up
        head = b * _conv(h, w, cx, hc * fu * tu, 3)  # sub-pixel conv
        hf, hw_ = h * fu, w * tu
        if (hf, hw_) != (f_bins, frames):  # the bilinear nudge
            head += b * _resize(hf, hw_, f_bins, frames, hc)
        head += b * _conv(f_bins, frames, hc + spec.input_channels, hc, 3)
        head += b * _conv(f_bins, frames, hc, spec.output_channels, 3)
        out["head"] = head
        out["resize"] = resize
        out["total"] = float(sum(out.values()))
        return out

    # ---- final bilinear resize back to [f_bins, frames] ----
    if (h, w) != (f_bins, frames):
        resize += b * _resize(h, w, f_bins, frames, cx)
    out["resize"] = resize

    out["total"] = float(sum(out.values()))
    return out


def stft_flops(batch: int, frames: int, n_fft: int = 512) -> float:
    """A DFT STFT: windowed frames times the [n_fft, 2·(n_fft//2+1)]
    stacked cos/sin bank."""
    return 2.0 * batch * frames * n_fft * (2 * (n_fft // 2 + 1))


def train_step_flops(
    spec: ModelSpec,
    batch: int,
    f_bins: int = 257,
    frames: int = 256,
    n_params: int | None = None,
) -> Dict[str, float]:
    """Analytic train-step FLOPs: featurize (2 STFTs: noisy + clean) +
    3x forward (fwd + 2x in backward) + ~10 FLOPs/param for AdamW."""
    fwd = forward_flops(spec, batch, f_bins, frames)["total"]
    feat = 2.0 * stft_flops(batch, frames)
    opt = 10.0 * (n_params or 0)
    total = feat + 3.0 * fwd + opt
    return {"featurize": feat, "forward": fwd, "train_total": total}


def inference_step_flops(spec: ModelSpec, batch: int, f_bins: int = 257,
                         frames: int = 256, n_fft: int = 512) -> float:
    """One inference core step: the forward, the STFT and the iSTFT (each
    ``stft_flops``, the JAX roofline's "dsp (stft+istft)" count)."""
    return forward_flops(spec, batch, f_bins, frames)["total"] + 2.0 * stft_flops(
        batch, frames, n_fft)


def bilinear_flops(spec: ModelSpec, batch: int, f_bins: int = 257, frames: int = 256) -> float:
    """The bilinear resizes' part of ``forward_flops``: the skip resizes and
    the final resize, or the fullres head's nudge. The port computes them
    with ``F.interpolate``, which PyTorch's counter counts as 0, so
    ``torch_program_flops`` of a forward is the analytic count less this."""
    fl = forward_flops(spec, batch, f_bins, frames)
    if spec.head_type != "fullres_mask":
        return fl["resize"]
    f, t = f_bins, frames
    for p in spec.encoder_pool_sizes:
        if p > 1:
            f, t = f // p, t // p
    h, w = f // spec.patch_size, t // spec.patch_size
    for up in spec.decoder_upsample_factors[:-1]:  # the head replaces the last block
        if up and up > 1:
            h, w = h * up, w * up
    return fl["resize"] + batch * _resize(h * spec.head_freq_up, w * spec.head_time_up,
                                          f_bins, frames, spec.head_channels)


def _dense_net(t: int, f: int, c: int, taps: int) -> float:
    """A dense block of depth 4 at ``t`` frames and ``f`` bins: conv i takes
    ``c * (i + 1)`` channels to ``c`` with a kernel of ``taps`` taps (CMGAN's
    (2, 3), SEMamba's (3, 3))."""
    return sum(2.0 * t * f * c * (i + 1) * c * taps for i in range(4))


def cmgan_forward_flops(batch: int, frames: int, f_bins: int = 201,
                        valid: Optional[Sequence[int]] = None, *, channels: int = 64,
                        num_tscb: int = 4, heads: int = 4, ff_mult: int = 4,
                        conv_expansion: int = 2, conv_kernel: int = 31) -> Dict[str, float]:
    """Forward FLOPs of CMGAN's ``TSCNet`` on ``[batch, 2, frames, f_bins]``,
    by part (the same convention; norms and activations not counted): the
    dense encoder at ``f_bins``, per conformer and position two feed-forwards,
    the q/kv/out projections and the conv module, the attention's three
    products (``QK^T``, the relative term, ``PV``: ``6·N·Nk·Dh`` a head; over
    time the keys are each row's ``valid`` frames, all when None), and the
    two decoders. ``portbench/cmgan_work.py`` keeps a frozen copy."""
    c, t, f2, d = channels, frames, (f_bins + 1) // 2, channels // heads
    kept = [t] * batch if valid is None else [min(int(v), t) for v in valid]
    inner = c * conv_expansion
    token = (2 * (2.0 * c * ff_mult * c * 2) + 2.0 * c * 4 * c
             + 2.0 * c * 2 * inner + 2.0 * inner * conv_kernel + 2.0 * inner * c)
    out = {
        "encoder": batch * (2.0 * t * f_bins * 3 * c + _dense_net(t, f_bins, c, 6)
                            + 2.0 * t * f2 * c * c * 3),
        "conformers": batch * 2 * num_tscb * token * t * f2,
        "attention_time": num_tscb * sum(6.0 * f2 * heads * t * k * d for k in kept),
        "attention_freq": num_tscb * 6.0 * batch * t * heads * f2 * f2 * d,
        "decoders": batch * (2 * (_dense_net(t, f2, c, 6) + 2.0 * t * f2 * c * 2 * c * 3)
                             + 2.0 * t * f_bins * c * 2 + 2.0 * t * f_bins
                             + 2.0 * t * f_bins * c * 2 * 2),
    }
    out["total"] = float(sum(out.values()))
    return out


def scan_flops(steps: int, d_inner: int, d_state: int) -> float:
    """The selective scan's multiply-adds over ``steps`` (sequence, step)
    pairs: per channel and state delta * A, the decay times the state plus
    delta u B, and C h summed; per channel delta u, D u added and the gate
    (the exponentials not counted)."""
    return float(steps) * d_inner * (6.0 * d_state + 4.0)


def semamba_forward_flops(batch: int, frames: int, f_bins: int = 201,
                          valid: Optional[Sequence[int]] = None, *, channels: int = 64,
                          num_tfmamba: int = 4, d_state: int = 16, d_conv: int = 4,
                          expand: int = 4) -> Dict[str, float]:
    """Forward FLOPs of ``SEMamba`` on ``[batch, 2, frames, f_bins]``, by
    part (the same convention; norms, activations and exponentials not
    counted): the dense encoder at ``f_bins``, per TFMamba block and
    direction (time and frequency, forward and backward) each token's
    in_proj, depthwise conv, x_proj, dt_proj and out_proj over every frame,
    the scans over each row's ``valid`` frames (all when None), the 1x1
    ``tlinear`` and ``flinear``, and the two decoders.
    ``portbench/semamba_work.py`` keeps a frozen copy."""
    c, t, f2 = channels, frames, (f_bins - 3) // 2 + 1
    inner, rank = c * expand, -(-c // 16)
    kept = batch * t if valid is None else sum(min(int(v), t) for v in valid)
    token = (2.0 * c * 2 * inner + 2.0 * inner * d_conv + 2.0 * inner * (rank + 2 * d_state)
             + 2.0 * rank * inner + 2.0 * inner * c)
    out = {
        "encoder": batch * (2.0 * t * f_bins * 2 * c + _dense_net(t, f_bins, c, 9)
                            + 2.0 * t * f2 * c * c * 3),
        "mamba": num_tfmamba * 4 * batch * t * f2 * token,
        "scans": num_tfmamba * 4 * scan_flops(kept * f2, inner, d_state),
        "linear": num_tfmamba * 2 * batch * t * f2 * 2.0 * 2 * c * c,
        "decoders": batch * (2 * (_dense_net(t, f2, c, 9) + 2.0 * t * f2 * c * c * 3)
                             + 2.0 * t * f_bins * c + 2.0 * t * f_bins
                             + 2 * 2.0 * t * f_bins * c),
    }
    out["total"] = float(sum(out.values()))
    return out


def spec_from_model(model) -> ModelSpec:
    """A ModelSpec from the port's ``HybridViT``."""
    return ModelSpec(
        encoder_channels=tuple(model.encoder_channels),
        encoder_kernel_sizes=tuple(model.encoder_kernel_sizes),
        encoder_pool_sizes=tuple(model.encoder_pool_sizes),
        embed_dim=model.embed_dim,
        num_heads=model.num_heads,
        num_layers=model.num_layers,
        mlp_ratio=float(model.mlp_ratio),
        patch_size=model.patch_size,
        decoder_channels=tuple(model.decoder_channels),
        decoder_kernel_sizes=tuple(model.decoder_kernel_sizes),
        decoder_upsample_factors=tuple(model.decoder_upsample_factors),
        use_skip_connections=model.use_skip_connections,
        input_channels=model.input_channels,
        head_type=model.head_type,
        head_channels=model.head_channels,
        head_freq_up=model.head_freq_up,
        head_time_up=model.head_time_up,
        output_channels=model.output_channels,
    )


# ---------------------------------------------------------------------------
# The card's peaks (data sheet) and what a tool reports beside its numbers
# ---------------------------------------------------------------------------

# NVIDIA's data sheet, H100 SXM at its 700 W limit, dense rates: FLOP/s by
# arithmetic, and the HBM3 rate in bytes/s
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
                              "bytes_per_s": 3.35e12},
}


def math_mode() -> str:
    """The arithmetic PyTorch lets a float32 step use: ``"tf32"`` when both
    cuBLAS's and cuDNN's TF32 switches are on, else ``"fp32"``."""
    tf32 = torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    return "tf32" if tf32 else "fp32"


def _card_peaks(card: Optional[str]) -> Optional[dict]:
    if card is None and torch.cuda.is_available():
        card = torch.cuda.get_device_name()
    return PEAKS.get(card)


def peak_flops(math: Optional[str] = None, card: Optional[str] = None) -> Optional[float]:
    """The data-sheet peak FLOP/s of ``card`` (default: the visible card)
    for ``math`` (``"fp32"``, ``"tf32"`` or ``"bf16"``; default
    ``math_mode()``), or None where the card is not in ``PEAKS`` or there is
    none."""
    peaks = _card_peaks(card)
    return None if peaks is None else peaks[math or math_mode()]


def peak_bytes_per_s(card: Optional[str] = None) -> Optional[float]:
    """The data-sheet memory rate of ``card``, or None as ``peak_flops``."""
    peaks = _card_peaks(card)
    return None if peaks is None else peaks["bytes_per_s"]


def mfu_report(flops_per_step: float, step_seconds: Optional[float]) -> str:
    """'X.XX TFLOP/s achieved (MFU YY.Y% of ZZ TFLOP/s fp32 data-sheet
    peak)', the achieved rate alone where the peak is unknown, or "not
    measured" without a time."""
    if not step_seconds:
        return "not measured"
    achieved = flops_per_step / step_seconds
    math = math_mode()
    peak = peak_flops(math)
    msg = f"{achieved / 1e12:.2f} TFLOP/s achieved"
    if peak:
        msg += (f"  (MFU {100.0 * achieved / peak:.1f}% of {peak / 1e12:g} TFLOP/s "
                f"{math} data-sheet peak)")
    return msg


def mfu_pct(flops_per_step: float, step_seconds: Optional[float]) -> Optional[float]:
    """The step's share of the peak in percent, None where either is unknown."""
    peak = peak_flops()
    if not step_seconds or not peak:
        return None
    return 100.0 * flops_per_step / step_seconds / peak


def describe_device(device: str) -> dict:
    """What a tool's result names: the device it ran on and, on a card, its
    name and power limit as ``nvidia-smi`` reads them (None where it
    cannot), and the math mode the peaks are read for."""
    if device != "cuda":
        return {"device": device, "name": None, "power_limit": None, "math": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()[0]
        power = smi.split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        power = None
    return {"device": device, "name": torch.cuda.get_device_name(), "power_limit": power,
            "math": math_mode()}


def card_line(info: dict) -> str:
    """``describe_device``'s result as one line: the card's name and power
    limit, or the CPU."""
    if info["device"] != "cuda":
        return f"device {info['device']}: plain versions, no device metric"
    return f"card {info['name']}, power limit {info['power_limit']}, math {info['math']}"


# ---------------------------------------------------------------------------
# PyTorch's own count, with formulas for the kernels' ops
# ---------------------------------------------------------------------------


def _formula(op):
    """``register_flop_formula(op)``, once a process (a second import of
    this module, as ``__main__``, keeps the first)."""
    def register(fn):
        if op not in flop_registry:
            register_flop_formula(op)(fn)
        return fn
    return register


@_formula(torch.ops.sevit.stft_mag)
def _stft_mag_flop(x_shape, n_fft, *args, out_shape=None, **kwargs) -> int:
    return int(stft_flops(x_shape[0], out_shape[0][-1], n_fft))


@_formula(torch.ops.sevit.istft_polar)
def _istft_polar_flop(mag_shape, phase_shape, n_fft, *args, out_shape=None, **kwargs) -> int:
    return int(stft_flops(mag_shape[0], mag_shape[-1], n_fft))


def _attention_flop(q_shape, k_shape) -> int:
    b, h, n, d = q_shape
    return 4 * b * h * n * k_shape[2] * d  # QK^T and AV, 2·N·Nk·Dh each


@_formula(torch.ops.sevit.attention_fwd)
def _attention_fwd_flop(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    return _attention_flop(q_shape, k_shape)


@_formula(torch.ops.sevit.attention_bwd)
def _attention_bwd_flop(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * _attention_flop(q_shape, k_shape)


@_formula(torch.ops.sevit.attention_relpos_fwd)
def _attention_relpos_flop(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    return 3 * _attention_flop(q_shape, k_shape) // 2  # QK^T, the relative term and AV


@_formula(torch.ops.sevit.selective_scan)
def _selective_scan_flop(u_shape, delta_shape, z_shape, b_shape, *args, out_shape=None,
                         **kwargs) -> int:
    g, length, d = u_shape
    return int(scan_flops(g * length, d, b_shape[-1]))


@_formula(torch.ops.sevit.conv1d_silu)
def _conv1d_silu_flop(x_shape, weight_shape, *args, out_shape=None, **kwargs) -> int:
    g, length, d = x_shape
    return 2 * g * length * d * weight_shape[-1]


SEVIT_OPS = (torch.ops.sevit.stft_mag, torch.ops.sevit.attention_fwd,
             torch.ops.sevit.attention_bwd, torch.ops.sevit.istft_polar,
             torch.ops.sevit.attention_relpos_fwd, torch.ops.sevit.selective_scan,
             torch.ops.sevit.conv1d_silu)


def torch_program_flops(fn, *args, **kwargs) -> float:
    """PyTorch's count of the FLOPs of ``fn(*args, **kwargs)``, run once
    under ``FlopCounterMode`` (matrix products and convolutions, and the
    ``sevit`` ops through the formulas above)."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scaled", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from ..cli._runtime import use_device
    from ..models import create_hybrid_vit

    use_device(args.device)
    overrides = dict(dropout=0.0, attn_dropout=0.0, drop_path_rate=0.0)
    if args.scaled:
        overrides.update(embed_dim=1024, num_heads=16, num_layers=12)
    model = create_hybrid_vit(**overrides).to(args.device)
    analytic = forward_flops(spec_from_model(model), args.batch, 257, args.frames)
    x = torch.zeros(args.batch, 257, args.frames, 1, device=args.device)
    with torch.no_grad():
        counted = torch_program_flops(model, x)
    print(f"config: {'scaled 12L/1024d' if args.scaled else 'default 6L/512d'}"
          f"  batch={args.batch} frames={args.frames}")
    for k, v in analytic.items():
        print(f"  {k:>16s}: {v / 1e9:10.3f} GFLOP"
              f"  ({100 * v / analytic['total']:5.1f}%)" if k != "total" else
              f"  {k:>16s}: {v / 1e9:10.3f} GFLOP")
    print(f"  {'torch':>16s}: {counted / 1e9:10.3f} GFLOP"
          f"  (analytic/torch = {analytic['total'] / counted:.4f})")
    print(card_line(describe_device(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
