"""The yardstick's arithmetic: analytic operations and bytes, and the card's
peaks.

Frozen copies, so that a change to the program cannot move the yardstick:

* ``forward_flops`` and ``ModelSpec``: the port's ``tools/flops.py``, term
  for term (multiply-add = 2 FLOPs; bilinear resizes as separable matmuls).
* ``train_step_flops``: featurize (two STFTs, counted as ``stft_work``'s
  FFTs, since the STFT kernels are FFTs), 3x the forward, 10 FLOPs a
  parameter for AdamW.
* ``stft_work``: ``chip_smoke.py``'s FFT count and bytes of an STFT with its
  magnitude and of an iSTFT from magnitude and phase.
* ``attention_work``: operations over the keys a row keeps (QK^T and AV,
  4 N Nk D a head) and each of Q, K, V and O read or written once; the
  backward counts 2.5x the forward's operations and reads Q, K, V, O, dO
  and writes dQ, dK, dV once.
* ``PEAKS``: NVIDIA's data sheet for the H100 SXM at 700 W, dense rates.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense: FLOP/s by arithmetic, HBM3 bytes/s.
# "attention_fp32" is 3xTF32 (495/3 TFLOP/s), the fastest fp32-accurate
# arithmetic the port's attention kernels use.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
                              "attention_fp32": 495e12 / 3, "bytes_per_s": 3.35e12},
}


def peaks(card: str) -> dict | None:
    return PEAKS.get(card)


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k


def _resize(in_h: int, in_w: int, out_h: int, out_w: int, c: int) -> float:
    f = 0.0
    h = in_h
    if in_h != out_h:
        f += 2.0 * out_h * in_h * in_w * c
        h = out_h
    if in_w != out_w:
        f += 2.0 * out_w * in_w * h * c
    return f


@dataclass(frozen=True)
class ModelSpec:
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


def spec_from_config(model_cfg: dict) -> ModelSpec:
    """A ``ModelSpec`` from a configuration file's ``model`` section."""
    enc, tr, dec = model_cfg["encoder"], model_cfg["transformer"], model_cfg["decoder"]
    head = model_cfg.get("head", "resize")
    up = 1
    down = int(tr["patch_size"])
    for p in enc["pool_sizes"]:
        down *= max(int(p), 1)
    for u in dec["upsample_factors"]:
        up *= max(int(u), 1)
    rem = max(1, down // up)
    return ModelSpec(
        encoder_channels=tuple(enc["channels"]),
        encoder_kernel_sizes=tuple(enc["kernel_sizes"]),
        encoder_pool_sizes=tuple(enc["pool_sizes"]),
        embed_dim=int(tr["embed_dim"]), num_heads=int(tr["num_heads"]),
        num_layers=int(tr["num_layers"]), mlp_ratio=float(tr["mlp_ratio"]),
        patch_size=int(tr["patch_size"]),
        decoder_channels=tuple(dec["channels"]),
        decoder_kernel_sizes=tuple(dec["kernel_sizes"]),
        decoder_upsample_factors=tuple(dec["upsample_factors"]),
        use_skip_connections=bool(dec.get("use_skip_connections", True)),
        input_channels=int(model_cfg.get("input_channels", 1)),
        head_type=head, head_channels=int(model_cfg.get("head_channels", 16)),
        head_freq_up=rem, head_time_up=rem,
        output_channels=int(model_cfg.get("output_channels", 1)),
    )


def forward_flops(spec: ModelSpec, batch: int, f_bins: int = 257,
                  frames: int = 256) -> Dict[str, float]:
    """Forward FLOPs of the HybridViT on ``[batch, f_bins, frames, C]``, by
    stage."""
    out: Dict[str, float] = {}
    b = batch
    f, t, cin = f_bins, frames, spec.input_channels
    enc = 0.0
    skips = []
    for ch, k, p in zip(spec.encoder_channels, spec.encoder_kernel_sizes,
                        spec.encoder_pool_sizes):
        enc += b * _conv(f, t, cin, ch, k)
        if p > 1:
            f, t = f // p, t // p
        skips.append((f, t, ch))
        cin = ch
    out["encoder"] = enc

    d, ps = spec.embed_dim, spec.patch_size
    h, w = f // ps, t // ps
    out["patch_embed"] = b * 2.0 * h * w * cin * d * ps * ps

    n = h * w
    per_layer = (2.0 * n * d * 3 * d + 4.0 * n * n * d + 2.0 * n * d * d
                 + 2.0 * 2.0 * n * d * (spec.mlp_ratio * d))
    out["attention"] = b * spec.num_layers * (2.0 * n * d * 3 * d + 4.0 * n * n * d
                                              + 2.0 * n * d * d)
    out["mlp"] = b * spec.num_layers * per_layer - out["attention"]
    out["to_feature_map"] = b * 2.0 * n * d * spec.encoder_channels[-1]

    dec = 0.0
    resize = 0.0
    cx = spec.encoder_channels[-1]
    rev = skips[::-1]
    n_dec = len(spec.decoder_channels)
    fullres = spec.head_type == "fullres_mask"
    for i, (ch, k, up) in enumerate(zip(spec.decoder_channels, spec.decoder_kernel_sizes,
                                        spec.decoder_upsample_factors)):
        is_final = i == n_dec - 1
        if is_final and fullres:
            break
        cat = cx
        if spec.use_skip_connections and not is_final and i < len(rev):
            sf, st, sc = rev[i]
            dec += b * _conv(sf, st, sc, ch, 1)
            if (sf, st) != (h, w):
                resize += b * _resize(sf, st, h, w, ch)
            cat = cx + ch
        if up and up > 1:
            h, w = h * up, w * up
        dec += b * _conv(h, w, cat, ch, k)
        cx = ch
    out["decoder"] = dec

    if fullres:
        hc, fu, tu = spec.head_channels, spec.head_freq_up, spec.head_time_up
        head = b * _conv(h, w, cx, hc * fu * tu, 3)
        hf, hw_ = h * fu, w * tu
        if (hf, hw_) != (f_bins, frames):
            head += b * _resize(hf, hw_, f_bins, frames, hc)
        head += b * _conv(f_bins, frames, hc + spec.input_channels, hc, 3)
        head += b * _conv(f_bins, frames, hc, spec.output_channels, 3)
        out["head"] = head
        out["resize"] = resize
        out["total"] = float(sum(out.values()))
        return out

    if (h, w) != (f_bins, frames):
        resize += b * _resize(h, w, f_bins, frames, cx)
    out["resize"] = resize
    out["total"] = float(sum(out.values()))
    return out


def num_frames(n_fft: int, hop: int, wav_len: int) -> int:
    """Frames of a centred STFT of ``wav_len`` samples."""
    return 1 + (wav_len + 2 * (n_fft // 2) - n_fft) // hop


def rfft_flops(n: int) -> float:
    """Operations of one real FFT of ``n`` points (half a complex one's
    5 n log2 n)."""
    return 2.5 * n * math.log2(n)


def stft_work(n_fft: int, hop: int, batch: int, wav_len: int) -> dict:
    """``{"stft": (ops, bytes), "istft": (ops, bytes)}`` that an STFT with
    its magnitude and an iSTFT from magnitude and phase of ``batch`` rows of
    ``wav_len`` samples must do and move, whichever kernel computes them;
    every input read once, every output written once, fp32."""
    n_fr = num_frames(n_fft, hop, wav_len)
    bins = n_fft // 2 + 1
    frames = batch * n_fr
    return {"stft": (frames * (rfft_flops(n_fft) + n_fft + 4 * bins),
                     4.0 * (batch * wav_len + 3 * batch * bins * n_fr)),
            "istft": (frames * (rfft_flops(n_fft) + 2 * bins + 2 * n_fft) + batch * wav_len,
                      4.0 * (2 * batch * bins * n_fr + batch * wav_len))}


def train_step_flops(spec: ModelSpec, batch: int, n_fft: int, hop: int, wav_len: int,
                     n_params: int) -> float:
    """A train step: featurize (two STFTs), 3x the forward, AdamW."""
    f_bins, frames = n_fft // 2 + 1, num_frames(n_fft, hop, wav_len)
    fwd = forward_flops(spec, batch, f_bins, frames)["total"]
    return 2.0 * stft_work(n_fft, hop, batch, wav_len)["stft"][0] + 3.0 * fwd + 10.0 * n_params


def enhance_flops(spec: ModelSpec, batch: int, n_fft: int, hop: int, wav_len: int) -> float:
    """One enhancement batch: the forward, the STFT and the iSTFT."""
    f_bins, frames = n_fft // 2 + 1, num_frames(n_fft, hop, wav_len)
    w = stft_work(n_fft, hop, batch, wav_len)
    return forward_flops(spec, batch, f_bins, frames)["total"] + w["stft"][0] + w["istft"][0]


def patch_grid(spec: ModelSpec, f_bins: int, frames: int) -> Tuple[int, int, int]:
    """``(h, w, frames a patch column spans)`` of the transformer's grid."""
    down = spec.patch_size
    f, t = f_bins, frames
    for p in spec.encoder_pool_sizes:
        if p > 1:
            f, t, down = f // p, t // p, down * p
    return f // spec.patch_size, t // spec.patch_size, down


def kept_keys(spec: ModelSpec, f_bins: int, frames: int, hop: int,
              lengths: Sequence[int] | None) -> list[int]:
    """Keys each row's attention keeps: every patch, or with a length (the
    validity mask) the patches of the columns that overlap a real frame."""
    h, w, down = patch_grid(spec, f_bins, frames)
    if lengths is None:
        return [h * w]
    out = []
    for n in lengths:
        valid_frames = 1 + math.ceil(max(int(n), 1) / hop)
        cols = min(w, -(-valid_frames // down))
        out.append(h * cols)
    return out


def attention_work(spec: ModelSpec, f_bins: int, frames: int, hop: int,
                   lengths: Sequence[int] | None, rows: int) -> dict:
    """``{"fwd": (ops, bytes), "bwd": (ops, bytes)}`` of the attention
    calls of one forward (every layer) over ``rows`` rows, fp32."""
    h, w, _ = patch_grid(spec, f_bins, frames)
    n = h * w
    d = spec.embed_dim // spec.num_heads
    keys = kept_keys(spec, f_bins, frames, hop, lengths)
    if len(keys) == 1 and rows > 1:
        keys = keys * rows
    ops = sum(4.0 * spec.num_heads * n * nk * d for nk in keys) * spec.num_layers
    qkvo = 4.0 * rows * spec.num_heads * n * d * spec.num_layers
    return {"fwd": (ops, 4.0 * qkvo), "bwd": (2.5 * ops, 4.0 * 2.0 * qkvo)}


def bound_s(ops: float, nbytes: float, peak_ops: float, bytes_per_s: float) -> float:
    """Least time the card could take: the larger of the two bounds."""
    return max(ops / peak_ops, nbytes / bytes_per_s)
