"""Per-stage roofline of the inference core on the card (the port's
``benchmarks/roofline.py``, with its byte model).

For each stage of the core this computes, analytically:

  * FLOPs (``tools/flops.py``, the JAX script's count), and
  * bytes moved, from the JAX script's model of what is materialized
    between stages (activations of ``A`` bytes an element, 4 by default:
    the port's activations are float32; elementwise work fused into its
    producer; softmax one more read and write of the score tensor; weights
    read once a use),

then each stage's bound ``t >= max(FLOPs / peak, bytes / memory rate)`` at
the card's data-sheet peaks (``flops.peak_flops`` for the math mode in
force, ``flops.peak_bytes_per_s``), and which of the two bounds it. The
"MFU ceiling" column is the highest share of the peak the stage could
reach at its bound.

The card is the visible one (``--device cuda``), or on a machine without
one the data-sheet entry ``--card`` names (``--device cpu``; without
``--card`` the bounds are null: no peak is guessed). ``--stages-json`` reads
the per-stage times that ``tools.bench_stages --json-out`` wrote, takes the
batch and length from it, refuses a file measured on another card, and sets
each stage's time beside its bound. There is no default file.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.roofline \\
        [--batch 32] [--frames 376] [--scaled] [--fullres] [--A 4]
        [--device cuda|cpu] [--card NAME] [--stages-json F] [--out F]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from .flops import ModelSpec, forward_flops, stft_flops

# the roofline's stages and the bench_stages labels whose times they sum
MEASURED_BY = {
    "encoder": ("encoder_convs",),
    "transformer": ("transformer",),
    "decoder": ("decoder_convs", "final_resize"),
    "dsp (stft+istft)": ("dsp_front(stft+norm)", "istft"),
}


def encoder_bytes(spec: ModelSpec, b: int, f: int, t: int, A: int = 4) -> float:
    """ConvBlock = conv (BN/ReLU/dropout fused) then VALID maxpool: the conv
    reads its input and weights and writes its output; the pool reads the
    conv output and writes the pooled map."""
    total = 0.0
    cin = spec.input_channels
    for ch, k, p in zip(
        spec.encoder_channels, spec.encoder_kernel_sizes,
        spec.encoder_pool_sizes,
    ):
        total += A * b * f * t * (cin + ch)  # conv in + out
        total += A * cin * ch * k * k  # weights (once)
        if p > 1:
            total += A * b * f * t * ch  # pool reads conv out...
            f, t = f // p, t // p
            total += A * b * f * t * ch  # ...writes pooled
        cin = ch
    return total


def transformer_bytes(spec: ModelSpec, b: int, n: int, A: int = 4) -> float:
    """Pre-norm block traffic per layer. LN costs one read and write of X;
    the qkv, projection and MLP products read their input and write their
    output; the residual add fuses into the consumer. Score tensor [H, N,
    N]: written by QK^T, read and written by softmax, read by AV."""
    d, hh = spec.embed_dim, spec.num_heads
    nd = b * n * d
    score = b * hh * n * n
    per_layer = (
        A * 2 * nd  # LN1 read+write
        + A * (nd + 3 * nd)  # qkv: read X, write Q,K,V
        + A * (2 * nd + score)  # QK^T: read Q,K, write scores
        + A * 2 * score  # softmax read+write
        + A * (score + nd + nd)  # AV: read probs, V; write ctx
        + A * (nd + nd + nd)  # proj: read ctx, write; + residual read X
        + A * 2 * nd  # LN2
        + A * (nd + spec.mlp_ratio * nd)  # MLP up (GELU fused)
        + A * (spec.mlp_ratio * nd + nd + nd)  # MLP down + residual read
        + A * 12 * d * d  # weights: qkv 3d² + proj d² + mlp 8d²
    )
    # patch embed (read encoder out, write tokens) + final LN + to_feature_map
    f_patch = A * (b * n * spec.patch_size**2 * spec.encoder_channels[-1]
                   + nd)
    tail = A * (2 * nd + nd + b * n * spec.encoder_channels[-1])
    return spec.num_layers * per_layer + f_patch + tail


def decoder_bytes(spec: ModelSpec, b: int, h: int, w: int,
                  skips: list, A: int = 4) -> float:
    """Skip 1x1 proj + bilinear resize + concat-conv per block; the nearest
    upsample fuses into the conv's input read (it is a broadcast)."""
    total = 0.0
    cx = spec.encoder_channels[-1]
    rev = skips[::-1]
    n_dec = len(spec.decoder_channels)
    fullres = spec.head_type == "fullres_mask"
    for i, (ch, k, up) in enumerate(
        zip(spec.decoder_channels, spec.decoder_kernel_sizes,
            spec.decoder_upsample_factors)
    ):
        is_final = i == n_dec - 1
        if is_final and fullres:
            break
        cat = cx
        if spec.use_skip_connections and not is_final and i < len(rev):
            sf, st, sc = rev[i]
            total += A * b * sf * st * (sc + ch)  # 1x1 proj in+out
            if (sf, st) != (h, w):
                total += A * b * (sf * st + h * w) * ch  # resize in+out
            cat = cx + ch
        if up and up > 1:
            h, w = h * up, w * up
        total += A * b * (h * w * cat / (up * up if up else 1)
                          + h * w * ch)  # conv reads pre-up, writes out
        total += A * cat * ch * k * k
        cx = ch
    return total


def head_bytes(spec: ModelSpec, b: int, h: int, w: int, f: int,
               t: int, A: int = 4) -> float:
    hc, fu, tu = spec.head_channels, spec.head_freq_up, spec.head_time_up
    total = A * b * h * w * (spec.decoder_channels[-2] + hc * fu * tu)
    total += A * b * f * t * hc * 2  # taps resize read+write
    total += A * b * f * t * (hc + 1 + hc)  # refine conv (+input skip)
    total += A * b * f * t * (hc + spec.output_channels)  # out conv
    return total


def stages(spec: ModelSpec, b: int, f_bins: int, t: int, A: int = 4) -> dict:
    """``{stage: (FLOPs, bytes)}`` of the core at ``[b, f_bins, t]``, as the
    JAX script splits it."""
    fl = forward_flops(spec, b, f_bins, t)
    f, tt = f_bins, t
    skips = []
    for ch, p in zip(spec.encoder_channels, spec.encoder_pool_sizes):
        if p > 1:
            f, tt = f // p, tt // p
        skips.append((f, tt, ch))
    ps = spec.patch_size
    h, w = f // ps, tt // ps
    fullres = spec.head_type == "fullres_mask"
    out = {
        "encoder": (fl["encoder"], encoder_bytes(spec, b, f_bins, t, A)),
        "transformer": (
            fl["attention"] + fl["mlp"] + fl["patch_embed"] + fl["to_feature_map"],
            transformer_bytes(spec, b, h * w, A),
        ),
        "decoder": (
            fl["decoder"] + (0 if fullres else fl["resize"]),
            decoder_bytes(spec, b, h, w, skips, A)
            + (0 if fullres else A * b * (64 * t // 4 + f_bins * t)),
        ),
        "dsp (stft+istft)": (
            2 * stft_flops(b, t),
            A * b * (2 * t * 512 + 4 * f_bins * t) * 2,
        ),
    }
    if fullres:
        out["head"] = (fl["head"], head_bytes(spec, b, h, w, f_bins, t, A))
    return out


def roofline(spec: ModelSpec, b: int, t: int, A: int, peak: Optional[float],
             rate: Optional[float], measured: Optional[dict] = None) -> dict:
    """The stage table and totals at ``peak`` FLOP/s and ``rate`` bytes/s
    (None: FLOPs and bytes only); ``measured``: ms a stage beside its
    bound."""
    rows = []
    tot_fl = tot_by = tot_bound = 0.0
    for name, (flops, byts) in stages(spec, b, 257, t, A).items():
        row = {"stage": name, "GF": round(flops / 1e9, 1), "MB_moved": round(byts / 1e6, 1),
               "arith_intensity_flops_per_byte": round(flops / byts, 1)}
        tot_fl += flops
        tot_by += byts
        if peak and rate:
            t_c, t_b = flops / peak, byts / rate
            t_bound = max(t_c, t_b)
            tot_bound += t_bound
            row.update({
                "t_compute_ms": round(t_c * 1e3, 4),
                "t_bandwidth_ms": round(t_b * 1e3, 4),
                "t_roofline_ms": round(t_bound * 1e3, 4),
                "bound": "operations" if t_c >= t_b else "bytes",
                "mfu_ceiling_pct": round(100 * t_c / t_bound, 1),
            })
            ms = (measured or {}).get(name)
            if ms is not None:
                row["measured_ms"] = round(ms, 4)
                row["share_of_bound_pct"] = round(100 * t_bound * 1e3 / ms, 1)
        rows.append(row)
    out = {"stages": rows, "total_GF": round(tot_fl / 1e9, 1), "total_MB": round(tot_by / 1e6, 1)}
    if peak and rate:
        out["roofline_step_ms"] = round(tot_bound * 1e3, 4)
        out["roofline_mfu_pct"] = round(100 * (tot_fl / peak) / tot_bound, 1)
    return out


def main(argv=None) -> int:
    from .flops import PEAKS, describe_device, math_mode, peak_bytes_per_s, peak_flops

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=376)
    ap.add_argument("--scaled", action="store_true")
    ap.add_argument("--fullres", action="store_true")
    ap.add_argument("--A", type=int, default=4, dest="A",
                    help="bytes an activation element (4: float32, the port's)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the visible card's peaks; cpu: --card's, or none")
    ap.add_argument("--card", default=None, choices=sorted(PEAKS),
                    help="with --device cpu: the data-sheet entry whose peaks to use")
    ap.add_argument("--stages-json", default=None,
                    help="per-stage times written by tools.bench_stages --json-out")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from ..cli._runtime import use_device

    use_device(args.device)
    info = describe_device(args.device)
    card = info["name"] if args.device == "cuda" else args.card
    peak, rate = (peak_flops(card=card), peak_bytes_per_s(card)) if card else (None, None)
    math = math_mode() if peak else None

    spec = ModelSpec()
    if args.scaled:
        spec = ModelSpec(embed_dim=1024, num_heads=16, num_layers=12)
    if args.fullres:
        spec.head_type = "fullres_mask"
    b, t = args.batch, args.frames

    measured = None
    if args.stages_json:
        if args.scaled or args.fullres:
            raise SystemExit("--stages-json: tools.bench_stages times the 28M resize-head model")
        raw = json.loads(Path(args.stages_json).read_text())
        if raw.get("name") is not None and raw["name"] != card:
            raise SystemExit(f"{args.stages_json} was measured on {raw['name']}, "
                             f"the peaks are {card}'s")
        b, t = raw["batch"], raw["wav_len"] // 128 + 1  # STFTConfig's hop, center frames
        stage_ms = raw["stage_ms"]
        measured = {name: (None if any(stage_ms[k] is None for k in labels)
                           else sum(stage_ms[k] for k in labels))
                    for name, labels in MEASURED_BY.items()}

    result = {
        "config": {"batch": b, "frames": t, "model": "168M" if args.scaled else "28M",
                   "head": spec.head_type, "A": args.A},
        "card": card, "power_limit": info["power_limit"], "math": math,
        "peak_tflops": peak and peak / 1e12,
        "hbm_TBps": rate and rate / 1e12,
        "peaks_from": "data sheet" if peak else None,
        **roofline(spec, b, t, args.A, peak, rate, measured),
        "note": ("roofline_mfu_pct is the highest share of the peak any implementation "
                 "of this architecture could reach at this shape if every stage hit its "
                 "own bound"),
    }
    if args.stages_json:
        result["stages_json"] = args.stages_json
    print(json.dumps(result, indent=1))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
