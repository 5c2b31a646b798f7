"""Bucketed-with-padding-mask vs exact-length enhancement delta (the port's
``benchmarks/bench_mask_delta.py``, with the same clips and report).

The exact-length oracle enhances each utterance at its exact length, batch 1,
unpadded. The throughput path pads to bucket lengths, which perturbs global
attention; ``mask_padding`` excludes padding patches from attention. This
tool measures each bucketed mode's output against the oracle, in PCM16 LSB
(1 LSB = 1/32768 full scale) and relative RMS, over synthetic clips whose
lengths fall deep inside buckets (the worst case for padding): the error
budget of the bucketing.

The model is the tool's small configuration, or the 28M default with
``--full-size``, with weights drawn by ``init_weights`` from
``torch.Generator().manual_seed(seed)``. A torch seed cannot reproduce the JAX
package's ``PRNGKey`` initialization, so this report is not the JAX tool's
for the same seed; ``measure`` on the JAX tool's weights (carried across with
``utils.checkpoint.flax_to_state_dict``) is, within float32 rounding.

On ``cuda`` each clip launches kernels K1 and K3 three times (oracle,
unmasked, masked) and K2 three times in each transformer block; ``cpu`` runs
their plain versions.

    python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.bench_mask_delta \\
        [--device cuda|cpu] [--seed 0] [--full-size] [--pos-embed factored_2d]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

# clip lengths in hops: ~25%..90% fill of the 128..1024-frame buckets, the
# most padding each bucket sees
LENGTH_FRAMES = (67, 130, 200, 310, 500, 750, 990)
SMALL = dict(embed_dim=96, num_layers=2, num_heads=4, encoder_channels=(16, 32, 96))


def build_model(full_size: bool, pos_embed: str):
    """The tool's model, before its weights are drawn: the 28M default, or
    the small configuration."""
    from ..models import HybridViT

    return HybridViT(pos_embed_type=pos_embed, **({} if full_size else SMALL))


def measure(model, config: dict, device: str, lengths, seed: int,
            waveforms: list | None = None) -> dict:
    """The report over clips of ``lengths`` samples, each a 220 Hz tone in
    white noise drawn in turn from ``np.random.default_rng(seed)``.
    ``waveforms``: a list that receives each clip's (exact, unmasked,
    masked) outputs."""
    from ..inference import AudioEnhancer

    def make(**kw):
        return AudioEnhancer(model, config, device=device, **kw)

    exact = make()
    unmasked = make(mask_padding=False)
    masked = make(mask_padding=True)

    rng = np.random.default_rng(seed)
    report = {"lsb": 1.0 / 32768.0, "clips": []}
    worst = {"unmasked": 0.0, "masked": 0.0}
    for n in lengths:
        t = np.arange(n, dtype=np.float32) / 16000.0
        wav = (0.5 * np.sin(2 * np.pi * 220 * t)
               + 0.1 * rng.standard_normal(n)).astype(np.float32)
        wav /= np.abs(wav).max()
        ref = exact.enhance(wav, exact=True)
        ref_rms = float(np.sqrt(np.mean(ref**2)) + 1e-12)
        row = {"samples": n}
        outs = [ref]
        for name, enh in (("unmasked", unmasked), ("masked", masked)):
            out = enh.enhance(wav)
            outs.append(out)
            d = np.abs(out - ref).max() * 32768.0  # PCM16 LSBs
            row[name + "_max_lsb"] = float(d)
            row[name + "_rel_rms"] = float(np.sqrt(np.mean((out - ref) ** 2)) / ref_rms)
            worst[name] = max(worst[name], float(d))
        if waveforms is not None:
            waveforms.append(tuple(outs))
        report["clips"].append(row)
    report["worst_max_lsb"] = worst
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-size", action="store_true",
                    help="use the default 28M model instead of the small "
                         "test config (slower)")
    ap.add_argument("--pos-embed", default="learned_1d",
                    choices=["learned_1d", "factored_2d"],
                    help="positional-embedding variant (factored_2d makes "
                         "valid-patch embeddings bucket-width invariant)")
    args = ap.parse_args(argv)

    import torch

    from ..cli._runtime import use_device
    from ..models import init_weights
    from ..ops.stft import STFTConfig

    use_device(args.device)
    model = init_weights(build_model(args.full_size, args.pos_embed),
                         torch.Generator().manual_seed(args.seed))
    hop = STFTConfig().hop_length
    report = measure(model, {}, args.device, [f * hop for f in LENGTH_FRAMES], args.seed)
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
