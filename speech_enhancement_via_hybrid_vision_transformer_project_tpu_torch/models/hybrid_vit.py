"""Hybrid CNN-ViT speech-enhancement model (JAX ``models/hybrid_vit.py``).

CNN encoder -> conv patchify -> positional embedding -> pre-norm ViT ->
token->feature projection -> CNN decoder with U-Net skips -> either the
``resize`` head (final 1-channel Tanh block, bilinear stretch to [F, T]) or
the ``fullres_mask`` head (sub-pixel upsample, full-resolution input skip,
two refinement convs, Tanh).

The public forward takes and returns the JAX layout ``[B, F, T, C]`` so the
two packages compare like with like; inside it runs NCHW. ``model.train()``
is the JAX ``train=True``: BatchNorm batch statistics, dropout, drop-path.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from .attention import VisionTransformer
from .components import (
    ConvBlock,
    PatchEmbedding,
    PositionalEncoding,
    PositionalEncoding2D,
    TransposeConvBlock,
)


class HybridViT(nn.Module):
    """Hybrid Vision Transformer for magnitude-spectrogram denoising.

    Keyword arguments are the JAX ``HybridViT``'s. ``dropout``,
    ``attn_dropout`` and ``drop_path_rate`` act in training only.
    ``use_pallas_attention`` is a TPU dispatch knob, accepted and ignored:
    attention here dispatches on the device (kernel K2 on CUDA).
    ``fold_bn=True`` builds the inference form whose BatchNorm is folded
    into the convs (``models/fold.py``): biased convs, no BatchNorm.
    ``remat`` recomputes the transformer blocks' activations in the backward
    (training only). ``attention_type`` is ``"standard"`` or ``"linear"``.

    ``compute_dtype`` is what the JAX package's ``compute_dtype`` computes:
    ``torch.bfloat16`` rounds the input to bf16 once, and every layer after
    it runs in float32 (flax's convs and dense layers, built without a
    ``dtype``, promote a bf16 input against their float32 parameters back to
    float32). ``torch.float32`` changes nothing; any other dtype raises.
    """

    def __init__(
        self,
        input_channels: int = 1,
        output_channels: int = 1,
        encoder_channels: Sequence[int] = (64, 128, 256),
        encoder_kernel_sizes: Sequence[int] = (3, 3, 3),
        encoder_pool_sizes: Sequence[int] = (2, 2, 1),
        embed_dim: int = 512,
        num_heads: int = 8,
        num_layers: int = 6,
        mlp_ratio: float = 4.0,
        patch_size: int = 4,
        decoder_channels: Sequence[int] = (256, 128, 64, 1),
        decoder_kernel_sizes: Sequence[int] = (3, 3, 3, 3),
        decoder_upsample_factors: Sequence[int] = (1, 2, 2, 1),
        dropout: float = 0.1,
        attn_dropout: float = 0.1,
        drop_path_rate: float = 0.1,
        use_skip_connections: bool = True,
        use_cls_token: bool = False,
        max_patches: int = 10000,
        max_freq_patches: int = 64,
        pos_embed_type: str = "learned_1d",
        use_pallas_attention: bool = False,
        attention_type: str = "standard",
        head_type: str = "resize",
        head_channels: int = 16,
        head_freq_up: int = 4,
        head_time_up: int = 4,
        remat: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        fold_bn: bool = False,
    ):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(
                f"compute_dtype must be torch.float32 or torch.bfloat16, got {compute_dtype}"
            )
        if head_type not in ("resize", "fullres_mask"):
            raise ValueError(
                f"unknown head_type {head_type!r} (expected 'resize' or 'fullres_mask')"
            )
        if pos_embed_type not in ("learned_1d", "sinusoidal", "factored_2d"):
            raise ValueError(
                f"unknown pos_embed_type {pos_embed_type!r} "
                "(expected 'learned_1d', 'sinusoidal' or 'factored_2d')"
            )
        # the architecture's fields, as the JAX module's dataclass holds them
        # (tools.flops.spec_from_model reads them)
        self.input_channels, self.output_channels = input_channels, output_channels
        self.encoder_channels = tuple(encoder_channels)
        self.encoder_kernel_sizes = tuple(encoder_kernel_sizes)
        self.encoder_pool_sizes = tuple(encoder_pool_sizes)
        self.num_heads, self.num_layers, self.mlp_ratio = num_heads, num_layers, mlp_ratio
        self.decoder_channels = tuple(decoder_channels)
        self.decoder_kernel_sizes = tuple(decoder_kernel_sizes)
        self.decoder_upsample_factors = tuple(decoder_upsample_factors)
        self.use_skip_connections = use_skip_connections
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.pos_embed_type = pos_embed_type
        self.use_cls_token = use_cls_token
        self.head_type = head_type
        self.head_channels = head_channels
        self.head_freq_up, self.head_time_up = head_freq_up, head_time_up
        self.fold_bn = fold_bn
        self.compute_dtype = compute_dtype

        # 1. CNN encoder
        self.encoder = nn.ModuleList()
        ch_in = input_channels
        enc_out = []
        for ch, k, p in zip(encoder_channels, encoder_kernel_sizes, encoder_pool_sizes):
            self.encoder.append(ConvBlock(ch_in, ch, k, p if p > 1 else None, dropout=dropout,
                                          use_batchnorm=not fold_bn))
            enc_out.append(ch)
            ch_in = ch

        # 2-4. patchify, positional embedding, optional CLS, transformer
        self.patch_embed = PatchEmbedding(ch_in, embed_dim, patch_size)
        if pos_embed_type == "factored_2d":
            self.pos_encoding = PositionalEncoding2D(embed_dim, max_freq_patches, max_patches,
                                                     dropout=dropout)
        else:
            self.pos_encoding = PositionalEncoding(
                embed_dim, max_patches, learnable=pos_embed_type == "learned_1d", dropout=dropout
            )
        self.cls_token = (
            nn.Parameter(torch.zeros(1, 1, embed_dim)) if use_cls_token else None
        )
        self.transformer = VisionTransformer(embed_dim, num_layers, num_heads, mlp_ratio,
                                             dropout=dropout, attn_dropout=attn_dropout,
                                             drop_path_rate=drop_path_rate,
                                             attention_type=attention_type, remat=remat)
        self.to_feature_map = nn.Linear(embed_dim, encoder_channels[-1])

        # 5. CNN decoder with U-Net skips (deep to shallow)
        rev_skips = enc_out[::-1]
        n_dec = len(decoder_channels)
        fullres = head_type == "fullres_mask"
        self.decoder = nn.ModuleList()
        self.skip_proj = nn.ModuleDict()
        cur = encoder_channels[-1]
        for i, (ch, k, up) in enumerate(
            zip(decoder_channels, decoder_kernel_sizes, decoder_upsample_factors)
        ):
            is_final = i == n_dec - 1
            if is_final and fullres:
                break  # the fullres head replaces the final Tanh block
            block_in = cur
            if use_skip_connections and not is_final and i < len(rev_skips):
                self.skip_proj[str(i)] = nn.Conv2d(rev_skips[i], ch, 1)
                block_in += ch
            self.decoder.append(
                TransposeConvBlock(block_in, ch, k, up if up > 1 else None,
                                   final_layer=is_final, dropout=dropout,
                                   use_batchnorm=not fold_bn)
            )
            cur = ch

        # 6. fullres_mask head
        if fullres:
            fu, tu = head_freq_up, head_time_up
            self.head_subpixel = nn.Conv2d(cur, head_channels * fu * tu, 3, padding=1)
            self.head_refine = nn.Conv2d(head_channels + input_channels, head_channels, 3, padding=1)
            self.head_out = nn.Conv2d(head_channels, output_channels, 3, padding=1)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        return_attentions: bool = False,
        stage_out: Optional[str] = None,
    ):
        """Enhance a normalized magnitude spectrogram.

        Args:
          x: ``[B, F, T, C]`` normalized magnitudes (the JAX layout).
          mask: optional ``[B, N]`` bool patch-validity mask.
          return_attentions: also return per-layer attention maps.
          stage_out: early return after ``"encoder"``, ``"transformer"``
            (tokens -> feature map) or ``"pre_resize"`` (decoder output),
            in ``[B, H, W, C]``.

        Returns ``[B, F, T, C_out]`` in [-1, 1].
        """
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        in_f, in_t = x.shape[1], x.shape[2]
        x = x.to(self.compute_dtype).float().permute(0, 3, 1, 2).contiguous()  # NCHW
        x_in = x

        skips = []
        for block in self.encoder:
            x = block(x)
            skips.append(x)
        if stage_out == "encoder":
            return nhwc(x)

        tokens, (h, w) = self.patch_embed(x)
        if self.pos_embed_type == "factored_2d":
            tokens = self.pos_encoding(tokens, (h, w))
        if self.cls_token is not None:
            tokens = torch.cat([self.cls_token.expand(tokens.shape[0], -1, -1), tokens], 1)
            if mask is not None:
                mask = torch.cat([mask.new_ones(mask.shape[0], 1), mask], 1)
        if self.pos_embed_type != "factored_2d":
            tokens = self.pos_encoding(tokens)
        attentions = None
        if return_attentions:
            tokens, attentions = self.transformer(tokens, mask=mask, return_all_attentions=True)
        else:
            tokens = self.transformer(tokens, mask=mask)
        if self.cls_token is not None:
            tokens = tokens[:, 1:, :]

        feat = self.to_feature_map(tokens)  # [B, h*w, C]
        x = feat.transpose(1, 2).reshape(feat.shape[0], -1, h, w)
        if stage_out == "transformer":
            return nhwc(x)

        rev_skips = skips[::-1]
        for i, block in enumerate(self.decoder):
            proj = self.skip_proj[str(i)] if str(i) in self.skip_proj else None
            if proj is not None:
                skip = resize_bilinear(proj(rev_skips[i]), x.shape[-2:])
                x = torch.cat([x, skip], dim=1)
            x = block(x)
        if stage_out == "pre_resize":
            return nhwc(x)

        if self.head_type == "fullres_mask":
            fu, tu, c = self.head_freq_up, self.head_time_up, self.head_channels
            hs = self.head_subpixel(x)
            b, _, f0, t0 = hs.shape
            # depth to space in the JAX channel order (a*tu + b)*C + c, which
            # is not F.pixel_shuffle's c*r*r + a*r + b
            hs = hs.reshape(b, fu, tu, c, f0, t0).permute(0, 3, 4, 1, 5, 2)
            hs = hs.reshape(b, c, f0 * fu, t0 * tu)
            hs = resize_bilinear(hs, (in_f, in_t))
            hs = F.relu(self.head_refine(torch.cat([hs, x_in], dim=1)))
            x = torch.tanh(self.head_out(hs))
        else:
            x = resize_bilinear(x, (in_f, in_t))
        out = nhwc(x)
        if return_attentions:
            return out, attentions
        return out


# ---------------------------------------------------------------------------
# Initialization (the JAX package's initializers, from a torch.Generator)
# ---------------------------------------------------------------------------


def _trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """N(0, std) truncated to +-2 std by inverse-CDF sampling (flax
    ``truncated_normal(stddev)``)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    t.erfinv_().mul_(std * math.sqrt(2.0))


@torch.no_grad()
def init_weights(model: HybridViT, generator: torch.Generator) -> HybridViT:
    """Random weights as the JAX package draws them: convs kaiming-normal
    (fan_out, ReLU gain), dense layers, 1x1 skip projections and positional
    tables truncated-normal(0.02), biases 0, norms identity."""
    skip_convs = set(map(id, model.skip_proj.values()))
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            if id(mod) in skip_convs:
                _trunc_normal_(mod.weight, 0.02, generator)
            else:
                fan_out = mod.weight.shape[0] * mod.weight[0, 0].numel()
                mod.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            _trunc_normal_(mod.weight, 0.02, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            mod.reset_parameters()
    for name, p in model.named_parameters():
        if name.startswith("pos_encoding.") or name == "cls_token":
            _trunc_normal_(p, 0.02, generator)
    return model


# ---------------------------------------------------------------------------
# Config -> model
# ---------------------------------------------------------------------------


def _derive_max_freq_patches(config: Dict) -> int:
    """Frequency patch-grid size implied by the config's STFT geometry."""
    mc = config.get("model", {})
    f = config.get("spectrogram", {}).get(
        "n_freq_bins", config.get("audio", {}).get("n_fft", 512) // 2 + 1
    )
    for p in mc.get("encoder", {}).get("pool_sizes", (2, 2, 1)):
        f //= max(int(p), 1)
    h = max(1, f // int(mc.get("transformer", {}).get("patch_size", 4)))
    return max(64, h)


def create_hybrid_vit(config: Optional[Dict] = None, **overrides) -> HybridViT:
    """Build a HybridViT, in eval mode, from the merged config dict (the JAX
    ``create_hybrid_vit``'s keys; of ``tpu.*`` only ``remat`` is read: the
    train CLI picks ``compute_dtype`` and passes it as an override)."""
    config = config or {}
    mc = config.get("model", {})
    enc = mc.get("encoder", {})
    tr = mc.get("transformer", {})
    dec = mc.get("decoder", {})
    kwargs = dict(
        input_channels=mc.get("input_channels", 1),
        output_channels=mc.get("output_channels", 1),
        encoder_channels=tuple(enc.get("channels", (64, 128, 256))),
        encoder_kernel_sizes=tuple(enc.get("kernel_sizes", (3, 3, 3))),
        encoder_pool_sizes=tuple(enc.get("pool_sizes", (2, 2, 1))),
        embed_dim=tr.get("embed_dim", 512),
        num_heads=tr.get("num_heads", 8),
        num_layers=tr.get("num_layers", 6),
        mlp_ratio=float(tr.get("mlp_ratio", 4)),
        patch_size=tr.get("patch_size", 4),
        decoder_channels=tuple(dec.get("channels", (256, 128, 64, 1))),
        decoder_kernel_sizes=tuple(dec.get("kernel_sizes", (3, 3, 3, 3))),
        decoder_upsample_factors=tuple(dec.get("upsample_factors", (1, 2, 2, 1))),
        dropout=enc.get("dropout", 0.1),
        attn_dropout=tr.get("attention_dropout", 0.1),
        drop_path_rate=tr.get("drop_path_rate", 0.1),
        use_skip_connections=dec.get("use_skip_connections", True),
        pos_embed_type=tr.get("pos_embed", "learned_1d"),
        remat=tr.get("remat", config.get("tpu", {}).get("remat", False)),
        max_freq_patches=tr.get("max_freq_patches", _derive_max_freq_patches(config)),
        attention_type=tr.get("attention_type", "standard"),
        head_type=mc.get("head", "resize"),
        head_channels=mc.get("head_channels", 16),
    )
    kwargs.update(overrides)
    if kwargs["head_type"] == "fullres_mask":
        ups = kwargs["decoder_upsample_factors"]
        # the fullres head skips the final decoder block, so its upsample
        # never runs; the JAX package counts it anyway, which is right only
        # when it is 1
        if int(ups[-1]) != 1:
            raise ValueError(
                "head 'fullres_mask' needs decoder_upsample_factors[-1] == 1, "
                f"got {tuple(ups)}"
            )
        down = int(kwargs["patch_size"])
        for p in kwargs["encoder_pool_sizes"]:
            down *= max(int(p), 1)
        up = 1
        for u in ups:
            up *= max(int(u), 1)
        rem = max(1, down // up)
        kwargs.setdefault("head_freq_up", rem)
        kwargs.setdefault("head_time_up", rem)
    return HybridViT(**kwargs).eval()


_COMPONENTS = {  # JAX component: prefixes of its top-level flax module names
    "encoder": ("encoder_",),
    "transformer": ("transformer",),
    "decoder": ("decoder_", "skip_proj_"),
    "patch_embed": ("patch_embed",),
    "pos_encoding": ("pos_encoding",),
    "head": ("head_",),
}


def count_parameters(model: nn.Module) -> Dict[str, int]:
    """Parameter counts by the JAX package's components (each parameter
    named as the checkpoint mapping names it in flax), plus ``total`` and
    ``trainable`` (those that require grad). BatchNorm statistics are
    buffers and are not counted, as flax keeps them out of ``params``."""
    from ..utils.checkpoint import _flax_path

    counts = dict.fromkeys((*_COMPONENTS, "total", "trainable"), 0)
    for name, p in model.named_parameters():
        top = _flax_path(name, p.dim())[1][0]
        for component, prefixes in _COMPONENTS.items():
            if top.startswith(prefixes):
                counts[component] += p.numel()
        counts["total"] += p.numel()
        counts["trainable"] += p.numel() if p.requires_grad else 0
    return counts
