"""CUDA kernels K1-K3, K2's backward, CMGAN's K2r and SEMamba's selective
scan and depthwise conv against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device. The card's
machine has no JAX, so run this file without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances (max abs error): STFT 2e-4 at n_fft 512 (the plain version's
fp32 sums of 512 products against an FFT's rounding), attention and iSTFT
2e-5 (fp32, another summation order), waveforms 2e-4 (whole pipeline on
two devices). K2's backward: each of dq, dk and dv within 1e-4 of that
tensor's largest magnitude, or of 1 where that is smaller (at N = 1 the
true dq and dk are 0, dS = P (dP - Delta) with P = 1 and Delta = dP, and
both sides hold rounding residue): fp32 sums of up to 448 products in
another order, and the weights recomputed from the forward's log-sum-exp
rather than a two-pass softmax. K2r: 5e-5 at q, k and E of N(0, 1)
(logits of O(10) through a softmax over up to 1,001 keys, 3xTF32 products in
another order; an H100 read 1.7e-5 against float64). ``add_layer_norm``:
the stored sum equal to the plain version's (the same two roundings), the
normalised output within 1e-5 of the plain version in fp32 and in float64
(a LayerNorm of 64 values of O(1) to outputs of O(1)-O(5): the mean and
variance summed in another order, a few ulp of the output).
``instance_norm``: the output within 1e-5 of the plain version in fp32 and
in float64 (a plane's mean and variance over up to 331k floats of O(1),
merged in another order, to outputs of O(1)-O(5)), the same bits on every
call. ``selective_scan``: within 1e-4 of the output's largest magnitude of
the plain version in float64 or fp32 (fp32 through up to 819 steps of a
recurrence whose slowest decays keep ~1,000 steps, exp2f against exp).
``conv1d_silu``: within 1e-6 of the output's largest magnitude of the plain
version in float64 (four fp32 products summed into the bias and a SiLU).
"""

import copy
import json

import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
    AudioEnhancer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
    HybridViT,
    init_weights,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
    cuda_attention,
    cuda_stft,
    kernels,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import (
    STFTConfig,
    istft_output_span,
    window_sumsquare_denominator,
)

pytestmark = pytest.mark.cuda

SMALL = dict(embed_dim=64, num_heads=4, num_layers=2, mlp_ratio=2.0,
             encoder_channels=(16, 32, 64), decoder_channels=(32, 16, 8, 1),
             dropout=0.0, attn_dropout=0.0, drop_path_rate=0.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def gen():
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("shape", [(3, 16000), (1, 5123), (2, 600), (2, 300)])
def test_stft_mag_kernel_matches_plain(shape, dev, gen):
    x = torch.randn(shape, generator=gen).to(dev)
    before = kernels.KERNELS["stft_mag"].launches
    out = cuda_stft.stft_mag(x)
    assert kernels.KERNELS["stft_mag"].launches == before + 1
    for o, r in zip(out, cuda_stft.stft_mag_plain(x)):
        assert o.shape == r.shape
        assert float((o - r).abs().max()) < 2e-4


@pytest.mark.parametrize("n_fft", [256, 1024])
@pytest.mark.parametrize("length", ["long", "under_a_tile", "under_a_frame"])
def test_stft_mag_kernel_other_sizes(n_fft, length, dev, gen):
    """hop = n_fft/4. "under_a_tile": fewer frames than a block holds;
    "under_a_frame": fewer samples than n_fft, so the fused reflect padding
    reaches both ends of the signal. Tolerance 2e-4 per 512 points of the
    frame: the plain version's fp32 sums grow with n_fft."""
    cfg = STFTConfig(n_fft=n_fft, hop_length=n_fft // 4, win_length=n_fft)
    n = {"long": 20000, "under_a_tile": 1000, "under_a_frame": n_fft // 2 + 44}[length]
    x = torch.randn(2, n, generator=gen).to(dev)
    for o, r in zip(cuda_stft.stft_mag(x, cfg), cuda_stft.stft_mag_plain(x, cfg)):
        assert o.shape == r.shape
        assert float((o - r).abs().max()) < 2e-4 * n_fft / 512


@pytest.mark.parametrize("n_fft", [256, 1024])
def test_istft_polar_kernel_other_sizes(n_fft, dev, gen):
    """hop = n_fft/4, on the spectrogram of a signal, trimmed to its
    length (the window sums there are >= 1e-2, so no weighting)."""
    cfg = STFTConfig(n_fft=n_fft, hop_length=n_fft // 4, win_length=n_fft)
    x = torch.randn(2, 9000, generator=gen).to(dev)
    re, im, mag = cuda_stft.stft_mag_plain(x, cfg)
    mag, ph = mag.contiguous(), torch.atan2(im, re).contiguous()
    y = cuda_stft.istft_polar(mag, ph, cfg, length=9000)
    r = cuda_stft.istft_polar_plain(mag, ph, cfg, length=9000)
    assert y.shape == r.shape == (2, 9000)
    assert float((y - r).abs().max()) < 2e-5


@pytest.mark.parametrize("n", [1, 37, 63, 64, 65, 129, 200, 384, 448])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_attention_kernel_matches_plain(n, d, dev, gen):
    """N at the kernel's tile edges (64 keys a tile, 32 at d = 128; 64
    query rows a block). Masks: none; random with row 1 fully masked (it
    averages V over N keys); row 0 keeping a single key and row 1
    interleaved as ``patch_validity_mask`` makes it (rows of 24 patch
    columns whose trailing 7 are masked)."""
    q, k, v = (torch.randn(2, 3, n, d, generator=gen).to(dev) for _ in range(3))
    mask = torch.rand(2, n, generator=gen) > 0.3
    mask[1] = False
    edge = torch.zeros(2, n, dtype=torch.bool)
    edge[0, n // 2] = True
    edge[1] = torch.arange(n) % 24 < 17
    for m in (None, mask.to(dev), edge.to(dev)):
        r = cuda_attention.attention_plain(q, k, v, scale=d**-0.5, mask=m)
        before = kernels.KERNELS["attention_fwd"].launches
        o = cuda_attention.attention(q, k, v, scale=d**-0.5, mask=m)
        assert kernels.KERNELS["attention_fwd"].launches == before + 1
        assert float((o - r).abs().max()) < 2e-5


def test_attention_kernel_resources(dev):
    """At the serving path's head dim (64) K2 does not spill, and two blocks
    (eight warps) fit on an SM at every head dim, with or without the
    kept-key list."""
    info = cuda_attention.kernel_info(64, 384)
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2, info
    for d in (16, 32, 64, 128):
        for masked in (False, True):
            assert cuda_attention.kernel_info(d, 384, masked)["blocks_per_sm"] >= 2


def test_attention_kernel_long_mask(dev, gen):
    """A mask over 8,200 keys: the kept-key list (4 bytes a key) and the
    tiles share the block's shared memory; row 0 keeps the first and last
    keys, row 1 keeps none."""
    n, d = 8200, 16
    q, k, v = (torch.randn(2, 1, n, d, generator=gen).to(dev) for _ in range(3))
    mask = torch.zeros(2, n, dtype=torch.bool)
    mask[0, [0, n - 1]] = True
    mask = mask.to(dev)
    o = cuda_attention.attention(q, k, v, scale=d**-0.5, mask=mask)
    r = cuda_attention.attention_plain(q, k, v, scale=d**-0.5, mask=mask)
    assert float((o - r).abs().max()) < 2e-5


@pytest.mark.parametrize("n_frames,length", [(3, 300), (41, None), (41, 9000), (376, 48000)])
def test_istft_polar_kernel_matches_plain(n_frames, length, dev, gen):
    """On the spectrogram of a signal, as the serving path gives it. Where
    ``length`` reaches past the last full overlap (41 frames, 9000), the
    last samples are divided by a window sum that falls to ~1e-9, which
    amplifies the rounding of either summation order by its inverse; there
    the error is weighted by that sum (it is 1.5 inside the signal, so the
    weight is 1 everywhere else), and samples past the overlap-added signal
    must be exact zeros."""
    cfg = STFTConfig()
    x = torch.randn(2, (n_frames - 1) * 128 + 5, generator=gen).to(dev)
    re, im, mag = cuda_stft.stft_mag_plain(x)  # bins-first views of [N, F] products
    mag, ph = mag.contiguous(), torch.atan2(im, re).contiguous()
    assert mag.shape[-1] == n_frames
    y = cuda_stft.istft_polar(mag, ph, length=length)
    r = cuda_stft.istft_polar_plain(mag, ph, length=length)
    assert y.shape == r.shape
    offset, n_out = istft_output_span(cfg, n_frames, length)
    denom = torch.from_numpy(window_sumsquare_denominator(cfg, n_frames))[offset:offset + n_out]
    weight = torch.zeros(n_out)
    weight[: denom.numel()] = torch.clamp(denom, max=1.0)
    assert float(((y - r).abs() * weight.to(dev)).max()) < 2e-5
    assert not y[:, denom.numel():].any()


TOL_BWD = 1e-4  # relative to each gradient's largest magnitude (at least 1)


def _rel_err(got, ref):
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)
               for a, b in zip(got, ref))


@pytest.mark.parametrize("n", [1, 37, 63, 64, 65, 200, 384])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_attention_bwd_kernel_matches_plain(n, d, dev, gen):
    """K2's backward through the autograd Function against autograd through
    the plain version, masks as in the forward's test. A masked key of a
    row that keeps any key gets exactly zero dk and dv; a row that keeps
    none gets zero dq and dk, and dv the mean of dO."""
    q, k, v, dout = (torch.randn(2, 3, n, d, generator=gen).to(dev) for _ in range(4))
    mask = torch.rand(2, n, generator=gen) > 0.3
    mask[1] = False
    edge = torch.zeros(2, n, dtype=torch.bool)
    edge[0, n // 2] = True
    edge[1] = torch.arange(n) % 24 < 17
    for m in (None, mask.to(dev), edge.to(dev)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        kernels.reset_launch_counts()
        out = cuda_attention.attention(*leaves, scale=d**-0.5, mask=m)
        out.backward(dout)
        assert kernels.KERNELS["attention_fwd"].launches == 1
        assert kernels.KERNELS["attention_bwd"].launches == 1
        got = [t.grad for t in leaves]
        ref = cuda_attention.attention_bwd_plain(q, k, v, dout, scale=d**-0.5, mask=m)
        assert _rel_err(got, ref) < TOL_BWD
        if m is not None:
            for b in range(2):
                dropped = ~m[b]
                if m[b].any():
                    assert not got[1][b][:, dropped].any() and not got[2][b][:, dropped].any()
                else:
                    assert not got[0][b].any() and not got[1][b].any()
                    mean = dout[b].mean(dim=1, keepdim=True).expand_as(got[2][b])
                    assert float((got[2][b] - mean).abs().max()) < 1e-6


def test_attention_grad_dispatch(dev, gen):
    """A CUDA tensor that needs grad goes through the Function, one with no
    grad (or under no_grad) through the forward alone."""
    q = torch.randn(2, 2, 40, 16, generator=gen).to(dev)
    kernels.reset_launch_counts()
    cuda_attention.attention(q, q, q, scale=0.25)
    with torch.no_grad():
        cuda_attention.attention(q.clone().requires_grad_(), q, q, scale=0.25)
    assert kernels.KERNELS["attention_fwd"].launches == 2
    x = q.clone().requires_grad_()
    cuda_attention.attention(x, x, x, scale=0.25).sum().backward()
    assert kernels.KERNELS["attention_bwd"].launches == 1 and x.grad is not None


def test_attention_bwd_kernel_resources(dev):
    """No spills at the training path's head dim (64)."""
    info = cuda_attention.bwd_kernel_info(64)
    assert info["dq"]["local_bytes"] == 0 and info["dkdv"]["local_bytes"] == 0, info


def test_attention_bwd_kernel_long_mask(dev, gen):
    """The backward under the forward's 8,200-key mask: the kept-key list
    beside the A operands and tiles in shared memory; row 0 keeps the first
    and last keys, row 1 keeps none."""
    n, d = 8200, 16
    q, k, v, dout = (torch.randn(2, 1, n, d, generator=gen).to(dev) for _ in range(4))
    mask = torch.zeros(2, n, dtype=torch.bool)
    mask[0, [0, n - 1]] = True
    mask = mask.to(dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    cuda_attention.attention(*leaves, scale=d**-0.5, mask=mask).backward(dout)
    ref = cuda_attention.attention_bwd_plain(q, k, v, dout, scale=d**-0.5, mask=mask)
    assert _rel_err([t.grad for t in leaves], ref) < TOL_BWD


class _Capture:
    """Stands in for the optimizer: keeps the gradients it is handed."""

    def __init__(self, params):
        self.params = params
        self.grads = None

    def step(self, grads):
        self.grads = [g.detach().cpu() for g in grads]


@pytest.mark.parametrize("mode,mask_padding", [("magnitude", False), ("mask", True)])
def test_train_step_cuda_matches_cpu(mode, mask_padding, dev):
    """One train step of a small model (dropouts 0, SpecAugment off) on cuda
    against the same step on cpu from the same weights, on a PCM16 batch
    with a short row and a padding row (under ``mask_padding`` a fully
    masked one): loss components within 1e-5, gradients within 1e-3 of the
    model's largest (fp32 on both; cuDNN's backward convolutions sum in
    another order), new BatchNorm statistics within 1e-5. On cuda the step
    runs K1 twice and K2's forward and backward once a block."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.augmentation import (
        SpecAugmentConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.losses import (
        LossConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
        make_step_fns,
    )

    n = 63 * 128  # the 64-frame bucket
    rng = np.random.default_rng(0)
    lengths = np.array([n, 5000, 0], np.int32)
    wav = np.zeros((2, 3, n), np.float32)
    for i, m in enumerate(lengths[:2]):
        wav[1, i, :m] = 0.3 * np.sin(np.arange(m) * 0.05 * (i + 1))
        wav[0, i, :m] = wav[1, i, :m] + 0.1 * rng.standard_normal(m)
    pcm = np.clip(np.rint(wav * 32768), -32768, 32767).astype(np.int16)
    batch = {"noisy_audio": pcm[0], "clean_audio": pcm[1], "length": lengths,
             "valid": np.array([True, True, False])}
    kw = dict(embed_dim=64, num_heads=4, num_layers=2, mlp_ratio=2.0,
              encoder_channels=(16, 32, 64), decoder_channels=(32, 16, 8, 1), dropout=0.0,
              attn_dropout=0.0, drop_path_rate=0.0)
    state = init_weights(HybridViT(**kw), torch.Generator().manual_seed(0)).state_dict()
    res = {}
    for device in ("cuda", "cpu"):
        model = HybridViT(**kw)
        model.load_state_dict(state)
        model.to(device)
        cap = _Capture(list(model.parameters()))
        step, _ = make_step_fns(model, cap, LossConfig(log_l1_weight=0.05), STFTConfig(),
                                SpecAugmentConfig(), augment=False,
                                use_attention_mask=mask_padding, output_mode=mode)
        kernels.reset_launch_counts()
        metrics = step({k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        if device == "cuda":
            torch.cuda.synchronize()
            assert kernels.launched() == {"stft_mag": 2, "attention_fwd": 2, "attention_bwd": 2,
                                          "global_sq_norm": 1}
        res[device] = ({k: float(v) for k, v in metrics.items()}, cap.grads,
                       {k: v.cpu() for k, v in model.state_dict().items() if "running" in k})
    (lc, gc, sc), (lp, gp, sp) = res["cuda"], res["cpu"]
    for k in lp:
        if k != "grad_norm":
            assert abs(lc[k] - lp[k]) <= 1e-5, k
    scale = max(float(g.abs().max()) for g in gp)
    assert max(float((a - b).abs().max()) for a, b in zip(gc, gp)) <= 1e-3 * scale
    for k in sp:
        assert float((sc[k] - sp[k]).abs().max()) <= 1e-5, k


def test_kernels_refuse_what_they_do_not_take(dev, gen):
    """What the kernels refuse. A head dim that is no instance (48), one
    above 128 (136) and an n_fft that is no power of two (500) were refused
    once: they now run on the next instance, on K2's sliced instance at 256,
    and on K1 (250 = 2 5^3) and K3g (a hop that does not divide 500). A pad
    mode numpy lacks is refused."""
    x = torch.randn(2, 4000, generator=gen).to(dev)
    with pytest.raises(RuntimeError, match="backward"):
        cuda_stft.stft_mag(x.clone().requires_grad_())
    with pytest.raises(TypeError):
        cuda_stft.stft_mag(x.double())
    q = torch.randn(1, 2, 16, 64, generator=gen).to(dev)
    q_strided = torch.randn(1, 2, 64, 16, generator=gen).to(dev).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_attention.attention(q_strided, q, q, scale=0.1)
    q48 = torch.randn(1, 2, 16, 48, generator=gen).to(dev)
    before = kernels.KERNELS["attention_fwd"].launches
    o = cuda_attention.attention(q48, q48, q48, scale=0.1)
    assert kernels.KERNELS["attention_fwd"].launches == before + 1
    assert float((o - cuda_attention.attention_plain(q48, q48, q48, scale=0.1)).abs().max()) < 2e-5
    q136 = torch.randn(1, 2, 16, 136, generator=gen).to(dev)
    o = cuda_attention.attention(q136, q136, q136, scale=0.1)
    assert kernels.KERNELS["attention_fwd"].launches == before + 2
    assert float((o - cuda_attention.attention_plain(q136, q136, q136, scale=0.1)).abs().max()) < 2e-5
    with pytest.raises(ValueError, match="devices"):
        cuda_stft.istft_polar(torch.rand(1, 257, 9).to(dev), torch.rand(1, 257, 9))
    odd = STFTConfig(n_fft=500, hop_length=124, win_length=500)
    before = {n: kernels.KERNELS[n].launches for n in ("stft_mag", "istft_dft")}
    out = cuda_stft.stft_mag(x, odd)
    for o, r in zip(out, cuda_stft.stft_mag_plain(x, odd)):
        assert float((o - r).abs().max()) < 2e-4
    m = out[2].contiguous()
    y = cuda_stft.istft_polar(m, m, odd)
    assert float((y - cuda_stft.istft_polar_plain(m, m, odd)).abs().max()) < 2e-5
    assert {n: kernels.KERNELS[n].launches - c for n, c in before.items()} == {
        "stft_mag": 1, "istft_dft": 1}
    with pytest.raises(ValueError, match="pad_mode"):
        cuda_stft.stft_mag(x, STFTConfig(pad_mode="replicate"))


@pytest.mark.parametrize("center,pad_mode", [(False, "reflect"), (True, "edge")])
def test_stft_kernel_reads_the_whole_span_at_odd_m(center, pad_mode, dev, gen):
    """At n_fft 450 (M = 225, odd) a block's signal span is 2 mod 4
    samples. With no padding left to fuse (center=False, or a mode padded
    first) K1 copies aligned spans in 16-byte loads and the last two
    samples one by one. A rectangular window weighs those samples fully
    (Hann's ends would hide a sample left unread), so K1 must match its
    plain version within 2e-3 on every frame."""
    cfg = STFTConfig(n_fft=450, hop_length=100, win_length=450, window="rectangular",
                     center=center, pad_mode=pad_mode)
    assert cuda_stft.route(cfg, inverse=False)[0] == "stft_mag"
    x = torch.randn(3, 20000, generator=gen).to(dev)
    before = kernels.KERNELS["stft_mag"].launches
    out = cuda_stft.stft_mag(x, cfg)
    assert kernels.KERNELS["stft_mag"].launches == before + 1
    for o, r in zip(out, cuda_stft.stft_mag_plain(x, cfg)):
        assert o.shape == r.shape and float((o - r).abs().max()) < 2e-3


@pytest.mark.parametrize("m,stages", [(200, (8, 5)), (200, (8, 25)), (960, (16, 4, 5, 3)),
                                      (128, (16, 8))])
def test_fft_kernels_refuse_a_plan_the_host_does_not_make(m, stages, dev):
    """K1's and K3's C entries check the radix plan they are given
    (``fft_plan_ok``) and return an error before any launch: a plan of
    another product, an unknown radix, a stage of 320 butterflies (more
    than a block's threads) and a radix-8 stage where M is a power of
    two. The wrapper raises and counts no launch."""
    n_fft = 2 * m
    cfg = STFTConfig(n_fft=n_fft, hop_length=n_fft // 4, win_length=n_fft)
    x = torch.zeros(1, 4 * n_fft, device=dev)
    n = cfg.num_frames(x.shape[1])
    table = cuda_stft._device_const("plan", cfg, dev)
    denom = cuda_stft._device_const("denom", cfg, dev, n)
    re, im, mag = (torch.zeros(1, cfg.num_bins, n, device=dev) for _ in range(3))
    plan = cuda_stft.pack_radices(stages)
    before = {k: kernels.KERNELS[k].launches for k in ("stft_mag", "istft_polar")}
    with pytest.raises(RuntimeError, match="stft_mag: CUDA launch failed"):
        kernels.launch("stft_mag", x.data_ptr(), table.data_ptr(), re.data_ptr(), im.data_ptr(),
                       mag.data_ptr(), 1, x.shape[1], m, 1, n, n_fft, cfg.hop_length, 16, plan)
    with pytest.raises(RuntimeError, match="istft_polar: CUDA launch failed"):
        kernels.launch("istft_polar", mag.data_ptr(), mag.data_ptr(), table.data_ptr(),
                       denom.data_ptr(), x.data_ptr(), 1, n, n_fft, cfg.hop_length, m,
                       x.shape[1], 16, plan)
    torch.cuda.synchronize()
    assert {k: kernels.KERNELS[k].launches for k in before} == before


def test_enhancer_cuda_matches_cpu(dev, gen):
    model = init_weights(HybridViT(embed_dim=64, num_heads=4, num_layers=2, mlp_ratio=2.0,
                                   encoder_channels=(16, 32, 64), decoder_channels=(32, 16, 8, 1),
                                   pos_embed_type="factored_2d", head_type="fullres_mask",
                                   head_channels=8), gen)
    rng = np.random.default_rng(0)
    wavs = [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in (16000, 9000, 40000)]
    cfg = {"model": {"output_mode": "mask"}}
    ref = AudioEnhancer(model, cfg, device="cpu", buckets=(128, 256), mask_padding=True
                        ).enhance_batch(wavs)
    kernels.reset_launch_counts()
    out = AudioEnhancer(model, cfg, device=dev, buckets=(128, 256), mask_padding=True
                        ).enhance_batch(wavs)
    # the serving path runs every forward kernel of the HybridViT at 512/128, and no other
    assert set(kernels.launched()) == {"stft_mag", "attention_fwd", "istft_polar"}
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) < 2e-4


def _small_enhancer_model(gen, perturb_bn: bool = False):
    model = init_weights(HybridViT(embed_dim=64, num_heads=4, num_layers=2, mlp_ratio=2.0,
                                   encoder_channels=(16, 32, 64), decoder_channels=(32, 16, 8, 1),
                                   pos_embed_type="factored_2d", head_type="fullres_mask",
                                   head_channels=8), gen)
    if perturb_bn:  # non-trivial statistics, or the fold is nearly the identity
        rng = np.random.default_rng(1)
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, torch.nn.BatchNorm2d):
                    n = mod.num_features
                    mod.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
                    mod.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.3, n)))
                    mod.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.5, n)))
                    mod.running_var.copy_(torch.from_numpy(rng.uniform(0.2, 3.0, n)))
    return model


@pytest.mark.parametrize("io_dtype", ["float32", "int16"])
def test_enhance_batch_async_two_in_flight_matches_blocking(io_dtype, dev, gen):
    """Batches dispatched two ahead of the one being read (pinned staging,
    non-blocking copies, an event per batch) come back equal to the blocking
    path's, each row trimmed to its clip."""
    model = _small_enhancer_model(gen)
    enh = AudioEnhancer(model, {"model": {"output_mode": "mask"}}, device=dev,
                        buckets=(128, 256), mask_padding=True, io_dtype=io_dtype)
    rng = np.random.default_rng(2)
    batches = [[(0.3 * rng.standard_normal(n)).astype(np.float32) for n in (16000, 9000, 30000)]
               for _ in range(5)]
    blocking = [enh.enhance_batch(b) for b in batches]
    pending, got = [], []
    for b in batches:
        pending.append(enh.enhance_batch_async(b))
        if len(pending) > 2:
            got.append(pending.pop(0).result())
    got += [p.result() for p in pending]
    for out, ref, wavs in zip(got, blocking, batches):
        for row, r, w in zip(out, ref, wavs):
            np.testing.assert_array_equal(row[: len(w)], r)


def test_fold_bn_enhancer_matches_unfolded_on_cuda(dev, gen):
    """Folded and unfolded on the card agree within the 2e-4 waveform limit
    (cuDNN may pick another algorithm for a conv with a bias)."""
    model = _small_enhancer_model(gen, perturb_bn=True)
    rng = np.random.default_rng(3)
    wavs = [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in (16000, 9000, 40000)]
    cfg = {"model": {"output_mode": "mask"}}
    plain = AudioEnhancer(model, cfg, device=dev, buckets=(128, 256), mask_padding=True)
    folded = AudioEnhancer(model, cfg, device=dev, buckets=(128, 256), mask_padding=True,
                           fold_bn=True)
    assert folded.model.fold_bn and not any(
        isinstance(m, torch.nn.BatchNorm2d) for m in folded.model.modules())
    for a, b in zip(folded.enhance_batch(wavs), plain.enhance_batch(wavs)):
        assert a.shape == b.shape and float(np.abs(a - b).max()) < 2e-4


@pytest.mark.parametrize("attn_dropout", [0.0, 0.1], ids=["k2", "explicit_weights"])
def test_remat_gradients_equal_no_remat_on_cuda(attn_dropout, dev):
    """A train step with dropout and drop-path 0.1 gives the same gradients
    with ``remat`` as without, from the same seed (the recompute replays the
    CUDA generator's draws). cuDNN is held deterministic for the comparison,
    but the bilinear resize's backward adds with atomics, so two runs of
    the same step differ at rounding level: each leaf's gradient with remat
    is held within 1e-5 of its largest, or within 10 times the largest such
    difference between two runs without remat (other dropout masks would
    put it off by the gradient's own size). With K2 on the path its forward
    runs twice a block under remat (the recompute), its backward once."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.augmentation import (
        SpecAugmentConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.losses import (
        LossConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
        make_step_fns,
    )

    n = 63 * 128
    rng = np.random.default_rng(1)
    lengths = np.array([n, 6000, 3000], np.int32)
    noisy = np.zeros((3, n), np.float32)
    clean = np.zeros((3, n), np.float32)
    for i, m in enumerate(lengths):
        clean[i, :m] = 0.3 * np.sin(np.arange(m) * 0.04 * (i + 1))
        noisy[i, :m] = clean[i, :m] + 0.1 * rng.standard_normal(m)
    batch = {"noisy_audio": torch.from_numpy(noisy).to(dev),
             "clean_audio": torch.from_numpy(clean).to(dev),
             "length": torch.from_numpy(lengths).to(dev),
             "valid": torch.ones(3, dtype=torch.bool, device=dev)}
    kw = dict(embed_dim=64, num_heads=4, num_layers=2, mlp_ratio=2.0,
              encoder_channels=(16, 32, 64), decoder_channels=(32, 16, 8, 1), dropout=0.1,
              attn_dropout=attn_dropout, drop_path_rate=0.1)
    state = init_weights(HybridViT(**kw), torch.Generator().manual_seed(0)).state_dict()
    grads, launches = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for key, remat in (("a", False), ("b", False), (True, True)):
            model = HybridViT(**kw, remat=remat)
            model.load_state_dict(state)
            model.to(dev)
            cap = _Capture(list(model.parameters()))
            step, _ = make_step_fns(model, cap, LossConfig(), STFTConfig(), SpecAugmentConfig(),
                                    augment=False, use_attention_mask=True)
            torch.manual_seed(5)
            kernels.reset_launch_counts()
            step(batch)
            torch.cuda.synchronize()
            launches[remat] = {k: r.launches for k, r in kernels.KERNELS.items()}
            grads[key] = cap.grads
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def rel(x, y):
        return max(float((a - b).abs().max()) / float(a.abs().max()) for a, b in zip(x, y))

    assert rel(grads["a"], grads[True]) <= max(1e-5, 10 * rel(grads["a"], grads["b"]))
    k2 = 2 if attn_dropout == 0 else 0
    assert launches[False]["attention_fwd"] == k2 and launches[True]["attention_fwd"] == 2 * k2
    assert launches[False]["attention_bwd"] == launches[True]["attention_bwd"] == k2


def test_linear_attention_cuda_matches_cpu(dev, gen):
    """A small model with ``attention_type="linear"`` (no K2: its einsums are
    cuBLAS matmuls) gives the cpu's output on cuda within the model-output
    tolerance, 1e-4."""
    kw = dict(embed_dim=64, num_heads=4, num_layers=2, mlp_ratio=2.0,
              encoder_channels=(16, 32, 64), decoder_channels=(32, 16, 8, 1),
              attention_type="linear")
    model = init_weights(HybridViT(**kw), gen).eval()
    x = torch.rand(2, 257, 64, 1, generator=gen)
    with torch.no_grad():
        ref = model(x)
        kernels.reset_launch_counts()
        got = model.to(dev)(x.to(dev)).cpu()
    assert kernels.KERNELS["attention_fwd"].launches == 0
    assert float((got - ref).abs().max()) <= 1e-4


def test_mesh_on_cuda_tensors_over_gloo(dev, tmp_path):
    """A 2 x 2 mesh (data x model) of gloo processes on this card: synced
    BatchNorm, the tensor-parallel Functions around K2 on 2 of 4 heads, and
    the gradient all-reduce, on CUDA tensors; against the same step on one
    device: eval-mode output 2e-5, loss components and BatchNorm statistics
    1e-5, each gradient within 3e-2 of its leaf's largest in the transformer
    block and 5e-2 elsewhere (``chip_smoke.py``'s cuda-vs-cpu step limits:
    cuDNN picks its algorithms by batch size)."""
    from torch_mesh_worker import Capture, run_job

    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.augmentation import (
        SpecAugmentConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.losses import (
        LossConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
        make_step_fns,
    )

    rng = np.random.default_rng(0)
    model = init_weights(HybridViT(**SMALL), torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    length = 63 * 128
    clean = (0.3 * np.sin(np.arange(length) * 0.04) * np.ones((4, 1))).astype(np.float32)
    noisy = (clean + 0.1 * rng.standard_normal((4, length))).astype(np.float32)
    batch = {"noisy_audio": noisy, "clean_audio": clean,
             "length": np.array([length, 6000, 5000, length], np.int32),
             "valid": np.array([True, True, True, False])}
    spec = rng.random((2, 257, 64, 1)).astype(np.float32)
    loss, step_kw = dict(log_l1_weight=0.05), dict(use_attention_mask=True)
    case = {"kind": "step", "model": SMALL, "state": state, "loss": loss, "step": step_kw,
            "batch": batch, "tensor_parallel": True, "spec": spec, "device": "cuda"}
    ranks = run_job({"cases": [case], "device": "cuda"}, 2, 2, tmp_path)

    model.to(dev)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(spec).to(dev)).cpu()
    cap = Capture(list(model.parameters()))
    step, _ = make_step_fns(model, cap, LossConfig(**loss), STFTConfig(), SpecAugmentConfig(),
                            augment=False, **step_kw)
    metrics = step({k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    grads = {n: g.cpu() for (n, _), g in zip(model.named_parameters(), cap.grads)}
    stats = {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}
    for (r,) in ranks:
        assert float((r["forward"] - want).abs().max()) <= 2e-5
        for k, v in metrics.items():
            assert abs(r["metrics"][k] - float(v)) <= 1e-5 * max(1.0, abs(float(v))), k
        for n, g in grads.items():
            tol = 3e-2 if n.startswith("transformer.blocks.") else 5e-2
            assert float((r["grads"][n] - g).abs().max()) <= tol * float(g.abs().max()), n
        for k, v in stats.items():
            assert float((r["stats"][k] - v).abs().max()) <= 1e-5, k


def test_mesh_enhancer_on_two_replicas_of_one_card(dev):
    """``AudioEnhancer`` with ``mesh`` over [cuda:0, cuda:0] (two replicas,
    each on its own stream) against one device: waveforms within 2e-4, rows
    in order, an odd batch (a pad row)."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.parallel import (
        make_mesh,
    )

    model = init_weights(HybridViT(**SMALL), torch.Generator().manual_seed(1))
    cfg = {"model": {"output_mode": "mask"}}
    one = AudioEnhancer(model, cfg, device=dev, mask_padding=True)
    two = AudioEnhancer(init_weights(HybridViT(**SMALL), torch.Generator().manual_seed(1)), cfg,
                        device="cuda", mask_padding=True,
                        mesh=make_mesh(2, 1, [torch.device("cuda", 0)] * 2))
    assert [d for d, _, s in two.replicas] == [torch.device("cuda", 0)] * 2
    rng = np.random.default_rng(2)
    wavs = [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in (16000, 9000, 23000)]
    for a, b in zip(two.enhance_batch(wavs), one.enhance_batch(wavs)):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert float(np.abs(a - b).max()) <= 2e-4


def test_stft_methods_launch_the_kernels(dev, gen):
    """``method="auto"`` launches K1 or K3 once and equals ``"matmul"``
    within their limits (STFT 2e-4, iSTFT 2e-5); ``"fft"`` within 2e-3."""
    import importlib

    S = importlib.import_module(
        "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft")
    x = torch.randn(3, 16000, generator=gen).to(dev)
    re, im = S.stft(x)
    mag, phase = S.magphase(re, im)
    for name, run, want, tol in (
            ("stft_mag", lambda m: S.stft(x, method=m), (re, im), 2e-4),
            ("istft_polar", lambda m: (S.reconstruct(mag, phase, length=16000, method=m),),
             (S.reconstruct(mag, phase, length=16000),), 2e-5)):
        before = kernels.KERNELS[name].launches
        got = run("auto")
        assert kernels.KERNELS[name].launches == before + 1
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= tol
        for g, w in zip(run("fft"), want):
            assert float((g - w).abs().max()) <= 2e-3
    with pytest.raises(RuntimeError, match="no backward"):
        S.stft(x.clone().requires_grad_(), method="auto")


def test_griffin_lim_rounds_are_k3_then_k1(dev, gen):
    """n_iter rounds launch K1 n_iter and K3 n_iter + 1 times; after one
    round the output is within K1's and K3's composed limits of the plain
    (re, im) rounds from the same phase (chip_smoke.py's TOL_GL_ROUND1)."""
    import importlib

    S = importlib.import_module(
        "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft")
    mag = cuda_stft.stft_mag(torch.randn(2, 12160, generator=gen).to(dev))[2]
    phase = (torch.rand(mag.shape, generator=gen) * 2 * np.pi).to(dev)
    k1, k3 = kernels.KERNELS["stft_mag"].launches, kernels.KERNELS["istft_polar"].launches
    y = S.griffin_lim(mag, n_iter=4, phase=phase)
    assert kernels.KERNELS["stft_mag"].launches == k1 + 4
    assert kernels.KERNELS["istft_polar"].launches == k3 + 5
    assert y.shape == (2, 12160) and bool(torch.isfinite(y).all())
    one = S.griffin_lim(mag, n_iter=1, phase=phase)
    plain = S.griffin_lim_plain(mag, phase, n_iter=1)
    assert float((one - plain).abs().max()) <= 2e-5 + 4 / 3 * (2e-3 + 256 * 2e-5)


@pytest.mark.parametrize("name", ["stft_mag", "attention_fwd", "attention_bwd", "istft_polar"])
def test_opcheck_on_cuda(name, dev, gen):
    """Each op's CUDA impl against its fake impl and registrations, on the
    card (``tests/test_torch_custom_ops.py`` runs the same on the CPU)."""
    from torch.library import opcheck

    cfg = STFTConfig()
    args = (cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.window, cfg.center, cfg.pad_mode)
    q, k, v, dout = (torch.randn(2, 2, 37, 64, generator=gen).to(dev) for _ in range(4))
    mask = (torch.rand(2, 37, generator=gen) > 0.3).to(dev)
    if name == "stft_mag":
        opcheck(cuda_stft.stft_mag_op, (torch.randn(2, 4000, generator=gen).to(dev), *args))
    elif name == "istft_polar":
        mag = torch.rand(2, 257, 30, generator=gen).to(dev)
        opcheck(cuda_stft.istft_polar_op, (mag, mag * 3.0, *args, 3800))
    elif name == "attention_fwd":
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        opcheck(cuda_attention.attention_fwd_op, (*leaves, mask, 0.125, True))
    else:
        out, lse = cuda_attention.attention_fwd_op(q, k, v, mask, 0.125, True)
        opcheck(cuda_attention.attention_bwd_op, (q, k, v, out, lse, dout, mask, 0.125))


@pytest.mark.parametrize("io_dtype", ["float32", "int16"])
def test_export_program_on_cuda_holds_the_kernel_ops(io_dtype, dev, tmp_path):
    """The enhancer core exported on the card: one sevit op a kernel launch,
    none of the plain versions; the loaded program launches each kernel as
    the graph says and equals the eager core (one process: the same calls)."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
        EnhancerCore,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
        export_program, load_program,
    )

    model = init_weights(HybridViT(**SMALL), torch.Generator().manual_seed(0))
    enhancer = AudioEnhancer(model, {"model": {"output_mode": "mask"}}, device=dev,
                             io_dtype=io_dtype, mask_padding=True, buckets=(64,))
    rng = np.random.default_rng(1)
    wav = (0.3 * rng.standard_normal((3, 63 * 128))).astype(np.float32)
    x = torch.from_numpy((wav * 32767).astype(np.int16) if io_dtype == "int16" else wav).to(dev)
    lengths = torch.tensor([63 * 128, 5000, 3000], dtype=torch.int32, device=dev)
    core = EnhancerCore(enhancer)
    program = load_program(export_program(tmp_path / "core.pt2", core, (x, lengths)))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    calls = kernels.op_calls(program)
    assert calls == {"stft_mag": 1, "attention_fwd": 2, "istft_polar": 1}
    assert not [t for t in targets if "softmax" in t or "matmul" in t or t.startswith("aten.cos")]
    with torch.inference_mode():
        want = core(x, lengths)
        kernels.reset_launch_counts()
        got = program.module()(x, lengths)
    torch.cuda.synchronize()
    assert kernels.launched() == calls
    assert got.dtype == want.dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= (1.0 if io_dtype == "int16" else 1e-6)


def test_flop_count_and_plain_attention_on_cuda(dev, gen):
    """PyTorch's count of a forward on the card equals the CPU's (the same
    shapes through the ``sevit`` ops' formulas) and the analytic count less
    the bilinear resizes; the tools' ``--attention xla`` takes attention's
    plain version on CUDA tensors: no K2 launch, output within 2e-5 of K2's."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools import (
        bench_infer, flops,
    )

    model = init_weights(HybridViT(**SMALL), gen).eval()
    x = torch.rand(2, 257, 64, 1, generator=gen)
    with torch.no_grad():
        cpu = flops.torch_program_flops(model, x)
        model = model.to(dev)
        on_card = flops.torch_program_flops(model, x.to(dev))
        spec = flops.spec_from_model(model)
        assert on_card == cpu == pytest.approx(
            flops.forward_flops(spec, 2, 257, 64)["total"] - flops.bilinear_flops(spec, 2, 257, 64),
            rel=1e-9)
        k2 = model(x.to(dev))
        kernels.reset_launch_counts()
        plain = bench_infer.use_attention(model, "xla")(x.to(dev))
        torch.cuda.synchronize()
    assert kernels.KERNELS["attention_fwd"].launches == 0
    assert float((plain - k2).abs().max()) <= 2e-5


def test_bench_prints_one_json_line_on_cuda(dev, capsys):
    """The port's ``bench.py`` at a small batch: one JSON line naming the
    card, every rate measured, ``mfu_pct`` in (0, 100], K1 1, K2 6 and K3 1
    launches a device step."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools import bench

    assert bench.main(["--batch", "2", "--seconds", "0.5", "--iters", "2",
                       "--device-iters", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["device"] == "cuda" and line["name"] == torch.cuda.get_device_name()
    assert line["value"] > 0 and line["device_audio_s_per_s"] > 0
    assert line["mfu_pct"] is None or 0 < line["mfu_pct"] <= 100
    assert {k: c for k, c in line["launches_per_step"].items() if c} == {
        "stft_mag": 1.0, "attention_fwd": 6.0, "istft_polar": 1.0}


# (n_fft, hop, win, pad_mode): the geometries K1 and K3 do not all take
GEOMETRIES = cuda_stft.GEOMETRIES


@pytest.mark.parametrize("geom", GEOMETRIES, ids=[f"{n}-{h}-{w}-{p}" for n, h, w, p in GEOMETRIES])
def test_each_geometry_runs_its_route(geom, dev, gen):
    """The kernel ``route`` names runs, once, within K1's 2e-3 (STFT, as
    chip_smoke.py phase 16; the plain version's fp32 sums of up to 4096
    products) and K3's 2e-5 (iSTFT at the implied length) of the plain
    version; the other kernels do not run. Rows: several frame tiles, the
    shortest signal one reflection pads, and one of 100 samples, which the
    wrapper pads first as ``jnp.pad`` does."""
    n_fft, hop, win, pad_mode = geom
    cfg = STFTConfig(n_fft=n_fft, hop_length=hop, win_length=win, pad_mode=pad_mode)
    for shape in ((3, 20000), (2, n_fft // 2 + 1), (2, 100)):
        x = torch.randn(shape, generator=gen).to(dev)
        kernels.reset_launch_counts()
        out = cuda_stft.stft_mag(x, cfg)
        torch.cuda.synchronize()
        assert kernels.launched() == {cuda_stft.route(cfg, inverse=False)[0]: 1}
        for o, r in zip(out, cuda_stft.stft_mag_plain(x, cfg)):
            assert o.shape == r.shape and float((o - r).abs().max()) < 2e-3
    n = cfg.num_frames(20000)
    mag = torch.rand(3, cfg.num_bins, n, generator=gen).to(dev)
    ph = (torch.rand(3, cfg.num_bins, n, generator=gen) * 2 * np.pi - np.pi).to(dev)
    kernels.reset_launch_counts()
    y = cuda_stft.istft_polar(mag, ph, cfg, length=(n - 1) * hop)
    torch.cuda.synchronize()
    assert kernels.launched() == {cuda_stft.route(cfg, inverse=True)[0]: 1}
    r = cuda_stft.istft_polar_plain(mag, ph, cfg, length=(n - 1) * hop)
    assert y.shape == r.shape and float((y - r).abs().max()) < 2e-5


@pytest.mark.parametrize("d", [24, 48, 80, 96, 112, 192, 256])
def test_attention_at_padded_head_dims(d, dev, gen):
    """A head dim between instances runs the next one, zero-padded (above
    128 the sliced instance): the forward within 2e-5 of the plain version,
    the backward within 1e-4 of each gradient's largest, under a mask with
    a fully masked row."""
    q, k, v, dout = (torch.randn(2, 3, 200, d, generator=gen).to(dev) for _ in range(4))
    mask = torch.rand(2, 200, generator=gen) > 0.3
    mask[1] = False
    mask = mask.to(dev)
    scale = d**-0.5
    kernels.reset_launch_counts()
    out = cuda_attention.attention(q, k, v, scale=scale, mask=mask)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(cuda_attention.attention(*leaves, scale=scale, mask=mask),
                                leaves, dout)
    torch.cuda.synchronize()
    assert kernels.KERNELS["attention_fwd"].launches == 2
    assert kernels.KERNELS["attention_bwd"].launches == 1
    assert out.shape == q.shape
    ref = cuda_attention.attention_plain(q, k, v, scale=scale, mask=mask)
    assert float((out - ref).abs().max()) < 2e-5
    for g, r in zip(grads, cuda_attention.attention_bwd_plain(q, k, v, dout, scale=scale,
                                                              mask=mask)):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-4 * max(float(r.abs().max()), 1.0)


def test_enhancer_at_400_100_cuda_matches_cpu(dev, gen):
    """A small mask-head model at n_fft 400 / hop 100 behind the enhancer:
    K1, K2 and K3 run (n_fft / 2 = 200 on the mixed radices), the waveforms
    agree within 2e-4."""
    model = init_weights(HybridViT(embed_dim=64, num_heads=4, num_layers=2, mlp_ratio=2.0,
                                   encoder_channels=(16, 32, 64), decoder_channels=(32, 16, 8, 1),
                                   pos_embed_type="factored_2d", head_type="fullres_mask",
                                   head_channels=8), gen)
    rng = np.random.default_rng(0)
    wavs = [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in (16000, 9000)]
    cfg = {"audio": {"n_fft": 400, "hop_length": 100, "win_length": 400},
           "model": {"output_mode": "mask"}}
    ref = AudioEnhancer(model, cfg, device="cpu", mask_padding=True).enhance_batch(wavs)
    kernels.reset_launch_counts()
    out = AudioEnhancer(model, cfg, device=dev, mask_padding=True).enhance_batch(wavs)
    torch.cuda.synchronize()
    assert kernels.launched() == {"stft_mag": 1, "attention_fwd": 2, "istft_polar": 1}
    for a, b in zip(out, ref):
        assert a.shape == b.shape and float(np.abs(a - b).max()) < 2e-4


@pytest.mark.parametrize("n", [101, 401, 1001])
@pytest.mark.parametrize("mask_kind", ["none", "prefix", "gappy"])
def test_relpos_kernel_matches_plain(n, mask_kind, dev, gen):
    """K2r at D = 16 against its plain version (the published einsums) in
    float64, past the clamp (P = 512 at N = 1001, P = 20 beside it). Masks:
    each row a prefix (row 0 keeps none and averages V, the last keeps
    all), or keys kept at random; the offsets stay the keys' positions."""
    g, h, d = 3, 4, 16
    q, k, v = (torch.randn(g, h, n, d, generator=gen).to(dev) for _ in range(3))
    mask = None
    if mask_kind == "prefix":
        lens = torch.tensor([0, n // 3, n])
        mask = (torch.arange(n)[None, :] < lens[:, None]).to(dev)
    elif mask_kind == "gappy":
        mask = (torch.rand(g, n, generator=gen) < 0.3).to(dev)
    for p in (512, 20):
        e = torch.randn(2 * p + 1, d, generator=gen).to(dev)
        before = kernels.KERNELS["attention_relpos"].launches
        with torch.no_grad():
            o = cuda_attention.attention_relpos(q, k, v, e, p, scale=0.25, mask=mask)
        assert kernels.KERNELS["attention_relpos"].launches == before + 1
        r = cuda_attention.attention_relpos_plain(q.double(), k.double(), v.double(), e.double(),
                                                  p, scale=0.25, mask=mask)
        assert float((o.double() - r).abs().max()) < 5e-5


def test_relpos_kernel_resources(dev):
    """Three blocks an SM at the time attention's 1,024 keys, no spill."""
    info = cuda_attention.relpos_kernel_info(16, 1024)
    assert info["blocks_per_sm"] >= 3 and info["local_bytes"] == 0, info


def test_cmgan_enhancer_cuda_matches_cpu_and_launches_k1_k2r_k3(dev):
    """CMGAN at its published widths (the benchmark's seeded weights) on
    two clips: cuda against cpu within 2e-4 (fp32 through ~60 layers, as the
    HybridViT's waveforms); a batch launches K1 once, K2r 8 times (two
    conformers a block, four blocks), ``add_layer_norm`` 40 times (five
    boundaries a conformer), ``instance_norm`` 16 times (the masked
    InstanceNorms with their PReLUs), K3 once and nothing else."""
    from portbench.traffic import offline_cmgan

    config = json.loads(open("portbench/configs/cmgan.json").read())
    port = {"model": config["model"], "audio": config["audio"]}
    rng = np.random.default_rng(3)
    wavs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (16000, 23000)]
    outs = {}
    cpu_model, _ = offline_cmgan.build_model(config, 5, "cpu")  # one draw for both devices
    for device in ("cpu", dev):
        model = copy.deepcopy(cpu_model).to(device)
        kernels.reset_launch_counts()
        outs[str(device)] = AudioEnhancer(model, port, device=device, buckets=(256, 512),
                                          mask_padding=True).enhance_batch(wavs)
    assert kernels.launched() == {"stft_mag": 1, "attention_relpos": 8, "add_layer_norm": 40,
                                  "instance_norm": 16, "istft_polar": 1}
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert a.shape == b.shape and float(np.abs(a - b).max()) < 2e-4


TOL_ADD_NORM = 1e-5


def _add_norm_inputs(g, n, gen, dev):
    x, delta, residual = (torch.randn(g, n, 64, generator=gen).to(dev) for _ in range(3))
    w = (1 + 0.1 * torch.randn(64, generator=gen)).to(dev)
    b = (0.1 * torch.randn(64, generator=gen)).to(dev)
    return x, delta, residual, w, b


def _check_add_norm(x, delta, residual, w, b, *, layout, epilogue):
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_layer_norm as ln,
    )

    cf = layout == "channels_first"
    d = delta.transpose(1, 2).contiguous() if cf else delta
    r = residual if epilogue else None
    before = kernels.KERNELS["add_layer_norm"].launches
    with torch.no_grad():
        s, h = ln.add_layer_norm(x, d, w, b, 1e-5, scale=0.5, channels_first=cf, residual=r,
                                 keep_sum=True)
    torch.cuda.synchronize()
    assert kernels.KERNELS["add_layer_norm"].launches == before + 1
    want_s, want_h = ln.add_layer_norm_plain(x, d, w, b, 1e-5, scale=0.5, channels_first=cf,
                                             residual=r)
    assert torch.equal(s, want_s)
    assert float((h - want_h).abs().max()) <= TOL_ADD_NORM
    del want_s, want_h
    _, want64 = ln.add_layer_norm_plain(
        x.double(), d.double(), w.double(), b.double(), 1e-5, scale=0.5, channels_first=cf,
        residual=None if r is None else r.double())
    assert float((h.double() - want64).abs().max()) <= TOL_ADD_NORM


@pytest.mark.parametrize("g,n", [(1, 1), (2, 1), (1, 3), (1, 33), (3, 101)])
@pytest.mark.parametrize("layout", ["rows", "channels_first"])
@pytest.mark.parametrize("epilogue", [False, True], ids=["no_residual", "residual"])
def test_add_layer_norm_kernel_matches_plain(g, n, layout, epilogue, dev, gen):
    """The kernel against its plain version at 1, 2, 3, 33 and 303 rows,
    delta as rows or channel-first (N = 33 and 101: not a multiple of the
    32-position tile), the epilogue on and off; the no-delta launch too."""
    x, delta, residual, w, b = _add_norm_inputs(g, n, gen, dev)
    _check_add_norm(x, delta, residual, w, b, layout=layout, epilogue=epilogue)
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_layer_norm as ln,
    )

    with torch.no_grad():
        s, h = ln.add_layer_norm(x, None, w, b, 1e-5)
    assert s is None
    assert float((h - torch.nn.functional.layer_norm(x, (64,), w, b, 1e-5)).abs().max()) \
        <= TOL_ADD_NORM


@pytest.mark.parametrize("layout", ["rows", "channels_first"])
def test_add_layer_norm_kernel_at_the_cells_largest_activation(layout, dev):
    """[32 x 101 x 1638, 64]: the time conformer's rows at the 1638-frame
    bucket, 339M floats a tensor (offsets past 2^31 bytes), with the
    epilogue."""
    gen = torch.Generator(device=dev).manual_seed(7)
    g, n = 32 * 101, 1638
    x, delta, residual = (torch.randn(g, n, 64, generator=gen, device=dev) for _ in range(3))
    w = 1 + 0.1 * torch.randn(64, generator=gen, device=dev)
    b = 0.1 * torch.randn(64, generator=gen, device=dev)
    _check_add_norm(x, delta, residual, w, b, layout=layout, epilogue=True)
    del x, delta, residual
    torch.cuda.empty_cache()


def test_add_layer_norm_kernel_refuses_a_gradient(dev, gen):
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_layer_norm as ln,
    )

    x, delta, _, w, b = _add_norm_inputs(2, 5, gen, dev)
    before = kernels.KERNELS["add_layer_norm"].launches
    with pytest.raises(RuntimeError, match="forward only"):
        ln.add_layer_norm(x, delta.requires_grad_(), w, b, 1e-5)
    assert kernels.KERNELS["add_layer_norm"].launches == before


TOL_INSTANCE_NORM = 1e-5


def _instance_norm_inputs(shape, gen, dev):
    """``x`` of mean 0.5 and spread 1.5 (a centring that matters), the
    affine parameters and slopes about the model's."""
    b, c = shape[:2]
    x = (0.5 + 1.5 * torch.randn(shape, generator=gen)).to(dev)
    w = (1 + 0.1 * torch.randn(c, generator=gen)).to(dev)
    bias = (0.1 * torch.randn(c, generator=gen)).to(dev)
    slope = (0.25 + 0.1 * torch.randn(c, generator=gen)).to(dev)
    return x, w, bias, slope


def _check_instance_norm(x, n_valid, w, bias, slope):
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_instance_norm as cin,
    )

    before = kernels.KERNELS["instance_norm"].launches
    with torch.no_grad():
        y = cin.instance_norm_prelu(x, n_valid, w, bias, slope, 1e-5)
        again = cin.instance_norm_prelu(x, n_valid, w, bias, slope, 1e-5)
    torch.cuda.synchronize()
    assert kernels.KERNELS["instance_norm"].launches == before + 2
    assert torch.equal(y, again)  # no atomics in the sums' order
    assert y.stride() == x.stride()
    want = cin.instance_norm_prelu_plain(x, n_valid, w, bias, slope, 1e-5)
    assert float((y - want).abs().max()) <= TOL_INSTANCE_NORM
    del want
    want64 = cin.instance_norm_prelu_plain(x.double(), n_valid, w.double(), bias.double(),
                                           slope.double(), 1e-5)
    assert float((y.double() - want64).abs().max()) <= TOL_INSTANCE_NORM
    return y


@pytest.mark.parametrize("shape,counts,layout", [
    ((3, 64, 17, 201), [17, 1, 9], "nchw"),    # odd T x F: planes 4-byte aligned only
    ((2, 64, 21, 101), None, "nchw"),          # every frame, odd T x F
    ((2, 64, 33, 202), [33, 40], "nchw"),      # planes 8-byte aligned; a count past T
    ((4, 1, 819, 201), [819, 1, 400, 700], "nchw"),  # one channel: planes cut into chunks
    ((1, 3, 1, 3), [1], "nchw"),               # a plane shorter than a float4
    ((2, 64, 5, 4), [0, 5], "nchw"),           # a row with no valid frame: NaN, as plain
    ((3, 64, 17, 101), [17, 1, 9], "nhwc"),    # the decoders' DenseNets' layout
    ((2, 64, 819, 101), None, "nhwc"),         # every frame, rows cut into chunks
    ((2, 4, 7, 5), [3, 7], "nhwc"),            # the fewest channels it takes
    ((2, 64, 5, 4), [0, 5], "nhwc"),
], ids=["ragged_odd", "unmasked", "ragged_202", "one_channel", "tiny", "empty_row",
        "cl_ragged", "cl_unmasked", "cl_four_channels", "cl_empty_row"])
def test_instance_norm_kernel_matches_plain(shape, counts, layout, dev, gen):
    """The kernels against their plain version in fp32 and in float64, a
    second call the same bits, the output in x's layout."""
    x, w, bias, slope = _instance_norm_inputs(shape, gen, dev)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
        assert not x.is_contiguous()
    n_valid = None if counts is None else torch.tensor(counts, dtype=torch.int32, device=dev)
    if counts is not None and 0 in counts:
        from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
            cuda_instance_norm as cin,
        )

        with torch.no_grad():
            y = cin.instance_norm_prelu(x, n_valid, w, bias, slope, 1e-5)
        want = cin.instance_norm_prelu_plain(x, n_valid, w, bias, slope, 1e-5)
        assert torch.isnan(y[0]).all() and torch.isnan(want[0]).all()
        assert float((y[1] - want[1]).abs().max()) <= TOL_INSTANCE_NORM
        return
    _check_instance_norm(x, n_valid, w, bias, slope)


def test_instance_norm_kernel_with_one_slope_and_padded_frames(dev, gen):
    """One slope for every channel; padded frames normalised by the valid
    frames' statistics, which differ from the whole plane's (the padding
    holds other values)."""
    x, w, bias, _ = _instance_norm_inputs((2, 64, 40, 201), gen, dev)
    x[:, :, 25:] = 4.0 + x[:, :, 25:]
    slope = torch.tensor([0.2], device=dev)
    n_valid = torch.tensor([25, 40], dtype=torch.int32, device=dev)
    y = _check_instance_norm(x, n_valid, w, bias, slope)

    def by_stats_of(frames):
        ref = x[0, :, :frames].double()
        mean = ref.mean(dim=(1, 2))[:, None, None]
        var = ref.var(dim=(1, 2), unbiased=False)[:, None, None]
        h = (x[0].double() - mean) / torch.sqrt(var + 1e-5) * w.double()[:, None, None] \
            + bias.double()[:, None, None]
        return torch.where(h > 0, h, 0.2 * h)[:, 25:]

    padded = y[0, :, 25:].double()
    assert float((padded - by_stats_of(25)).abs().max()) <= TOL_INSTANCE_NORM
    assert float((padded - by_stats_of(40)).abs().max()) > 0.5


def test_instance_norm_kernel_at_the_cells_largest_activation(dev):
    """[32, 64, 1638, 202]: the complex decoder's norm at the 1638-frame
    bucket, 2.7 GB a tensor (offsets past 2^31 bytes), ragged counts."""
    gen = torch.Generator(device=dev).manual_seed(9)
    shape = (32, 64, 1638, 202)
    x = 0.5 + 1.5 * torch.randn(shape, generator=gen, device=dev)
    w = 1 + 0.1 * torch.randn(64, generator=gen, device=dev)
    bias = 0.1 * torch.randn(64, generator=gen, device=dev)
    slope = 0.25 + 0.1 * torch.randn(64, generator=gen, device=dev)
    n_valid = torch.randint(1000, 1639, (32,), generator=gen, device=dev, dtype=torch.int32)
    _check_instance_norm(x, n_valid, w, bias, slope)
    del x
    torch.cuda.empty_cache()


def test_instance_norm_kernel_refuses_a_gradient(dev, gen):
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_instance_norm as cin,
    )

    x, w, bias, slope = _instance_norm_inputs((2, 64, 5, 7), gen, dev)
    before = kernels.KERNELS["instance_norm"].launches
    with pytest.raises(RuntimeError, match="forward only"):
        cin.instance_norm_prelu(x, None, w.requires_grad_(), bias, slope, 1e-5)
    assert kernels.KERNELS["instance_norm"].launches == before



# --- SEMamba's selective scan ---------------------------------------------------

# the kernel against its plain version, relative to the output's largest
# magnitude: fp32 through up to 819 steps of a recurrence whose slowest decays
# keep ~1,000 steps, exp2f against exp and the sums in another order
TOL_SCAN = 1e-4


def _scan_args(gen, seqs, steps, dev, d=256, n=16):
    """The scan's arguments as SEMamba hands them over (z, B and C strided
    views of the in_proj and x_proj rows) at Mamba's published A_log, D and
    Delta bias."""
    u = torch.randn(seqs, steps, d, generator=gen, device=dev)
    delta = 0.5 * torch.randn(seqs, steps, d, generator=gen, device=dev)
    xz = torch.randn(seqs, steps, 2 * d, generator=gen, device=dev)
    x_dbl = torch.randn(seqs, steps, 4 + 2 * n, generator=gen, device=dev)
    a_log = torch.log(torch.arange(1, n + 1, device=dev, dtype=torch.float32)).repeat(d, 1)
    dt = torch.exp(torch.rand(d, generator=gen, device=dev) * np.log(100.0) + np.log(1e-3))
    bias = dt + torch.log(-torch.expm1(-dt))
    return (u, delta, xz[..., d:], x_dbl[..., 4:4 + n], x_dbl[..., 4 + n:], a_log,
            torch.ones(d, device=dev), bias)


def _check_scan(args, n_valid, reverse, double=True):
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_scan,
    )

    before = kernels.KERNELS["selective_scan"].launches
    with torch.no_grad():
        y = cuda_scan.selective_scan(*args, n_valid=n_valid, reverse=reverse)
    torch.cuda.synchronize()
    assert kernels.KERNELS["selective_scan"].launches == before + 1
    want = cuda_scan.selective_scan_plain(*(t.double() if double else t for t in args),
                                          n_valid, reverse)
    assert float((y.double() - want).abs().max()) <= TOL_SCAN * float(want.abs().max())
    if n_valid is not None:  # the padded steps' outputs are 0
        steps = torch.arange(y.shape[1], device=y.device)[None, :]
        assert not bool(y[steps >= n_valid[:, None].long()].any())
    return y


@pytest.mark.parametrize("d", [32, 64, 256, 40])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("lengths", ["all", "ragged"])
def test_selective_scan_kernel_matches_plain(d, reverse, lengths, dev):
    """The kernel against its plain version in float64, channels of one
    block, two, and not a multiple of 32, every step and ragged lengths (a
    sequence of none, of one step, one past the end)."""
    gen = torch.Generator(device=dev).manual_seed(d)
    args = _scan_args(gen, 5, 70, dev, d)
    n_valid = None if lengths == "all" else torch.tensor([70, 33, 1, 0, 99], dtype=torch.int32,
                                                         device=dev)
    _check_scan(args, n_valid, reverse)


def test_selective_scan_kernel_packs_unaligned_b_and_c(dev):
    """B and C in rows of 2N + 1 floats (not float4-aligned): the wrapper
    packs them, and the output is the same as from aligned rows."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_scan,
    )

    gen = torch.Generator(device=dev).manual_seed(11)
    args = list(_scan_args(gen, 3, 50, dev))
    bc = torch.cat([args[3], args[4], args[4][..., :1]], dim=-1)
    odd = args[:3] + [bc[..., :16], bc[..., 16:32]] + args[5:]
    with torch.no_grad():
        a = cuda_scan.selective_scan(*args, reverse=True)
        b = cuda_scan.selective_scan(*odd, reverse=True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("axis", ["time", "time_reverse", "freq"])
def test_selective_scan_kernel_at_the_cells_shapes(axis, dev):
    """A 32-clip batch in the 819-frame bucket: the time scans [3,200, 819,
    256] under the batch's lengths (both directions) and the frequency scans
    [26,208, 100, 256] over its valid frames, against the plain version in
    fp32."""
    gen = torch.Generator(device=dev).manual_seed(12)
    kept = torch.randint(640, 820, (32,), generator=gen, device=dev, dtype=torch.int32)
    if axis == "freq":
        frames = torch.arange(819, device=dev)[None, :] < kept[:, None]
        args, n_valid = _scan_args(gen, 32 * 819, 100, dev), (frames.int() * 100).view(-1)
    else:
        args, n_valid = _scan_args(gen, 32 * 100, 819, dev), kept.repeat_interleave(100)
    _check_scan(args, n_valid, axis == "time_reverse", double=False)
    del args
    torch.cuda.empty_cache()


def test_semamba_enhancer_cuda_matches_cpu_and_launches_k1_scan_k3(dev):
    """SEMamba at its published widths (the benchmark's seeded weights) on
    two clips: cuda against cpu within 2e-4 (fp32 through ~50 layers, as
    CMGAN's waveforms); a batch launches K1 once, ``instance_norm`` 16 times,
    ``selective_scan`` and ``conv1d_silu`` 16 times each (4 blocks x time and
    frequency x both directions), K3 once and nothing else."""
    from portbench.traffic import offline_semamba

    config = json.loads(open("portbench/configs/semamba.json").read())
    port = {"model": config["model"], "audio": config["audio"]}
    rng = np.random.default_rng(3)
    wavs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (16000, 23000)]
    outs = {}
    cpu_model, _ = offline_semamba.build_model(config, 5, "cpu")  # one draw for both devices
    for device in ("cpu", dev):
        model = copy.deepcopy(cpu_model).to(device)
        kernels.reset_launch_counts()
        outs[str(device)] = AudioEnhancer(model, port, device=device, buckets=(256, 512),
                                          mask_padding=True).enhance_batch(wavs)
    assert kernels.launched() == {"stft_mag": 1, "instance_norm": 16, "selective_scan": 16,
                                  "conv1d_silu": 16, "istft_polar": 1}
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert a.shape == b.shape and float(np.abs(a - b).max()) < 2e-4


def test_selective_scan_opcheck_on_cuda(dev):
    from torch.library import opcheck

    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_scan,
    )

    gen = torch.Generator(device=dev).manual_seed(13)
    args = _scan_args(gen, 3, 9, dev, 64, 16)
    n_valid = torch.tensor([9, 4, 0], dtype=torch.int32, device=dev)
    for nv, reverse in ((None, False), (n_valid, True)):
        opcheck(cuda_scan.selective_scan_op, (*args, nv, reverse))


# --- SEMamba's depthwise conv and its SiLU -------------------------------------------

# the kernel against its plain version in float64, relative to the output's
# largest magnitude: four fp32 products summed into the bias and a SiLU
TOL_CONV = 1e-6


def _conv_args(gen, seqs, steps, dev, d=256, strided=True):
    """x as SEMamba hands it over (the first half of the in_proj rows, a
    token every 2d floats) or contiguous, the conv's weight and bias at the
    benchmark's scale."""
    xz = torch.randn(seqs, steps, 2 * d, generator=gen, device=dev)
    x = xz[..., :d] if strided else xz[..., :d].contiguous()
    w = 0.28 * torch.randn(d, 1, 4, generator=gen, device=dev)
    return x, w, 0.28 * torch.randn(d, generator=gen, device=dev)


def _check_conv(x, w, bias, reverse):
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_scan,
    )

    before = kernels.KERNELS["conv1d_silu"].launches
    with torch.no_grad():
        u = cuda_scan.conv1d_silu(x, w, bias, reverse)
    torch.cuda.synchronize()
    assert kernels.KERNELS["conv1d_silu"].launches == before + 1
    assert u.shape == x.shape and u.is_contiguous()
    want = cuda_scan.conv1d_silu_plain(x.double(), w.double(), bias.double(), reverse)
    assert float((u.double() - want).abs().max()) <= TOL_CONV * float(want.abs().max())
    return u


@pytest.mark.parametrize("shape", ["small", "d40", "contiguous", "masked", "time", "freq"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_conv1d_silu_kernel_matches_plain(shape, reverse, dev):
    """The kernel against its plain version in float64, both directions:
    x a view of the in_proj rows (float4 lanes), 40 channels (a float each),
    x contiguous, a masked batch (each row's padded tokens zero, as the model
    hands them over: the mirrored conv sees zeros past a row's end), and the
    cell's two shapes cut small: time [200, 819, 256] (13 runs of 63
    tokens), frequency [2048, 100, 256] (2 runs of 50)."""
    gen = torch.Generator(device=dev).manual_seed(21)
    seqs, steps, d, strided = {"small": (5, 70, 256, True), "d40": (3, 67, 40, True),
                               "contiguous": (5, 70, 256, False),
                               "masked": (6, 130, 256, True), "time": (200, 819, 256, True),
                               "freq": (2048, 100, 256, True)}[shape]
    x, w, bias = _conv_args(gen, seqs, steps, dev, d, strided)
    if shape == "masked":
        n_valid = torch.tensor([130, 129, 64, 3, 1, 0], device=dev)
        pad = torch.arange(steps, device=dev)[None, :] >= n_valid[:, None]
        x.masked_fill_(pad[..., None], 0.0)
    u = _check_conv(x, w, bias, reverse)
    if shape == "masked":  # a row's valid outputs are those of the row alone
        for r, n in enumerate(n_valid.tolist()[:-1]):  # the last row has no valid token
            alone = _check_conv(x[r:r + 1, :n].contiguous(), w, bias, reverse)
            assert torch.equal(u[r:r + 1, :n], alone)


def test_conv1d_silu_kernel_reads_x_in_place(dev, monkeypatch):
    """x as the first half of the in_proj rows: the kernel gets its data
    pointer and a token stride of 2 * d_inner (no copy), and gives the same
    bits as from a contiguous copy."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_scan,
    )

    gen = torch.Generator(device=dev).manual_seed(22)
    x, w, bias = _conv_args(gen, 4, 50, dev)
    calls = []
    real = kernels.launch

    def spy(name, *args):
        calls.append((name, args))
        real(name, *args)

    monkeypatch.setattr(kernels, "launch", spy)
    with torch.no_grad():
        strided = cuda_scan.conv1d_silu(x, w, bias, True)
        copied = cuda_scan.conv1d_silu(x.contiguous(), w, bias, True)
    assert [c[0] for c in calls] == ["conv1d_silu", "conv1d_silu"]
    assert calls[0][1][0] == x.data_ptr() and calls[0][1][8] == 512
    assert calls[1][1][8] == 256
    assert torch.equal(strided, copied)


def test_conv1d_silu_opcheck_on_cuda(dev):
    from torch.library import opcheck

    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_scan,
    )

    gen = torch.Generator(device=dev).manual_seed(23)
    for strided, reverse in ((True, False), (False, True)):
        opcheck(cuda_scan.conv1d_silu_op, _conv_args(gen, 3, 9, dev, 64, strided) + (reverse,))
