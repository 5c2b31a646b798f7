"""CMGAN's generator on the port: ``models/cmgan.py`` against the plain
reference ``portbench/reference/cmgan.py``, K2r's plain version against the
published einsums and its kernel's index plan in numpy, padding invariance,
the enhancer's CMGAN path, the factory and the CLIs, and the FLOP count."""

import json
import re
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import clips, cmgan_work
from portbench.reference import cmgan as reference
from portbench.traffic import offline_batches, offline_cmgan
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import (
    load_audio,
    save_wav,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
    AudioEnhancer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
    HybridViT,
    TSCNet,
    architecture,
    create_model,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
    cuda_attention,
    cuda_layer_norm,
    kernels,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools import flops
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils import tracing
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    save_model_weights,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "portbench" / "configs" / "cmgan.json").read_text())
PORT_CONFIG = {"model": CONFIG["model"], "audio": CONFIG["audio"]}
SEED = 2147483911
BUCKETS = (64, 128)  # frames at hop 100: 6,300 and 12,700 samples


@pytest.fixture(scope="module")
def drawn():
    """The published widths with the benchmark's seeded weights."""
    model, shapes = offline_cmgan.build_model(CONFIG, SEED, "cpu")
    return model, offline_cmgan.draw(shapes, SEED, "cpu"), shapes


def test_parameter_count_is_the_papers():
    """1,834,833 parameters: the paper's 1.83M."""
    model = create_model(PORT_CONFIG)
    assert sum(p.numel() for p in model.parameters()) == 1_834_833 == CONFIG["params"]


def test_model_matches_the_reference(drawn):
    """The port's TSCNet against the plain functional forward, two rows of
    different valid lengths. Tolerance 2e-5 of the output's largest value:
    fp32 sums in other orders (the masked InstanceNorms, the attention's
    softmax and sums) through ~60 layers; observed ~1e-6."""
    model, w, _ = drawn
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 2, 60, 201, generator=g)
    n_valid = torch.tensor([60, 31])
    with torch.no_grad():
        got = model(x, n_valid)
    want = reference.forward(w, x, n_valid)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (2, 1, 60, 201)
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2e-5 * scale


def _einsum_relpos(q, k, v, e, p, scale, mask):
    """The published einsums in float64, written out again."""
    q, k, v, e = (t.double() for t in (q, k, v, e))
    n = q.shape[-2]
    i = torch.arange(n)
    rel = e[(i[:, None] - i[None, :]).clamp(-p, p) + p]
    dots = (torch.einsum("bhid,bhjd->bhij", q, k)
            + torch.einsum("bhnd,nrd->bhnr", q, rel)) * scale
    if mask is not None:
        dots = dots.masked_fill(~mask[:, None, None, :], -1e30)
    return torch.einsum("bhij,bhjd->bhid", dots.softmax(-1), v)


def test_relpos_plain_matches_the_einsum_and_needs_the_term():
    """K2r's plain version (the op on CPU tensors) against the einsums in
    float64, logits O(1)-O(10) (q, k and E at N(0, 1)), offsets past the
    clamp (P = 8 at N = 40), a prefix mask, a gappy mask and a row keeping
    no key. Tolerance 2e-5: fp32 logits of O(10) through softmax. Without
    the relative term the output is off by at least 10x that."""
    g = torch.Generator().manual_seed(1)
    gq, h, n, d, p = 4, 2, 40, 16, 8
    q, k, v = (torch.randn(gq, h, n, d, generator=g) for _ in range(3))
    e = torch.randn(2 * p + 1, d, generator=g)
    mask = torch.ones(gq, n, dtype=torch.bool)
    mask[1, 25:] = False
    mask[2] = torch.rand(n, generator=g) < 0.3
    mask[3] = False
    tol = 2e-5
    for m in (None, mask):
        want = _einsum_relpos(q, k, v, e, p, 0.25, m)
        got = cuda_attention.attention_relpos(q, k, v, e, p, scale=0.25, mask=m)
        assert float((got.double() - want).abs().max()) <= tol
        without = cuda_attention.attention_relpos(q, k, v, torch.zeros_like(e), p, scale=0.25,
                                                  mask=m)
        assert float((without.double() - want).abs().max()) >= 10 * tol
    # the row keeping no key averages v over every key, as K2's rule
    assert torch.allclose(got[3], v[3].mean(dim=1, keepdim=True).expand_as(got[3]), atol=1e-6)


def test_relpos_refuses_a_gradient_and_counts_its_pairs():
    q = torch.randn(2, 4, 12, 16, requires_grad=True)
    e = torch.randn(17, 16)
    with pytest.raises(RuntimeError, match="forward only"):
        cuda_attention.attention_relpos(q, q, q, e, 8, scale=0.25)
    before = tracing.counters()
    mask = torch.arange(12)[None, :] < torch.tensor([[5], [12]])
    with torch.no_grad():
        cuda_attention.attention_relpos(q, q, q, e, 8, scale=0.25, mask=mask)
    after = tracing.counters()
    assert after["attention.relpos_calls"] - before.get("attention.relpos_calls", 0) == 1
    assert after["attention.relpos_pairs"] - before.get("attention.relpos_pairs", 0) == \
        4 * 12 * (5 + 12)
    with pytest.raises(ValueError, match="emb"):
        cuda_attention.attention_relpos(q.detach(), q.detach(), q.detach(), e[:5], 8, scale=0.25)


# --- K2r's index plan (csrc/attention_relpos.cu), in numpy --------------------
BK, BAND, LDR = 64, 80, 112


def _r_row(r):
    i = r & 7
    return r * LDR + ((8 * (i & 3) + (i >> 2) - i - r * LDR) & 31)


def _k2r_logits(q, k, e, p):
    """Logits as K2r forms them: per warp of 16 rows and tile of 64 keys the
    band R = Q E_band^T (rows clamped), written at the swizzled scratch rows,
    read along the diagonals by each lane (g, t) of the mma fragment."""
    n = q.shape[0]
    s = np.full((n, n), np.nan)
    for i0 in range(0, n, 16):
        for j0 in range(0, n, BK):
            rows = [min(max(i0 - j0 - 63 + c, -p), p) + p for c in range(BAND)]
            r = np.array([[q[i0 + a] @ e[o] if i0 + a < n else 0.0 for o in rows]
                          for a in range(16)])
            scratch = np.zeros(16 * LDR)
            for a in range(16):
                scratch[_r_row(a):_r_row(a) + BAND] = r[a]
            for g in range(8):
                for t in range(4):
                    for nt in range(8):
                        for c in range(2):
                            j = j0 + nt * 8 + 2 * t + c
                            for half, base in ((0, 63), (8, 71)):
                                i = i0 + g + half
                                if i < n and j < n:
                                    rel = scratch[_r_row(g + half) + g + base - 2 * t - nt * 8 - c]
                                    s[i, j] = q[i] @ k[j] + rel
    return s


@pytest.mark.parametrize("n,p", [(40, 8), (101, 512), (150, 20)])
def test_k2r_band_and_diagonals_give_the_relative_logits(n, p):
    rng = np.random.default_rng(n)
    q, k = rng.standard_normal((n, 16)), rng.standard_normal((n, 16))
    e = rng.standard_normal((2 * p + 1, 16))
    i = np.arange(n)
    want = q @ k.T + np.einsum("nd,nrd->nr", q, e[np.clip(i[:, None] - i[None, :], -p, p) + p])
    assert np.abs(_k2r_logits(q, k, e, p) - want).max() < 1e-12


def test_k2r_scratch_rows_do_not_overlap_and_diagonal_reads_fill_every_bank():
    for r in range(15):
        assert _r_row(r) + BAND <= _r_row(r + 1)
    for nt in range(8):
        for c in range(2):
            for half, base in ((0, 63), (8, 71)):
                banks = {(_r_row(g + half) + g + base - 2 * t - nt * 8 - c) % 32
                         for g in range(8) for t in range(4)}
                assert len(banks) == 32


# --- the enhancer -------------------------------------------------------------


def _enhancer(model, io_dtype="int16"):
    return AudioEnhancer(model, PORT_CONFIG, device="cpu", buckets=BUCKETS, io_dtype=io_dtype,
                         mask_padding=True)


def test_padding_to_two_buckets_gives_the_same_output(drawn):
    """A clip padded to 64 and to 128 frames, beside a longer clip, gives
    the same output to fp32 rounding (float32 I/O: no PCM16 steps)."""
    model, _, _ = drawn
    pool = clips.clip_pool(SEED, np.array([5000, 6000, 11000]))
    a, short, long_ = (clips.to_float(c) for c in pool)
    enh = _enhancer(model, "float32")
    with torch.no_grad():
        small = enh.enhance_batch([a, short])[0]
        large = enh.enhance_batch([a, long_])[0]
    assert enh._padded_len(6000) == 6300 and enh._padded_len(11000) == 12700
    assert np.abs(small - large).max() <= 1e-5 * np.abs(large).max()


def test_enhancer_matches_the_reference_pipeline(drawn):
    """``AudioEnhancer`` with the cmgan config, PCM16 in and out, against
    ``reference.enhance_rows`` (``torch.stft``/``torch.istft``): within 2
    PCM16 steps (fp32 rounding turns into one step where a sample sits on a
    step's edge; observed 1). Counts its frames and K2r's calls and pairs."""
    model, w, shapes = drawn
    lens = np.array([4800, 7300, 9600])
    pool = clips.clip_pool(SEED + 1, lens)
    enh = _enhancer(model)
    before = tracing.counters()
    out = enh.enhance_batch_async([clips.to_float(c) for c in pool]).result()
    after = tracing.counters()
    outs = [out[r, :n] for r, n in enumerate(lens)]
    padded = enh._padded_len(int(lens.max()))
    refs = offline_cmgan.reference_enhance(CONFIG, SEED, [(padded, pool)], "cpu", shapes)
    gap = max(float(np.abs(o - r).max()) * 32767 for o, r in zip(outs, refs))
    assert gap <= 2.0
    frames = 1 + padded // 100
    valid = int((1 + lens // 100).sum())

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    assert delta("cmgan.true_frames") == valid and delta("cmgan.padded_frames") == 3 * frames
    assert delta("attention.relpos_calls") == 8
    pairs = 4 * (101 * 4 * frames * valid + 3 * frames * 4 * 101 * 101)
    assert delta("attention.relpos_pairs") == pairs


def test_enhancer_refuses_a_blend_and_the_model_training_mode(drawn):
    model, _, _ = drawn
    with pytest.raises(ValueError, match="blend"):
        AudioEnhancer(model, PORT_CONFIG, device="cpu", blend=0.5)
    fresh = TSCNet()
    with pytest.raises(RuntimeError, match="inference only"):
        fresh(torch.zeros(1, 2, 8, 201))


def test_spans_name_the_encoder_blocks_and_decoders(drawn):
    model, _, _ = drawn
    tracing.clear()
    tracing.enable()
    try:
        with torch.no_grad():
            model(torch.randn(1, 2, 12, 201), torch.tensor([9]), 9)
    finally:
        tracing.disable()
    spans = tracing.spans()
    assert [s.id for s in spans if s.name == "cmgan.tscb"] == [1, 2, 3, 4]
    assert {"cmgan.encoder", "cmgan.decoders"} <= {s.name for s in spans}


# --- the factory and the CLIs -----------------------------------------------------


def test_create_model_dispatches_on_the_architecture():
    assert isinstance(create_model(PORT_CONFIG), TSCNet)
    small = {"model": {"encoder": {"channels": [4, 8, 16]},
                       "transformer": {"embed_dim": 16, "num_heads": 2, "num_layers": 1},
                       "decoder": {"channels": [16, 8, 4, 1]}}}
    assert isinstance(create_model(small), HybridViT)
    assert architecture({}) == "hybrid_vit"
    with pytest.raises(ValueError, match="architecture"):
        create_model({"model": {"architecture": "conformer_gan"}})


PKG = "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch"


def test_serve_cli_answers_a_request_with_a_cmgan_checkpoint(tmp_path, drawn):
    model, _, _ = drawn
    save_model_weights(tmp_path / "ck", model, config=PORT_CONFIG)
    noisy = clips.to_float(clips.clip_pool(SEED, np.array([6400]))[0])
    save_wav(tmp_path / "in.wav", noisy, 16000)
    (tmp_path / "cfg").mkdir()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.cli.serve", "--checkpoint", str(tmp_path / "ck"),
         "--device", "cpu", "--port", "0", "--config-dir", str(tmp_path / "cfg")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, deadline = None, time.time() + 120
        while port is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            found = re.search(r"serving on http://[^:]+:(\d+)", line)
            port = int(found.group(1)) if found else None
        assert port, "the server did not start"
        req = urllib.request.Request(f"http://127.0.0.1:{port}/enhance",
                                     data=(tmp_path / "in.wav").read_bytes(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            (tmp_path / "out.wav").write_bytes(r.read())
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    out, sr = load_audio(tmp_path / "out.wav", 16000)
    assert sr == 16000 and out.shape == noisy.shape and np.abs(out).max() > 0


def test_train_cli_refuses_cmgan(tmp_path):
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli import train

    (tmp_path / "model_config.yaml").write_text("model:\n  architecture: cmgan\n")
    with pytest.raises(SystemExit, match="ROADMAP item 23"):
        train.main(["--config-dir", str(tmp_path), "--device", "cpu", "--data-root",
                    str(tmp_path)])


# --- the FLOP count -----------------------------------------------------------------


def test_flop_count_is_the_benchmarks_frozen_copy():
    """``tools/flops.py`` and ``portbench/cmgan_work.py`` agree float for
    float at the cell's shapes (batch 32, every bucket, valid frames of a
    length-sorted batch); a 4-s clip (641 frames at hop 100: 160 frames a
    second) costs ~81 GFLOP an audio-second, 58% of it in the conformers."""
    for frames in CONFIG["buckets"]:
        valid = [frames - 3 * i for i in range(32)]
        assert flops.cmgan_forward_flops(32, frames, valid=valid) == \
            cmgan_work.forward_flops(CONFIG["model"], 32, frames, 201, valid)
    four = cmgan_work.forward_flops(CONFIG["model"], 1, 641)
    assert 80e9 < four["total"] / 4.0 < 82e9
    tscb = four["conformers"] + four["attention_time"] + four["attention_freq"]
    assert 0.57 < tscb / four["total"] < 0.59
    ops = sum(o for o, _ in cmgan_work.relpos_work(CONFIG, 2, 40000, [30000, 40000]))
    f = cmgan_work.forward_flops(CONFIG["model"], 2, 401, 201, [301, 401])
    assert ops == f["attention_time"] + f["attention_freq"]


def test_kernel_record_and_op():
    k = kernels.KERNELS["attention_relpos"]
    assert k.source == "csrc/attention_relpos.cu" and k.replaces == kernels.NO_TPU_KERNEL
    assert hasattr(torch.ops.sevit, "attention_relpos_fwd")
    assert cuda_attention.RELPOS_HEAD_DIMS == (16,)


# --- the conformer sublayer boundary: add_layer_norm ---------------------------------


def _boundary_inputs(g=3, n=37, c=64, seed=4):
    gen = torch.Generator().manual_seed(seed)
    x, delta, residual = (torch.randn(g, n, c, generator=gen) for _ in range(3))
    norm = torch.nn.LayerNorm(c)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
        norm.bias.copy_(0.1 * torch.randn(c, generator=gen))
    return x, delta, residual, norm


@pytest.mark.parametrize("position", ["no_delta", "rows_half", "rows_one", "channels_first",
                                      "epilogue"])
def test_add_layer_norm_plain_is_the_unfused_sequence(position):
    """The op's CPU impl at each of a block's five boundaries equals the
    ATen calls the block made unfused (``Scale``'s product, the residual
    add, ``nn.LayerNorm``, TSCB's outer add) bit for bit."""
    x, delta, residual, norm = _boundary_inputs()
    kw, want_s = {}, None
    with torch.no_grad():
        if position == "no_delta":
            d = None
            want_h = norm(x)
        elif position == "rows_half":
            d, kw = delta, dict(scale=0.5, keep_sum=True)
            want_s = delta * 0.5 + x
        elif position == "rows_one":
            d, kw = delta, dict(keep_sum=True)
            want_s = delta + x
        elif position == "channels_first":
            d = delta.transpose(1, 2).contiguous()  # [G, C, N], as the 1x1 conv leaves it
            kw = dict(channels_first=True, keep_sum=True)
            want_s = d.transpose(1, 2) + x
        else:
            d, kw = delta, dict(scale=0.5, residual=residual)
            want_h = norm(delta * 0.5 + x) + residual
        if want_s is not None:
            want_h = norm(want_s)
        s, h = cuda_layer_norm.add_layer_norm(x, d, norm.weight, norm.bias, norm.eps, **kw)
    assert torch.equal(h, want_h)
    if want_s is None:
        assert s is None
    else:
        assert torch.equal(s, want_s) and s.is_contiguous()


def _unfused_block(block, x, mask=None):
    """``ConformerBlock.forward`` as it ran before the fused boundaries: five
    LayerNorms, four residual adds and two half-step scales, each its own
    ATen call."""
    ff1, attn, conv, ff2 = block.ff1, block.attn, block.conv, block.ff2
    x = ff1.fn.fn(ff1.fn.norm(x)) * ff1.scale + x
    x = attn.fn(attn.norm(x), mask=mask) + x
    net = conv.net
    y = net[3](net[2](net[1](net[0](x))))
    if mask is not None:
        y = y * mask[:, None, :].to(x.dtype)
    for layer in net[4:]:
        y = layer(y)
    x = y + x
    x = ff2.fn.fn(ff2.fn.norm(x)) * ff2.scale + x
    return block.post_norm(x)


def _unfused_tscb(tscb, x_in, frames=None):
    b, c, t, f = x_in.shape
    x_t = x_in.permute(0, 3, 2, 1).contiguous().view(b * f, t, c)
    mask = None if frames is None else frames[:, None, :].expand(b, f, t).reshape(b * f, t)
    x_t = _unfused_block(tscb.time_conformer, x_t, mask) + x_t
    x_f = x_t.view(b, f, t, c).permute(0, 2, 1, 3).contiguous().view(b * t, f, c)
    x_f = _unfused_block(tscb.freq_conformer, x_f) + x_f
    return x_f.view(b, t, f, c).permute(0, 3, 1, 2)


@pytest.mark.parametrize("masked", [False, True], ids=["all_frames", "length_mask"])
def test_block_and_tscb_equal_the_unfused_forward_bit_for_bit(drawn, masked):
    """One ``ConformerBlock`` and a whole ``TSCB`` at the published widths
    (the benchmark's weights) on the CPU: the fused boundaries give the
    unfused forward's output exactly, with and without a length mask."""
    model, _, _ = drawn
    gen = torch.Generator().manual_seed(5)
    x_in = torch.randn(2, 64, 23, 201, generator=gen)
    frames = torch.arange(23)[None, :] < torch.tensor([[23], [11]]) if masked else None
    block = model.TSCB_2.time_conformer
    x_t = x_in.permute(0, 3, 2, 1).contiguous().view(2 * 201, 23, 64)
    mask = None if frames is None else frames[:, None, :].expand(2, 201, 23).reshape(-1, 23)
    with torch.no_grad():
        assert torch.equal(block(x_t, mask=mask), _unfused_block(block, x_t, mask))
        assert torch.equal(block(x_t, mask=mask, residual=x_t),
                           _unfused_block(block, x_t, mask) + x_t)
        got = model.TSCB_3(x_in, frames)
        want = _unfused_tscb(model.TSCB_3, x_in, frames)
    assert got.shape == want.shape == x_in.shape and torch.equal(got, want)


def test_add_norm_calls_count_five_a_block_and_forty_a_forward(drawn):
    model, _, _ = drawn

    def calls(fn):
        before = tracing.counters().get("cmgan.add_norm_calls", 0)
        with torch.no_grad():
            fn()
        return tracing.counters()["cmgan.add_norm_calls"] - before

    x = torch.randn(6, 17, 64)
    assert calls(lambda: model.TSCB_1.freq_conformer(x)) == 5
    assert calls(lambda: model(torch.randn(1, 2, 12, 201), torch.tensor([9]), 9)) == 40


def test_add_layer_norm_refuses_a_gradient_and_what_it_does_not_take():
    x, delta, residual, norm = _boundary_inputs()
    with pytest.raises(RuntimeError, match="forward only"):
        cuda_layer_norm.add_layer_norm(x, delta, norm.weight, norm.bias, norm.eps)
    w, b = norm.weight.detach(), norm.bias.detach()
    with pytest.raises(RuntimeError, match="forward only"):
        cuda_layer_norm.add_layer_norm(x.requires_grad_(), None, w, b, 1e-5)
    x = x.detach()
    with pytest.raises(ValueError, match="delta"):
        cuda_layer_norm.add_layer_norm(x, delta, w, b, 1e-5, channels_first=True)
    with pytest.raises(ValueError, match="need a delta"):
        cuda_layer_norm.add_layer_norm(x, None, w, b, 1e-5, keep_sum=True)
    with pytest.raises(ValueError, match="residual"):
        cuda_layer_norm.add_layer_norm(x, delta, w, b, 1e-5, residual=residual[:, :5])


def test_add_layer_norm_op_passes_opcheck_on_the_cpu():
    """Schema, fake impl against the plain outputs (shapes, strides, dtypes),
    and dispatch, at each boundary's arguments."""
    from torch.library import opcheck

    x, delta, residual, norm = _boundary_inputs(2, 9)
    w, b = norm.weight.detach(), norm.bias.detach()
    cf = delta.transpose(1, 2).contiguous()
    for args in ((x, None, w, b, 1e-5, 1.0, False, None, False),
                 (x, delta, w, b, 1e-5, 0.5, False, None, True),
                 (x, cf, w, b, 1e-5, 1.0, True, None, True),
                 (x, delta, w, b, 1e-5, 0.5, False, residual, False)):
        opcheck(cuda_layer_norm.add_layer_norm_op, args)


def test_add_layer_norm_kernel_record_and_op():
    k = kernels.KERNELS["add_layer_norm"]
    assert k.source == "csrc/add_layer_norm.cu" and k.replaces == kernels.NO_TPU_KERNEL
    assert k.entry == "sevit_add_layer_norm" and len(k.argtypes) == 13
    assert hasattr(torch.ops.sevit, "add_layer_norm")
    assert cuda_layer_norm.CHANNELS == CONFIG["model"]["channels"] == 64


# the authors' names of one conformer block's parameters and buffers
# (their checkpoint's keys under TSCB_i.time_conformer / freq_conformer)
BLOCK_KEYS = {
    "ff1.fn.norm.weight", "ff1.fn.norm.bias", "ff1.fn.fn.net.0.weight", "ff1.fn.fn.net.0.bias",
    "ff1.fn.fn.net.3.weight", "ff1.fn.fn.net.3.bias",
    "attn.norm.weight", "attn.norm.bias", "attn.fn.to_q.weight", "attn.fn.to_kv.weight",
    "attn.fn.to_out.weight", "attn.fn.to_out.bias", "attn.fn.rel_pos_emb.weight",
    "conv.net.0.weight", "conv.net.0.bias", "conv.net.2.weight", "conv.net.2.bias",
    "conv.net.4.conv.weight", "conv.net.4.conv.bias", "conv.net.5.weight", "conv.net.5.bias",
    "conv.net.5.running_mean", "conv.net.5.running_var", "conv.net.5.num_batches_tracked",
    "conv.net.7.weight", "conv.net.7.bias",
    "ff2.fn.norm.weight", "ff2.fn.norm.bias", "ff2.fn.fn.net.0.weight", "ff2.fn.fn.net.0.bias",
    "ff2.fn.fn.net.3.weight", "ff2.fn.fn.net.3.bias",
    "post_norm.weight", "post_norm.bias",
}


def test_state_dict_keys_are_the_authors():
    model = create_model(PORT_CONFIG)
    keys = set(model.state_dict())
    for i in range(1, 5):
        for which in ("time_conformer", "freq_conformer"):
            pre = f"TSCB_{i}.{which}."
            assert {k[len(pre):] for k in keys if k.startswith(pre)} == BLOCK_KEYS
    assert len(keys) == 359


def test_the_window_and_the_traced_slice_run_whole_passes(monkeypatch):
    """The cell's drive on the CPU at a small pool: the window runs whole
    passes of the batches in ``make_batches``' order however short
    ``--seconds`` is, so every clip counts once a pass; the traced slice
    drains before each dispatch and times the ``cmgan.tscb`` spans."""
    from portbench import trace
    from portbench.run import Context

    params = {"lengths": {"kind": "uniform", "min_s": 0.1, "max_s": 0.3}, "pool": 6,
              "batch": 2, "check_batches": 1}
    config = dict(CONFIG, buckets=[40, 64])
    order = []
    real = AudioEnhancer.enhance_batch_async

    def recording(self, floats, *a, **kw):
        order.append(sum(len(f) for f in floats))
        return real(self, floats, *a, **kw)

    monkeypatch.setattr(AudioEnhancer, "enhance_batch_async", recording)
    ctx = Context(config=config, params=params, seed=SEED, seconds=0.0, trace=False,
                  control=False, device=torch.device("cpu"), tracer=trace.Tracer(False),
                  spans=trace.Spans())
    out = offline_cmgan.run(ctx)
    assert out["attempted"] == 6 and ctx.facts["window_flops"] > 0
    batches = offline_batches.make_batches(ctx)
    per_batch = [sum(len(c) for c in rows) for _, rows in batches]
    assert order[-3:] == per_batch  # after the warm-up, one pass in order

    class Traced(trace.Tracer):
        def start(self):
            self.t0 = time.perf_counter()

        def stop(self):
            self.t1 = time.perf_counter()

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: synced.append(1))
    ctx = Context(config=config, params=params, seed=SEED, seconds=0.0, trace=True,
                  control=False, device=torch.device("cpu"), tracer=Traced(True),
                  spans=trace.Spans())
    out = offline_cmgan.run(ctx)
    assert out["attempted"] == 6 and len(synced) == 3
    assert ctx.facts["slice_flops"] == ctx.facts["window_flops"]
    assert len(ctx.facts["traced_dsp"]) == 3 and ctx.facts["tscb_launch_ms"] > 0
    assert tracing.span("cmgan.tscb") is tracing.NO_SPAN  # the recorder is off again
