"""SEMamba's generator on the port: ``models/semamba.py`` against the plain
reference ``portbench/reference/semamba.py``, the selective scan's plain
version against a float64 loop, the depthwise conv with its SiLU against a
float64 sum of shifted inputs, padding invariance, the enhancer's SEMamba
path, the factory and the CLIs, the FLOP count and the benchmark's drive."""

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
import torch.nn.functional as F

from portbench import clips, semamba_work
from portbench.reference import semamba as reference
from portbench.traffic import offline_batches, offline_semamba
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import (
    load_audio,
    save_wav,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
    AudioEnhancer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
    SEMamba,
    TSCNet,
    create_model,
    semamba,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
    cuda_scan,
    kernels,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools import flops
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils import tracing
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    save_model_weights,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "portbench" / "configs" / "semamba.json").read_text())
PORT_CONFIG = {"model": CONFIG["model"], "audio": CONFIG["audio"]}
# the published layout at small widths, for the forward passes on the CPU
SMALL = dict(CONFIG, model=dict(CONFIG["model"], hid_feature=8, num_tfmamba=2, d_state=4))
SMALL_PORT = {"model": SMALL["model"], "audio": SMALL["audio"]}
SEED = 2147483957
BUCKETS = (64, 128)  # frames at hop 100: 6,300 and 12,700 samples
PKG = "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch"


@pytest.fixture(scope="module")
def small():
    """The small model with the benchmark's seeded weights, and its shapes."""
    return offline_semamba.build_model(SMALL, SEED, "cpu")


def _counter(name: str, fn) -> int:
    before = tracing.counters().get(name, 0)
    fn()
    return tracing.counters().get(name, 0) - before


# --- the published model ---------------------------------------------------------


def test_parameter_count_is_the_papers():
    """2,258,769 parameters (the paper's 2.25M): each TFMamba block 277,888
    (each Mamba layer 65,280), the encoder 382,592, the decoders 382,287 and
    382,338."""
    model = create_model(PORT_CONFIG)
    assert isinstance(model, SEMamba) and not model.training
    assert sum(p.numel() for p in model.parameters()) == 2_258_769 == CONFIG["params"]
    parts = {name: sum(p.numel() for p in module.parameters())
             for name, module in model.named_children()}
    assert parts == {"dense_encoder": 382_592, "TSMamba": 4 * 277_888,
                     "mask_decoder": 382_287, "phase_decoder": 382_338}
    mixer = model.TSMamba[0].time_mamba.forward_blocks[0].mixer
    assert sum(p.numel() for p in mixer.parameters()) == 65_280
    assert (mixer.d_inner, mixer.dt_rank, mixer.d_state) == (256, 4, 16)


# the authors' names of one direction's parameters (their checkpoint's keys
# under TSMamba.{i}.{time,freq}_mamba.{forward,backward}_blocks.0)
BLOCK_KEYS = {"norm.weight", "mixer.A_log", "mixer.D", "mixer.in_proj.weight",
              "mixer.conv1d.weight", "mixer.conv1d.bias", "mixer.x_proj.weight",
              "mixer.dt_proj.weight", "mixer.dt_proj.bias", "mixer.out_proj.weight"}


def test_state_dict_keys_are_the_authors():
    keys = set(create_model(PORT_CONFIG).state_dict())
    for i in range(4):
        for axis in ("time", "freq"):
            for way in ("forward", "backward"):
                pre = f"TSMamba.{i}.{axis}_mamba.{way}_blocks.0."
                assert {k[len(pre):] for k in keys if k.startswith(pre)} == BLOCK_KEYS
        for lin in ("tlinear", "flinear"):
            assert {f"TSMamba.{i}.{lin}.weight", f"TSMamba.{i}.{lin}.bias"} <= keys
    for part in ("dense_encoder", "mask_decoder", "phase_decoder"):
        pre = f"{part}.dense_block.dense_block."
        assert {k[len(pre):] for k in keys if k.startswith(pre)} == {
            f"{i}.{m}.{p}" for i in range(4) for m, p in
            (("0", "weight"), ("0", "bias"), ("1", "weight"), ("1", "bias"), ("2", "weight"))}
    assert {"dense_encoder.dense_conv_1.0.weight", "dense_encoder.dense_conv_2.2.weight",
            "mask_decoder.mask_conv.0.weight", "mask_decoder.mask_conv.4.bias",
            "mask_decoder.lsigmoid.slope", "phase_decoder.phase_conv.1.bias",
            "phase_decoder.phase_conv_r.weight", "phase_decoder.phase_conv_i.bias"} <= keys
    assert len(keys) == 265


def test_mamba_layers_start_from_the_published_initialisation():
    mixer = create_model(PORT_CONFIG).TSMamba[2].freq_mamba.backward_blocks[0].mixer
    assert torch.equal(mixer.A_log, torch.log(torch.arange(1.0, 17.0)).repeat(256, 1))
    assert torch.equal(mixer.D, torch.ones(256))
    dt = F.softplus(mixer.dt_proj.bias.detach())
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)


# --- the model against the reference -------------------------------------------------


def test_model_matches_the_reference():
    """The port's SEMamba against the plain functional forward at 8
    channels, 2 blocks, d_state 4 and 65 bins, rows of 30 and 17 valid
    frames, seeded weights (the benchmark's draw). Tolerance 2e-5 of the
    output's largest magnitude (the mask times |X|^0.3) and 2e-4 rad of the
    phase away from its +-pi cut: fp32 sums in other orders (the masked
    InstanceNorms, the GEMMs, the depthwise convs) through ~40 layers, and
    the phase an atan2 of the last 1x1 convs; observed ~1e-6."""
    cfg = dict(SMALL, audio=dict(SMALL["audio"], n_fft=128))
    model, shapes = offline_semamba.build_model(cfg, SEED, "cpu")
    w = offline_semamba.draw(shapes, SEED, "cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 2, 30, 65, generator=g)
    n_valid = torch.tensor([30, 17])
    with torch.no_grad():
        mag, pha = model(x, n_valid)
    want_mag, want_pha = reference.forward(w, cfg["model"], x, n_valid)
    assert mag.shape == pha.shape == want_mag.shape == (2, 1, 30, 65)
    assert float((mag - want_mag).abs().max()) <= 2e-5 * float(want_mag.abs().max())
    gap = (pha - want_pha).abs()
    gap = torch.minimum(gap, 2 * torch.pi - gap)  # the same angle across the cut
    assert float(gap.max()) <= 2e-4


# --- the selective scan -------------------------------------------------------------


def _scan_loop64(u, delta, z, b, c, a_log, d, bias, n_valid, reverse):
    """The published recurrence in float64, sequence by sequence, over each
    valid prefix (reversed where asked); 0 elsewhere."""
    u, delta, z, b, c, a_log, d, bias = (t.double() for t in (u, delta, z, b, c, a_log, d, bias))
    g, length, _ = u.shape
    a = -torch.exp(a_log)
    out = torch.zeros_like(u)
    for s in range(g):
        n = length if n_valid is None else int(n_valid[s])
        h = torch.zeros_like(a)
        for t in (range(n - 1, -1, -1) if reverse else range(n)):
            dt = F.softplus(delta[s, t] + bias)
            h = torch.exp(dt[:, None] * a) * h + (dt * u[s, t])[:, None] * b[s, t][None, :]
            out[s, t] = ((h * c[s, t]).sum(-1) + d * u[s, t]) * F.silu(z[s, t])
    return out


def _scan_inputs(g=5, length=23, d=16, n=4, seed=3):
    """The scan's inputs as the model hands them over: z, B and C strided
    views of the in_proj and x_proj rows."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.randn(g, length, d, generator=gen)
    delta = torch.randn(g, length, d, generator=gen) - 1.0
    xz = torch.randn(g, length, 2 * d, generator=gen)
    x_dbl = torch.randn(g, length, 1 + 2 * n, generator=gen)
    a_log = torch.log(torch.arange(1.0, n + 1)).repeat(d, 1) + 0.1 * torch.randn(d, n,
                                                                                  generator=gen)
    dt = torch.exp(torch.rand(d, generator=gen) * np.log(100.0) + np.log(1e-3))
    bias = dt + torch.log(-torch.expm1(-dt))
    d_skip = 1.0 + 0.1 * torch.randn(d, generator=gen)
    return u, delta, xz[..., d:], x_dbl[..., 1:1 + n], x_dbl[..., 1 + n:], a_log, d_skip, bias


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_steps", "n_valid"])
def test_scan_plain_matches_a_float64_loop(reverse, masked):
    """The op's CPU impl against the recurrence in float64, per sequence,
    over every step and under ``n_valid`` of 23, 10, 1, 0 and 17 of 23 steps
    (the reverse from each sequence's last valid step, from a zero state).
    Tolerance 2e-5 of the largest output: fp32 through up to 23 steps of a
    recurrence whose decays are at most 1."""
    args = _scan_inputs()
    n_valid = torch.tensor([23, 10, 1, 0, 17], dtype=torch.int32) if masked else None
    with torch.no_grad():
        got = cuda_scan.selective_scan(*args, n_valid=n_valid, reverse=reverse)
    want = _scan_loop64(*args, n_valid, reverse)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) <= 2e-5 * float(want.abs().max())
    if masked:
        assert float(got[1, 10:].abs().max()) == 0.0 and float(got[3].abs().max()) == 0.0


def test_scan_reaches_past_a_window_of_64_steps():
    """At Mamba's published decays (A = -(1 .. N), dt down to 1e-3) a step
    still moves the output 200 steps on: a scan cut to 64-step windows (the
    benchmark's first fault) is off."""
    gen = torch.Generator().manual_seed(4)
    g, length, d, n = 2, 200, 8, 4
    u = torch.zeros(g, length, d)
    u[:, 0] = 1.0
    delta = torch.full((g, length, d), -50.0)  # softplus(bias - 50) = ~dt
    z = torch.ones(g, length, d)
    b = c = torch.ones(g, length, n)
    a_log = torch.log(torch.arange(1.0, n + 1)).repeat(d, 1)
    dt = torch.full((d,), 1e-3)
    bias = dt + torch.log(-torch.expm1(-dt)) + 50.0
    d_skip = torch.ones(d)
    args = (u, delta, z, b, c, a_log, d_skip, bias)
    with torch.no_grad():
        y = cuda_scan.selective_scan(*args)
        cut = offline_semamba.fault_scan("reset64")(*args)
    assert float(y[:, -1].abs().min()) > 1e-3 * float(y[:, 0].abs().max())
    assert float(cut[:, 64:].abs().max()) == 0.0
    assert torch.equal(cut[:, :64], y[:, :64])
    del gen


def test_scan_refuses_a_gradient_and_what_it_does_not_take():
    args = list(_scan_inputs())
    with pytest.raises(RuntimeError, match="forward only"):
        cuda_scan.selective_scan(args[0].requires_grad_(), *args[1:])
    args[0] = args[0].detach()
    with pytest.raises(ValueError, match="A_log"):
        cuda_scan.selective_scan(*args[:5], args[5][:3], *args[6:])
    with pytest.raises(ValueError, match="n_valid"):
        cuda_scan.selective_scan(*args, n_valid=torch.ones(5, dtype=torch.int64))


def test_scan_op_passes_opcheck_on_the_cpu():
    """Schema, fake impl against the plain outputs, and dispatch, with and
    without lengths, in both directions."""
    from torch.library import opcheck

    args = _scan_inputs(g=3, length=9, d=8, n=4)
    for n_valid, reverse in ((None, False), (torch.tensor([9, 4, 0], dtype=torch.int32), True)):
        opcheck(cuda_scan.selective_scan_op, (*args, n_valid, reverse))


def test_kernel_record_and_op():
    k = kernels.KERNELS["selective_scan"]
    assert k.source == "csrc/selective_scan.cu" and k.replaces == kernels.NO_TPU_KERNEL
    assert "no such model" in kernels.NO_TPU_KERNEL
    assert k.entry == "sevit_selective_scan" and len(k.argtypes) == 18
    assert hasattr(torch.ops.sevit, "selective_scan")
    assert CONFIG["model"]["d_state"] in cuda_scan.STATES


# --- the depthwise conv and its SiLU ------------------------------------------------


def _causal_conv_silu64(x, w, bias):
    """The causal depthwise conv and its SiLU in float64, as a sum of the
    input shifted by 3, 2, 1 and 0 steps (zeros before the first)."""
    x, w, bias = x.double(), w.double(), bias.double()
    g, length, d = x.shape
    k = w.shape[-1]
    xp = torch.cat([x.new_zeros(g, k - 1, d), x], dim=1)
    acc = bias.expand(g, length, d)
    for j in range(k):
        acc = acc + w[:, 0, j] * xp[:, j:j + length]
    return F.silu(acc)


def _conv_inputs(g=4, length=23, d=16, seed=5, strided=True):
    """x as the model hands it over (the first half of the in_proj rows) or
    contiguous, a conv weight [d, 1, 4] and bias at mamba_ssm's scale."""
    gen = torch.Generator().manual_seed(seed)
    xz = 2.0 * torch.randn(g, length, 2 * d, generator=gen)
    x = xz[..., :d] if strided else xz[..., :d].contiguous()
    w = 0.5 * torch.randn(d, 1, 4, generator=gen)
    return x, w, 0.3 * torch.randn(d, generator=gen)


@pytest.mark.parametrize("length", [1, 3, 100])
@pytest.mark.parametrize("strided", [True, False], ids=["xz_half", "contiguous"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_conv_silu_plain_matches_float64(reverse, strided, length):
    """The op's CPU impl against the conv in float64: causal, or mirrored as
    the causal conv of the flipped sequence, flipped back; fewer steps than
    taps (1, 3) and many. Tolerance 1e-6 of the largest output: four fp32
    products summed into the bias and a SiLU (observed 1.8e-7)."""
    x, w, bias = _conv_inputs(length=length, strided=strided)
    assert x.is_contiguous() != strided
    with torch.no_grad():
        got = cuda_scan.conv1d_silu(x, w, bias, reverse)
    want = (_causal_conv_silu64(x.flip(1), w, bias).flip(1) if reverse
            else _causal_conv_silu64(x, w, bias))
    assert got.shape == x.shape and got.is_contiguous() and got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_conv_op_passes_opcheck_on_the_cpu():
    """Schema, fake impl against the plain outputs, and dispatch, x strided
    and contiguous, both directions."""
    from torch.library import opcheck

    for strided, reverse in ((True, False), (False, True), (True, True)):
        x, w, bias = _conv_inputs(g=3, length=9, d=8, strided=strided)
        opcheck(cuda_scan.conv1d_silu_op, (x, w, bias, reverse))


def test_conv_kernel_reads_x_in_place(monkeypatch):
    """The op's CUDA impl, its launch stubbed: x handed over where it lies in
    the in_proj rows (its data pointer, a token every 2 * d_inner floats),
    u allocated contiguous, the direction and the width passed."""
    import contextlib

    calls = []
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "launch", lambda name, *a: calls.append((name, a)))
    x, w, bias = _conv_inputs(g=3, length=9, d=8)
    u = cuda_scan._conv_kernel(x, w, bias, True)
    ((name, args),) = calls
    assert name == "conv1d_silu"
    assert args[:4] == (x.data_ptr(), w.data_ptr(), bias.data_ptr(), u.data_ptr())
    assert args[4:] == (3, 9, 8, 4, 16, 1)
    assert u.shape == x.shape and u.is_contiguous()


def test_conv_refuses_a_gradient_and_what_it_does_not_take(monkeypatch):
    x, w, bias = _conv_inputs(g=2, length=5, d=8)
    with pytest.raises(RuntimeError, match="forward only"):
        cuda_scan.conv1d_silu(x, w.clone().requires_grad_(), bias)
    with pytest.raises(ValueError, match="weight must be"):
        cuda_scan.conv1d_silu(x, w[:4], bias)
    monkeypatch.setattr(kernels, "launch", lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match="width 3"):
        cuda_scan._conv_kernel(x, w[..., :3], bias, False)
    with pytest.raises(ValueError, match="rows of tokens"):
        cuda_scan._conv_kernel(x.transpose(0, 1), w, bias, False)


def test_conv_kernel_takes_any_stride_of_a_size_one_axis(monkeypatch):
    """Views of the in_proj rows with one sequence or one step (a size-1
    axis's stride, never stepped, is the rows' and may stay so through
    ``.contiguous()``): the kernel reads them in place, a sequence of one
    step at the sequences' stride."""
    import contextlib

    calls = []
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "launch", lambda name, *a: calls.append(a))
    x, w, bias = _conv_inputs(g=3, length=9, d=8)
    for cut, token in ((x[1:2, 4:5], 8), (x[:, 4:5], 144), (x[1:2], 16)):
        cuda_scan._conv_kernel(cut, w, bias, False)
        assert calls[-1][0] == cut.data_ptr() and calls[-1][4:7] == cut.shape
        assert calls[-1][8] == token


def test_conv_kernel_record_and_op():
    k = kernels.KERNELS["conv1d_silu"]
    assert k.source == "csrc/conv1d_silu.cu" and k.replaces == kernels.NO_TPU_KERNEL
    assert k.entry == "sevit_conv1d_silu" and len(k.argtypes) == 11
    assert hasattr(torch.ops.sevit, "conv1d_silu")
    assert CONFIG["model"]["d_conv"] in cuda_scan.WIDTHS
    # the benchmark finds the scan's kernels by the registry name: this one
    # must not pass for one of them
    assert not k.name.startswith("selective_scan")


# --- the enhancer ---------------------------------------------------------------------


def _enhancer(model, io_dtype="int16"):
    return AudioEnhancer(model, SMALL_PORT, device="cpu", buckets=BUCKETS, io_dtype=io_dtype,
                         mask_padding=True)


def test_padding_to_two_buckets_gives_the_same_output(small):
    """A clip padded to 64 and to 128 frames, beside a longer clip, gives
    the same output to fp32 rounding (float32 I/O: no PCM16 steps): the
    backward scans start at each row's last valid frame and the DenseBlocks'
    convs see zeros past it."""
    model, _ = small
    pool = clips.clip_pool(SEED, np.array([5000, 6000, 11000]))
    a, short, long_ = (clips.to_float(c) for c in pool)
    enh = _enhancer(model, "float32")
    with torch.no_grad():
        small_out = enh.enhance_batch([a, short])[0]
        large_out = enh.enhance_batch([a, long_])[0]
    assert enh._padded_len(6000) == 6300 and enh._padded_len(11000) == 12700
    assert np.abs(small_out - large_out).max() <= 1e-5 * np.abs(large_out).max()


def test_enhancer_matches_the_reference_pipeline(small):
    """``AudioEnhancer`` with a SEMamba, PCM16 in and out, against
    ``reference.enhance_rows`` (``torch.stft``/``torch.istft``): within 2
    PCM16 steps (fp32 rounding turns into one step where a sample sits on a
    step's edge; observed 1). Counts its frames, scans and norms."""
    model, shapes = small
    lens = np.array([4800, 7300, 9600])
    pool = clips.clip_pool(SEED + 1, lens)
    enh = _enhancer(model)
    before = tracing.counters()
    out = enh.enhance_batch_async([clips.to_float(c) for c in pool]).result()
    after = tracing.counters()
    outs = [out[r, :len(c)] for r, c in enumerate(pool)]
    padded = enh._padded_len(int(lens.max()))
    refs = offline_semamba.reference_enhance(SMALL, SEED, [(padded, pool)], "cpu", shapes)
    gap = max(float(np.abs(o - r).max()) * 32767 for o, r in zip(outs, refs))
    assert gap <= 2.0

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    frames = 1 + padded // 100
    valid = int((1 + lens // 100).sum())
    assert delta("semamba.true_frames") == valid and delta("semamba.padded_frames") == 3 * frames
    assert delta("semamba.scan_calls") == 8 and delta("semamba.instance_norm_calls") == 16
    assert delta("semamba.conv_calls") == 8
    assert delta("semamba.scan_tokens") == 8 * valid * 100


def test_first_frame_and_edge_bins_are_real_in_exact_arithmetic():
    """The imaginary parts the SEMamba core and the reference set to 0 are
    0 in float64: bins 0 and 200 of every frame, every bin of the first
    frame (reflect padding makes it even about its centre; the periodic Hann
    window keeps it so)."""
    x = torch.randn(2, 4000, generator=torch.Generator().manual_seed(6), dtype=torch.float64)
    spec = torch.stft(x, 400, 100, 400, window=torch.hann_window(400, dtype=torch.float64),
                      center=True, pad_mode="reflect", return_complex=True)
    scale = float(spec.abs().max())
    assert float(spec[:, 0].imag.abs().max()) < 1e-12 * scale
    assert float(spec[:, 200].imag.abs().max()) < 1e-12 * scale
    assert float(spec[:, :, 0].imag.abs().max()) < 1e-12 * scale
    assert float(spec[:, 1:200, 1:].imag.abs().max()) > 0.1 * scale


def test_enhancer_refuses_a_blend_and_the_model_training_mode(small):
    model, _ = small
    with pytest.raises(ValueError, match="SEMamba's enhancer takes no blend"):
        AudioEnhancer(model, SMALL_PORT, device="cpu", blend=0.5)
    fresh = SEMamba(hid_feature=8, num_tfmamba=1, d_state=4)
    fresh.train()
    with pytest.raises(RuntimeError, match="inference only"):
        fresh(torch.zeros(1, 2, 8, 201))


def test_spans_and_counters_name_the_encoder_blocks_and_decoders(small):
    model, _ = small
    tracing.clear()
    tracing.enable()
    try:
        with torch.no_grad():
            convs = tracing.counters().get("semamba.conv_calls", 0)
            calls = _counter("semamba.scan_calls",
                             lambda: model(torch.randn(1, 2, 12, 201), torch.tensor([9]), 9))
            convs = tracing.counters().get("semamba.conv_calls", 0) - convs
    finally:
        tracing.disable()
    spans = tracing.spans()
    assert [s.id for s in spans if s.name == "semamba.tfmamba"] == [1, 2]
    assert {"semamba.encoder", "semamba.decoders"} <= {s.name for s in spans}
    assert calls == convs == 8  # 4 a block: time and frequency, both directions
    with torch.no_grad():
        norms = _counter("semamba.instance_norm_calls",
                         lambda: model(torch.randn(1, 2, 12, 201)))
        convs = _counter("semamba.conv_calls", lambda: model(torch.randn(1, 2, 12, 201)))
    assert norms == 16 and convs == 8


# --- the factory and the CLIs -------------------------------------------------------


def test_create_model_dispatches_on_the_architecture():
    assert isinstance(create_model(PORT_CONFIG), SEMamba)
    cmgan = json.loads((ROOT / "portbench" / "configs" / "cmgan.json").read_text())
    assert isinstance(create_model({"model": cmgan["model"], "audio": cmgan["audio"]}), TSCNet)
    with pytest.raises(ValueError, match="semamba takes no overrides"):
        create_model(PORT_CONFIG, embed_dim=8)
    m = create_model(SMALL_PORT)
    assert m.TSMamba[0].time_mamba.forward_blocks[0].mixer.d_state == 4
    assert len(m.TSMamba) == 2 and m.compress_factor == 0.3


def test_enhance_cli_writes_a_file_with_a_semamba_checkpoint(tmp_path, small):
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli import enhance

    model, _ = small
    save_model_weights(tmp_path / "ck", model, config=SMALL_PORT)
    noisy = clips.to_float(clips.clip_pool(SEED, np.array([7000]))[0])
    save_wav(tmp_path / "in.wav", noisy, 16000)
    (tmp_path / "cfg").mkdir()
    enhance.main(["--checkpoint", str(tmp_path / "ck"), "--device", "cpu", "--input",
                  str(tmp_path / "in.wav"), "--output", str(tmp_path / "out.wav"),
                  "--config-dir", str(tmp_path / "cfg"), "--mask-padding"])
    out, sr = load_audio(tmp_path / "out.wav", 16000)
    assert sr == 16000 and out.shape == noisy.shape and np.abs(out).max() > 0
    enh = AudioEnhancer(model, SMALL_PORT, device="cpu", mask_padding=True)
    want = np.clip(enh.enhance(load_audio(tmp_path / "in.wav", 16000)[0]), -1.0, 1.0)
    assert np.abs(out - want).max() <= 1.5 / 32767  # the PCM16 file's rounding


def test_serve_cli_answers_a_request_with_a_semamba_checkpoint(tmp_path, small):
    model, _ = small
    save_model_weights(tmp_path / "ck", model, config=SMALL_PORT)
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


def test_train_cli_refuses_semamba(tmp_path):
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli import train

    (tmp_path / "model_config.yaml").write_text("model:\n  architecture: semamba\n")
    with pytest.raises(SystemExit, match="HybridViT only"):
        train.main(["--config-dir", str(tmp_path), "--device", "cpu", "--data-root",
                    str(tmp_path)])


# --- the FLOP count and the benchmark's work ------------------------------------------


def test_flop_count_is_the_benchmarks_frozen_copy():
    """``tools/flops.py`` and ``portbench/semamba_work.py`` agree term for
    term at the cell's shapes (batch 32, every bucket, valid frames of a
    length-sorted batch); a 4-s clip (641 frames) costs ~88 GFLOP an
    audio-second, 45% of it in the TFMamba blocks."""
    for frames in CONFIG["buckets"]:
        valid = [frames - 3 * i for i in range(32)]
        assert flops.semamba_forward_flops(32, frames, valid=valid) == \
            semamba_work.forward_flops(CONFIG["model"], 32, frames, 201, valid)
    four = semamba_work.forward_flops(CONFIG["model"], 1, 641)
    assert 87e9 < four["total"] / 4.0 < 89e9
    blocks = four["mamba"] + four["scans"] + four["linear"]
    assert 0.44 < blocks / four["total"] < 0.46
    per_frame = semamba_work.forward_flops(CONFIG["model"], 1, 1000)["total"] / 1000
    assert 540e6 < per_frame < 555e6


def test_scan_work_counts_the_valid_steps():
    """16 calls a batch; bytes 4.2 KB and 16 x 19 x 256 operations a valid
    (frame, bin) step, each call over the valid frames' 100 bins."""
    lens = [30000, 40000]
    work = semamba_work.scan_work(CONFIG, 2, 40000, lens)
    steps = (301 + 401) * 100
    assert len(work) == 16 and all(w == work[0] for w in work)
    assert work[0] == (16 * 19 * 256 * steps, 4.0 * (4 * 256 + 32) * steps)
    ops = flops.semamba_forward_flops(2, 401, valid=[301, 401])["scans"]
    assert ops == 16 * flops.scan_flops(steps, 256, 16)


def test_weights_follow_the_published_initialisation_and_are_seeded():
    shapes = {n: tuple(t.shape) for n, t in create_model(PORT_CONFIG).state_dict().items()}
    w = offline_semamba.draw(shapes, SEED, "cpu")
    again = offline_semamba.draw(shapes, SEED, "cpu")
    assert all(torch.equal(w[n], again[n]) for n in w)
    pre = "TSMamba.1.time_mamba.backward_blocks.0.mixer."
    assert torch.equal(w[pre + "A_log"], torch.log(torch.arange(1.0, 17.0)).repeat(256, 1))
    assert torch.equal(w[pre + "D"], torch.ones(256))
    dt = F.softplus(w[pre + "dt_proj.bias"])
    assert 0.9e-3 < float(dt.min()) and float(dt.max()) < 0.11 and float(dt.std()) > 0.01
    other = offline_semamba.draw(shapes, SEED + 7, "cpu")
    assert not torch.equal(other[pre + "dt_proj.bias"], w[pre + "dt_proj.bias"])
    assert torch.equal(w["mask_decoder.lsigmoid.slope"], torch.ones(201, 1))


def test_the_window_and_the_traced_slice_run_whole_passes(monkeypatch):
    """The cell's drive on the CPU at a small pool and width: the window
    runs whole passes of the batches in ``make_batches``' order however
    short ``--seconds`` is; the traced slice drains before each dispatch and
    times the ``semamba.tfmamba`` spans; the check compares with the
    reference."""
    from portbench import trace
    from portbench.run import Context

    params = {"lengths": {"kind": "uniform", "min_s": 0.1, "max_s": 0.3}, "pool": 6,
              "batch": 2, "check_batches": 1}
    config = dict(SMALL, buckets=[40, 64])
    order = []
    real = AudioEnhancer.enhance_batch_async

    def recording(self, floats, *a, **kw):
        order.append(sum(len(f) for f in floats))
        return real(self, floats, *a, **kw)

    monkeypatch.setattr(AudioEnhancer, "enhance_batch_async", recording)
    ctx = Context(config=config, params=params, seed=SEED, seconds=0.0, trace=False,
                  control=False, device=torch.device("cpu"), tracer=trace.Tracer(False),
                  spans=trace.Spans())
    out = offline_semamba.run(ctx)
    assert out["attempted"] == 6 and ctx.facts["window_flops"] > 0
    batches = offline_batches.make_batches(ctx)
    per_batch = [sum(len(c) for c in rows) for _, rows in batches]
    assert order[-3:] == per_batch  # after the warm-up, one pass in order
    numbers, ctrl = out["check"]()
    assert numbers["pcm16_lsb_max"] <= 2.0 and ctrl is None

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
    out = offline_semamba.run(ctx)
    assert out["attempted"] == 6 and len(synced) == 3
    assert ctx.facts["slice_flops"] == ctx.facts["window_flops"]
    assert len(ctx.facts["traced_dsp"]) == 3 and len(ctx.facts["traced_scan"]) == 3 * 8
    assert ctx.facts["tfmamba_launch_ms"] > 0
    assert tracing.span("semamba.tfmamba") is tracing.NO_SPAN  # the recorder is off again


@pytest.fixture(scope="module")
def published():
    """The published widths with the benchmark's seeded weights, a row of
    160 frames (110 valid) of a compressed magnitude and a phase, and the
    model's output on it."""
    model, _ = offline_semamba.build_model(CONFIG, SEED, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.stack([3 * torch.rand(1, 160, 201, generator=g) ** 2,
                     torch.pi * (2 * torch.rand(1, 160, 201, generator=g) - 1)], dim=1)
    n_valid = torch.tensor([110])
    with torch.no_grad():
        return model, x, n_valid, model(x, n_valid)


@pytest.mark.parametrize("fault", ["reset64", "reverse_from_end", "reverse_is_forward"])
def test_each_fault_moves_the_published_model(fault, published, monkeypatch):
    """Each of the cell's stand-ins in the scan's place moves the model's
    output over the valid frames at the published widths and weights: the
    magnitude by more than 2e-4 of its largest (ten times the tolerance the
    port keeps to the reference), the phase by more than 0.05 rad somewhere
    (observed 1.2e-3 to 3.7e-3, and 0.17 to 2.8 rad)."""
    model, x, n_valid, (mag, pha) = published
    monkeypatch.setattr(semamba, "selective_scan", offline_semamba.fault_scan(fault))
    with torch.no_grad():
        got_mag, got_pha = model(x, n_valid)
    gap = (got_pha - pha).abs()
    gap = torch.minimum(gap, 2 * torch.pi - gap)[..., :110, :]
    assert float((got_mag - mag)[..., :110, :].abs().max()) > 2e-4 * float(mag.abs().max())
    assert float(gap.max()) > 0.05
