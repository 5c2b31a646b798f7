"""CMGAN's masked InstanceNorm with the PReLU after it as one op,
``ops/cuda_instance_norm.py`` (``sevit::instance_norm_prelu``): its CPU impl
against the unfused ATen calls the model made before, bit for bit, at each
kind of site; the model's 16 calls a forward, counted and exported; the
kernel's chunk plan and its registry record. The kernel itself is checked on
the card (``tests/test_torch_cuda.py``)."""

import json
from pathlib import Path

import pytest
import torch
import torch.nn as nn

from portbench.traffic import offline_cmgan
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import cmgan
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
    cuda_instance_norm as cin,
    kernels,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils import tracing

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "portbench" / "configs" / "cmgan.json").read_text())
H100_SMS = 132


def unfused(x, norm, prelu, valid):
    """The model's InstanceNorm and PReLU as ATen calls, as they ran before
    the op: ``valid [B, 1, T, 1]`` float or None."""
    if valid is None:
        y = norm(x)
    else:
        count = valid.sum(dim=2, keepdim=True) * x.shape[-1]
        mean = (x * valid).sum(dim=(2, 3), keepdim=True) / count
        var = (((x - mean) ** 2) * valid).sum(dim=(2, 3), keepdim=True) / count
        y = (x - mean) * torch.rsqrt(var + norm.eps)
        y = y * norm.weight[None, :, None, None] + norm.bias[None, :, None, None]
    return prelu(y)


def _site(c, slopes, seed=3):
    gen = torch.Generator().manual_seed(seed)
    norm, prelu = nn.InstanceNorm2d(c, affine=True), nn.PReLU(slopes)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
        norm.bias.copy_(0.1 * torch.randn(c, generator=gen))
        prelu.weight.copy_(0.25 + 0.1 * torch.randn(slopes, generator=gen))
    return norm, prelu, gen


@pytest.mark.parametrize("c,f,slopes,counts,layout", [
    (64, 201, 64, [19, 1, 11], "nchw"),   # the encoder's DenseNet: a full row, a 1-frame row
    (64, 101, 64, [19, 1, 11], "nchw"),   # the encoder's conv_2
    (64, 101, 64, [19, 1, 11], "nhwc"),   # the decoders' DenseNets (channels-last)
    (64, 202, 64, [19, 1, 11], "nchw"),   # the complex decoder's norm
    (1, 201, 1, [19, 1, 11], "nchw"),     # the mask decoder's norm: one channel, one slope
    (64, 201, 1, [19, 1, 11], "nchw"),    # one slope for 64 channels
    (64, 201, 64, None, "nchw"),          # every frame valid: nn.InstanceNorm2d
    (64, 101, 64, None, "nhwc"),
], ids=["dense_201", "conv2_101", "decoder_cl_101", "complex_202", "mask_one_channel",
        "one_slope", "unmasked", "unmasked_cl"])
def test_cpu_op_is_the_unfused_sequence(c, f, slopes, counts, layout):
    """The op's CPU impl equals the ATen calls it replaced, bit for bit and
    in their layout."""
    norm, prelu, gen = _site(c, slopes)
    x = torch.randn(3, c, 19, f, generator=gen)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    n_valid = None if counts is None else torch.tensor(counts, dtype=torch.int32)
    valid = (None if counts is None else
             (torch.arange(19)[None, :] < n_valid[:, None])[:, None, :, None].to(x.dtype))
    with torch.no_grad():
        want = unfused(x, norm, prelu, valid)
        got = cin.instance_norm_prelu(x, n_valid, norm.weight, norm.bias, prelu.weight, norm.eps)
    assert torch.equal(got, want) and got.stride() == want.stride()


@pytest.fixture(scope="module")
def model():
    return offline_cmgan.build_model(CONFIG, 2147483911, "cpu")[0]


def test_forward_equals_the_unfused_model_bit_for_bit(model, monkeypatch):
    """A whole ``TSCNet`` forward on the CPU, with a length mask and without,
    equals the forward with the unfused ATen calls in the op's place."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 2, 23, 201, generator=gen)
    n_valid = torch.tensor([23, 12])
    with torch.no_grad():
        got = [model(x, n_valid, 35), model(x)]

    def unfused_site(x, norm, prelu, n_valid):
        valid = None if n_valid is None else (
            torch.arange(x.shape[2])[None, :] < n_valid[:, None])[:, None, :, None].to(x.dtype)
        return unfused(x, norm, prelu, valid)

    monkeypatch.setattr(cmgan, "norm_prelu", unfused_site)
    with torch.no_grad():
        want = [model(x, n_valid, 35), model(x)]
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))


def test_instance_norm_calls_count_sixteen_a_forward(model):
    def calls(fn):
        before = tracing.counters().get("cmgan.instance_norm_calls", 0)
        with torch.no_grad():
            fn()
        return tracing.counters()["cmgan.instance_norm_calls"] - before

    assert calls(lambda: model(torch.randn(1, 2, 9, 201), torch.tensor([6]), 6)) == 16
    assert calls(lambda: model.mask_decoder(torch.randn(1, 64, 5, 101))) == 5


def test_exported_forward_calls_each_op_as_the_card_launches_it(model):
    """``torch.export`` of a masked forward records the op 16 times beside
    K2r's 8 and ``add_layer_norm``'s 40, nothing else of the ``sevit``
    namespace and none of the ATen calls it replaced; the exported program's
    output is the eager one's."""
    x = torch.randn(2, 2, 12, 201)
    n_valid = torch.tensor([12, 7], dtype=torch.int32)
    with torch.no_grad():
        program = torch.export.export(model, (x, n_valid, 19))
        got = program.module()(x, n_valid, 19)
        want = model(x, n_valid, 19)
    assert kernels.op_calls(program) == {"instance_norm_prelu": 16, "add_layer_norm": 40,
                                         "attention_relpos_fwd": 8}
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    # nothing of the unfused chain is left; the one PReLU is the mask decoder's
    # prelu_out, which follows no InstanceNorm
    chain = ("aten.sum", "aten.rsqrt", "aten.sub", "aten.div", "aten.instance_norm")
    assert not [t for t in targets if t.startswith(chain)]
    assert targets.count("aten.prelu.default") == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("planes,plane_len,chunks", [
    (32 * 64, 819 * 201, 11),   # the encoder's DenseNet, a plane of [32, 64, 819, 201]
    (32, 819 * 101 * 64, 324),  # the decoders' DenseNets, channels-last: a row a plane
    (32, 819 * 201, 17),        # the mask decoder's one channel
    (1, 21, 1),
], ids=["nchw_64", "nhwc_64", "one_channel", "tiny"])
def test_chunk_plan_fills_the_card(planes, plane_len, chunks):
    """At most ``CHUNK`` floats a block, and at least ``BLOCKS_PER_SM``
    blocks an SM of an H100 where chunks of ``MIN_CHUNK`` floats allow it:
    the mask decoder's 32 planes are cut into 17 chunks each, not 11."""
    assert cin.chunks_per_plane(planes, plane_len, H100_SMS) == chunks
    assert -(-plane_len // chunks) <= cin.CHUNK
    assert planes * chunks >= cin.BLOCKS_PER_SM * H100_SMS or chunks * cin.MIN_CHUNK >= plane_len


def test_refuses_a_gradient_and_what_it_does_not_take():
    norm, prelu, gen = _site(4, 4)
    x = torch.randn(2, 4, 5, 6, generator=gen)
    with pytest.raises(RuntimeError, match="forward only"):
        cin.instance_norm_prelu(x, None, norm.weight, norm.bias, prelu.weight, 1e-5)
    w, b, a = (t.detach() for t in (norm.weight, norm.bias, prelu.weight))
    with pytest.raises(ValueError, match="int32"):
        cin.instance_norm_prelu(x, torch.tensor([5, 3]), w, b, a, 1e-5)
    with pytest.raises(ValueError, match="slope"):
        cin.instance_norm_prelu(x, None, w, b, a[:2], 1e-5)
    with pytest.raises(ValueError, match="weight and bias"):
        cin.instance_norm_prelu(x, None, w[:3], b, a, 1e-5)
    with pytest.raises(ValueError, match=r"\[B, C, T, F\]"):
        cin.instance_norm_prelu(x[0], None, w, b, a, 1e-5)


def test_op_passes_opcheck_on_the_cpu():
    """Schema, fake impl against the plain outputs (shapes, strides, dtypes),
    and dispatch, with and without counts, in both layouts."""
    from torch.library import opcheck

    norm, prelu, gen = _site(8, 8)
    w, b, a = (t.detach() for t in (norm.weight, norm.bias, prelu.weight))
    x = torch.randn(2, 8, 6, 5, generator=gen)
    counts = torch.tensor([6, 2], dtype=torch.int32)
    for args in ((x, None, w, b, a, 1e-5), (x, counts, w, b, a, 1e-5),
                 (x.contiguous(memory_format=torch.channels_last), counts, w, b, a[:1], 1e-5)):
        opcheck(cin.instance_norm_prelu_op, args)


def test_kernel_record_and_op():
    k = kernels.KERNELS["instance_norm"]
    assert k.source == "csrc/instance_norm.cu" and k.replaces == kernels.NO_TPU_KERNEL
    assert k.entry == "sevit_instance_norm_prelu" and len(k.argtypes) == 16
    assert hasattr(torch.ops.sevit, "instance_norm_prelu")
    assert CONFIG["model"]["channels"] in cin.CHANNELS_LAST
