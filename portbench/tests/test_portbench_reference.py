"""The yardstick against the port's plain CPU path at a tiny size: the work
counts, the plain reference of the model and of the enhancement, and the
train steps it follows; and that the control (the reference in TF32) reads
far above the program."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import clips, system, weights, work
from portbench.reference import hvit, pipeline
from portbench.tests import tiny

PORT = system.PORT


def _config(tmp_path):
    return json.loads(tiny.config_file(tmp_path).read_text())


@pytest.mark.parametrize("name", ["hvit28m", "hvit168m"])
@pytest.mark.parametrize("frames", [384, 1024])
def test_forward_flops_equal_the_ports(name, frames):
    flops = pytest.importorskip(f"{PORT}.tools.flops")
    config = json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())
    with torch.device("meta"):
        model = system.port("models").create_hybrid_vit(system.port_config(config))
    ours = work.forward_flops(work.spec_from_config(config["model"]), 32, 257, frames)
    theirs = flops.forward_flops(flops.spec_from_model(model), 32, 257, frames)
    assert ours == theirs


def test_param_counts_in_the_config_files():
    for name in ("hvit28m", "hvit168m"):
        config = json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())
        with torch.device("meta"):
            model = system.port("models").create_hybrid_vit(system.port_config(config))
        assert system.count_params(model) == config["params"]


def test_kept_keys_match_the_ports_mask():
    comps = pytest.importorskip(f"{PORT}.models.components")
    spec = work.ModelSpec()
    lengths = [16000, 40000, 130000]
    mask = comps.patch_validity_mask(torch.tensor(lengths), 257, 1024, 128)
    assert work.kept_keys(spec, 257, 1024, 128, lengths) == mask.sum(1).tolist()


def test_reference_forward_matches_the_port(tmp_path):
    config = _config(tmp_path)
    model, w = system.build_model(config, 7, torch.device("cpu"))
    x = torch.rand(2, 257, 128, 1, generator=torch.Generator().manual_seed(0))
    mask = hvit.key_mask(config["model"], 257, 128, 128, torch.tensor([9000, 16256]))
    with torch.no_grad():
        ours = hvit.forward(w, config["model"], x, mask=mask)
        theirs = model(x, mask=mask)
    assert torch.allclose(ours, theirs, atol=2e-5, rtol=0)


def test_reference_enhancement_matches_the_port(tmp_path):
    config = _config(tmp_path)
    model, w = system.build_model(config, 8, torch.device("cpu"))
    enhancer = system.port("inference").AudioEnhancer(
        model, system.port_config(config), device="cpu", buckets=tuple(config["buckets"]),
        io_dtype="int16", mask_padding=True)
    pcm = clips.clip_pool(8, np.array([9000, 20000, 32000]))
    padded = hvit.bucket_len(32000, config["buckets"], 128)
    out = enhancer.enhance_batch_async([clips.to_float(c) for c in pcm]).result()
    assert out.shape == (3, padded)
    ref = pipeline.enhance_rows(w, config, pcm, padded, "cpu")
    for row, (c, r) in enumerate(zip(pcm, ref)):
        assert np.abs(out[row, :len(c)] - r).max() * 32767 <= 1.01


def test_train_numbers_and_control(tmp_path):
    line = tiny.run_cell("hvit28m.train_b16", tmp_path, "--control", "1")
    got = {k: c["value"] for k, c in line["checks"].items()}
    # float32 on both sides: the first BatchNorm's and conv's gradients, sums
    # over every pixel of the batch, carry the most reduction-order noise
    assert got["loss_step1_rel"] < 1e-5 and got["grad_norm_gap_max"] < 1e-3
    assert got["change_norm_gap_max"] < 1e-3
    ctrl = line["control"]
    assert ctrl["loss_step1_rel"] > 10 * max(got["loss_step1_rel"], 1e-8), ctrl
    assert ctrl["grad_norm_gap_max"] > 10 * got["grad_norm_gap_max"], ctrl


def test_enhancement_control_reads_above_the_program(tmp_path):
    line = tiny.run_cell("hvit28m.offline_b32", tmp_path, "--control", "1")
    assert line["checks"]["pcm16_lsb_max"]["value"] <= 1.01
    assert line["control"]["rms_lsb_max"] > 3 * line["readings"]["rms_lsb_max"]


def test_weights_are_the_seeds():
    shapes = {"a.conv.weight": (4, 2, 3, 3), "a.bn.weight": (4,), "a.bn.bias": (4,),
              "a.bn.running_var": (4,), "fc.weight": (3, 5), "fc.bias": (3,)}
    one = weights.draw(shapes, 2**31 + 12345, "cpu")
    two = weights.draw(shapes, 2**31 + 12345, "cpu")
    other = weights.draw(shapes, 2**31 + 12346, "cpu")
    assert all(torch.equal(one[k], two[k]) for k in shapes)
    assert not torch.equal(one["fc.weight"], other["fc.weight"])
    assert (one["a.bn.running_var"] > 0).all()


def test_lengths_and_arrivals_do_not_depend_on_the_seed():
    a = clips.lengths_for({"lengths": tiny.SHORT}, 100)
    assert a.min() >= 0.5 * 16000 and a.max() <= 2.0 * 16000
    x = np.sort(np.diff(clips.poisson_offsets(100.0, 10.0, 1), prepend=0.0))
    y = np.sort(np.diff(clips.poisson_offsets(100.0, 10.0, 2), prepend=0.0))
    assert np.allclose(x, y)
