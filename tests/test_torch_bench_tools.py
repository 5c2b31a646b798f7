"""The port's measurement tools (``…_torch/tools/``: ``flops``, ``roofline``,
``bench_stages``, ``bench_infer``, ``bench``, ``bench_train``,
``bench_scaling``, ``bench_io``) on the CPU, against the JAX repo's
``bench.py`` and ``benchmarks/`` scripts.

- The analytic FLOP counts equal the JAX ``benchmarks/flops.py`` ones
  exactly (the same arithmetic on the same integers), loaded by path (it
  imports JAX only inside its functions), and ``spec_from_model`` reads the
  same spec off the port's model as off the JAX one.
- PyTorch's own count of a CPU forward (``torch_program_flops``, with the
  ``sevit`` ops' formulas) within 2% of the analytic count, the bound
  ``tests/test_flops.py`` holds XLA's count to; it is the analytic count
  less the bilinear resizes, which the port computes with ``F.interpolate``
  (PyTorch counts them as 0), to float rounding.
- The roofline's bytes at ``A = 2`` equal the JAX script's (its constant
  ``A = 2``), and are twice them at ``A = 4``.
- Each prefix of ``bench_stages`` gives the JAX model's output on the same
  numpy batch and weights (carried across by ``flax_to_state_dict``), at
  the port's CPU limits: the STFT magnitude 2e-4, the model's outputs 1e-4,
  the waveform 5e-5 (measured 7.6e-6, 1.9e-6 at most and 1.1e-6 on outputs
  of peak 12.6, 0.7-2.6 and 1.8).
- Each tool runs with ``--device cpu`` at a tiny size and exits 0, writing
  no device metric; ``--device cuda`` without a card exits non-zero.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import (
    create_hybrid_vit as j_create_hybrid_vit,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.ops.stft import (
    STFTConfig as JSTFTConfig,
    magphase as j_magphase,
    reconstruct as j_reconstruct,
    stft as j_stft,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
    MultiHeadSelfAttention,
    create_hybrid_vit,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import cuda_attention
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools import (
    bench,
    bench_infer,
    bench_io,
    bench_scaling,
    bench_stages,
    bench_train,
    flops,
    roofline,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    flax_to_state_dict,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch"
TOOLS = ("flops", "roofline", "bench_stages", "bench_infer", "bench", "bench_train",
         "bench_scaling", "bench_io")
NO_DROPOUT = dict(dropout=0.0, attn_dropout=0.0, drop_path_rate=0.0)
TINY = dict(encoder_channels=(8, 16, 32), embed_dim=32, num_heads=2, num_layers=1,
            mlp_ratio=2.0, decoder_channels=(16, 8, 8, 1))
CONFIGS = {  # the 28M heads, the 12L/1024d/16h stress config, a tiny one
    "28m_resize": {},
    "28m_fullres_mask": {"head_type": "fullres_mask"},
    "12l_1024d_16h": {"embed_dim": 1024, "num_heads": 16, "num_layers": 12},
    "tiny": TINY,
}
# (batch, frames): the bench cells (bench.py's 3 s device leg, the serving
# bucket) and shapes off the patch grid
SHAPES = ((32, 376), (32, 384), (16, 384), (1, 128), (3, 201))


def _load(name: str):
    """A JAX repo ``benchmarks/`` script, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_benchmarks_{name}",
                                                  ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass looks its module up
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)  # roofline.py puts benchmarks/ on the path
    finally:
        sys.path[:] = path
    return mod


J_FLOPS = _load("flops")
J_ROOFLINE = _load("roofline")


def _specs(config: str):
    """(the port's spec, the JAX script's spec) of one configuration, each
    read off its own package's model."""
    kw = {**NO_DROPOUT, **CONFIGS[config]}
    return (flops.spec_from_model(create_hybrid_vit(**kw)),
            J_FLOPS.spec_from_model(j_create_hybrid_vit(**kw)))


# ---------------------------------------------------------------------------
# the analytic count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", list(CONFIGS))
def test_spec_from_model_matches_jax(config):
    port, jax_spec = _specs(config)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_spec)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_forward_and_train_flops_equal_jax(config):
    port, jax_spec = _specs(config)
    for b, t in SHAPES:
        assert flops.forward_flops(port, b, 257, t) == J_FLOPS.forward_flops(jax_spec, b, 257, t)
        for n_params in (None, 28_451_073):
            assert (flops.train_step_flops(port, b, 257, t, n_params=n_params)
                    == J_FLOPS.train_step_flops(jax_spec, b, 257, t, n_params=n_params))
        assert flops.inference_step_flops(port, b, 257, t) == (
            J_FLOPS.forward_flops(jax_spec, b, 257, t)["total"] + 2 * J_FLOPS.stft_flops(b, t))


def test_stft_flops_equal_jax():
    for b, t, n_fft in ((32, 376, 512), (1, 384, 512), (4, 100, 1024), (2, 17, 256)):
        assert flops.stft_flops(b, t, n_fft) == J_FLOPS.stft_flops(b, t, n_fft)


def test_expected_sizes():
    """The sizes the benches' shares rest on: the 28M resize forward at
    32 x 376 frames (bench.py's device leg) and the fullres_mask one at the
    384-frame serving bucket."""
    assert flops.forward_flops(_specs("28m_resize")[0], 32, 257, 376)["total"] == pytest.approx(
        0.938e12, rel=1e-3)
    assert flops.forward_flops(_specs("28m_fullres_mask")[0], 32, 257, 384)["total"] == (
        pytest.approx(1.075e12, rel=1e-3))


def test_peaks_are_the_data_sheets():
    """The H100 SXM's dense rates by math mode, none for another card (and
    none without a card: a share then reads "not measured")."""
    card = "NVIDIA H100 80GB HBM3"
    assert [flops.peak_flops(m, card) for m in ("fp32", "tf32", "bf16")] == [67e12, 495e12, 989e12]
    assert flops.peak_bytes_per_s(card) == 3.35e12
    assert flops.peak_flops("fp32", "NVIDIA A100-SXM4-80GB") is None
    if not torch.cuda.is_available():
        assert flops.peak_flops() is None and flops.mfu_pct(1e12, 0.1) is None
        assert flops.mfu_report(1e12, 0.5) == "2.00 TFLOP/s achieved"
    assert flops.mfu_report(1e12, None) == "not measured"
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        assert flops.math_mode() == "tf32"
        torch.backends.cudnn.allow_tf32 = False  # cuDNN's convolutions in fp32
        assert flops.math_mode() == "fp32"
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# PyTorch's count
# ---------------------------------------------------------------------------


def _counted_forward(config: str, frames: int) -> tuple[float, dict, flops.ModelSpec]:
    model = create_hybrid_vit(**NO_DROPOUT, **CONFIGS[config])
    x = torch.from_numpy(np.random.default_rng(0).random((1, 257, frames, 1), np.float32))
    with torch.no_grad():
        counted = flops.torch_program_flops(model, x)
    spec = flops.spec_from_model(model)
    return counted, flops.forward_flops(spec, 1, 257, frames), spec


@pytest.mark.parametrize("config,frames", [("28m_resize", 128), ("28m_fullres_mask", 96),
                                           ("12l_1024d_16h", 64)])
def test_torch_count_matches_analytic(config, frames):
    """Within 2% where the bilinear resizes are small (the resize head; the
    fullres head's nudge is 3.1% of its forward at 3 s), and at every
    config exactly the analytic count less them."""
    counted, analytic, spec = _counted_forward(config, frames)
    less_resizes = analytic["total"] - flops.bilinear_flops(spec, 1, 257, frames)
    assert counted == pytest.approx(less_resizes, rel=1e-9), (counted, less_resizes)
    if spec.head_type == "resize":
        assert counted == pytest.approx(analytic["total"], rel=0.02)


def test_count_needs_the_sevit_formulas():
    """Without the formulas the counter counts the ``sevit`` ops as 0: the
    attention's QK^T and AV vanish and the count falls more than 2% short
    of the analytic one."""
    saved = {op: flop_registry.pop(op) for op in flops.SEVIT_OPS}
    try:
        counted, analytic, _ = _counted_forward("28m_resize", 128)
    finally:
        flop_registry.update(saved)
    assert counted < 0.98 * analytic["total"]


def test_inference_step_count_within_two_percent():
    """The core step the benches time: K1 and K3 through their formulas."""
    cfg = STFTConfig()
    model = bench_stages.build_model(device="cpu")
    res = bench_infer.measure(model, "cpu", 1, 63 * cfg.hop_length, 1, cfg)
    assert res["frames"] == 64 and res["step_ms"] is None and res["mfu_pct"] is None
    assert res["torch_flops"] == pytest.approx(res["analytic_flops"], rel=0.02)


def test_attention_formulas_forward_and_backward():
    """K2's op counts QK^T and AV; its gradient's op twice that."""
    b, h, n, d = 2, 3, 17, 8
    q, k, v = (torch.randn(b, h, n, d, requires_grad=True) for _ in range(3))
    counter = FlopCounterMode(display=False)
    with counter:
        cuda_attention.attention(q, k, v, scale=d**-0.5).sum().backward()
    by_op = {str(op): c for op, c in counter.get_flop_counts()["Global"].items()}
    assert by_op["sevit.attention_fwd"] == 4 * b * h * n * n * d
    assert by_op["sevit.attention_bwd"] == 8 * b * h * n * n * d


# ---------------------------------------------------------------------------
# the roofline's bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", list(CONFIGS))
def test_roofline_bytes_equal_jax_at_two_and_double_at_four(config):
    port, jax_spec = _specs(config)
    assert J_ROOFLINE.A == 2
    b, f, t = 32, 257, 376
    ff, tt, skips = f, t, []
    for ch, p in zip(port.encoder_channels, port.encoder_pool_sizes):
        if p > 1:
            ff, tt = ff // p, tt // p
        skips.append((ff, tt, ch))
    h, w = ff // port.patch_size, tt // port.patch_size
    pairs = [
        (lambda m, s, **a: m.encoder_bytes(s, b, f, t, **a)),
        (lambda m, s, **a: m.transformer_bytes(s, b, h * w, **a)),
        (lambda m, s, **a: m.decoder_bytes(s, b, h, w, skips, **a)),
        (lambda m, s, **a: m.head_bytes(s, b, h, w, f, t, **a)),
    ]
    for fn in pairs:
        ref = fn(J_ROOFLINE, jax_spec)
        assert fn(roofline, port, A=2) == ref
        assert fn(roofline, port, A=4) == 2 * ref


@pytest.mark.parametrize("args", [[], ["--fullres"], ["--scaled"], ["--batch", "8", "--frames",
                                                                  "200"]])
def test_roofline_stages_equal_the_jax_table(args, monkeypatch):
    """The JAX script's printed FLOPs and bytes a stage (at its A = 2)."""
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["roofline.py", *args, "--stages-json", "/nonexistent"])
    with contextlib.redirect_stdout(out):
        assert J_ROOFLINE.main() == 0
    ref = {r["stage"]: (r["GF"], r["MB_moved"]) for r in json.loads(out.getvalue())["stages"]}
    spec = flops.ModelSpec(**({"embed_dim": 1024, "num_heads": 16, "num_layers": 12}
                              if "--scaled" in args else {}))
    if "--fullres" in args:
        spec.head_type = "fullres_mask"
    b, t = (8, 200) if "--batch" in args else (32, 376)
    got = {name: (round(fl / 1e9, 1), round(by / 1e6, 1))
           for name, (fl, by) in roofline.stages(spec, b, 257, t, A=2).items()}
    assert got == ref


# ---------------------------------------------------------------------------
# bench_stages' prefixes against the JAX model
# ---------------------------------------------------------------------------

SMALL = dict(embed_dim=64, num_heads=4, num_layers=2, mlp_ratio=2.0,
             encoder_channels=(16, 32, 64), decoder_channels=(32, 16, 8, 1), **NO_DROPOUT)
STAGE_TOL = {"front": 2e-4, "encoder": 1e-4, "transformer": 1e-4, "pre_resize": 1e-4,
             "model": 1e-4, "full": 5e-5}


def _jax_variables(model, x, rng):
    """Random variables for the JAX model, drawn with numpy: fan-in scaled
    kernels, non-trivial norms, biases and BatchNorm statistics."""
    template = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0), a, train=False),
                              jnp.asarray(x))

    def draw(path, leaf):
        name = path[-1].key
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "var":
            return 0.5 + 0.5 * np.abs(n)
        return (0.1 if name in ("bias", "mean") else 0.02) * n

    return jax.tree_util.tree_map_with_path(draw, template)


def _jax_prefix(stage, model, variables, noisy, cfg):
    """The JAX ``benchmarks/bench_stages.py`` step's body for ``stage`` on
    one batch (its counter chain left out)."""
    mx = jnp.max(jnp.abs(noisy), axis=-1, keepdims=True)
    x = noisy / jnp.where(mx > 1e-8, mx, 1.0)
    mag, phase = j_magphase(*j_stft(x, cfg, method="auto"))
    mm = jnp.max(mag, axis=(-2, -1), keepdims=True)
    mm = jnp.where(mm > 1e-8, mm, 1.0)
    if stage == "front":
        return mag
    out = model.apply(variables, (mag / mm)[..., None], train=False,
                      stage_out=None if stage in ("model", "full") else stage)
    if stage != "full":
        return out
    return j_reconstruct(out[..., 0] * mm, phase, cfg, length=noisy.shape[-1], method="auto")


@pytest.fixture(scope="module")
def stage_models():
    rng = np.random.default_rng(0)
    b, wav_len = bench_stages.batch_shape(2, 0.5, 128)
    noisy = (0.3 * rng.standard_normal((b, wav_len))).astype(np.float32)
    jm = j_create_hybrid_vit(**SMALL)
    v = _jax_variables(jm, np.zeros((1, 257, wav_len // 128 + 1, 1), np.float32), rng)
    tm = create_hybrid_vit(**SMALL)
    tm.load_state_dict(flax_to_state_dict(v), strict=True)
    return noisy, jm, v, tm


@pytest.mark.parametrize("stage", [p for p in bench_stages.PREFIXES if p != "synth"])
def test_stage_prefix_matches_jax(stage, stage_models):
    noisy, jm, v, tm = stage_models
    ref = np.asarray(_jax_prefix(stage, jm, v, jnp.asarray(noisy), JSTFTConfig()))
    got = bench_stages.run_prefix(stage, tm, torch.from_numpy(noisy), STFTConfig()).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=STAGE_TOL[stage], rtol=0)


def test_synthesize_draws_fresh_batches():
    gen = torch.Generator().manual_seed(0)
    a, b = (bench_stages.synthesize(gen, 3, 1000) for _ in range(2))
    assert a.shape == (3, 1000) and a.dtype == torch.float32 and not torch.equal(a, b)
    assert 0.25 < float(a.std()) < 0.35


# ---------------------------------------------------------------------------
# the tools as programs, on the CPU
# ---------------------------------------------------------------------------


def _run(module, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert module.main(argv) == 0
    return out.getvalue()


def test_bench_prints_one_json_line_without_device_metrics():
    lines = _run(bench, ["--device", "cpu", "--batch", "1", "--seconds", "0.5"]).splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    for key in ("value", "vs_baseline", "device_audio_s_per_s", "device_step_ms", "mfu_pct",
                "link_MBps_h2d", "link_MBps_d2h"):
        assert key in line and line[key] is None, key
    assert line["device"] == "cpu" and line["unit"] == "audio_s/s"
    assert line["flops_per_step"] == flops.inference_step_flops(flops.ModelSpec(), 1, 257, 63)


def test_bench_stages_and_roofline_on_the_cpu(tmp_path):
    out = tmp_path / "stages.json"
    text = _run(bench_stages, ["--device", "cpu", "--batch", "1", "--seconds", "0.5", "--fp32",
                               "--json-out", str(out)])
    assert "not measured" in text
    saved = json.loads(out.read_text())
    assert set(saved["prefix_ms"]) == set(bench_stages.PREFIXES)
    assert set(saved["stage_ms"]) == {label for label, _, _ in bench_stages.PAIRS}
    assert saved["full_step_ms"] is None and saved["device"] == "cpu"
    res = json.loads(_run(roofline, ["--device", "cpu", "--stages-json", str(out)]))
    assert res["config"]["batch"] == 1 and res["config"]["frames"] == 63
    assert res["peak_tflops"] is None and "t_roofline_ms" not in res["stages"][0]
    res = json.loads(_run(roofline, ["--device", "cpu", "--card", "NVIDIA H100 80GB HBM3"]))
    assert res["peak_tflops"] == 67.0 and res["hbm_TBps"] == 3.35
    assert {r["bound"] for r in res["stages"]} <= {"operations", "bytes"}
    assert all(r["t_roofline_ms"] == max(r["t_compute_ms"], r["t_bandwidth_ms"])
               for r in res["stages"])


def test_bench_infer_and_bench_train_on_the_cpu():
    text = _run(bench_infer, ["--device", "cpu", "--batch", "1", "--seconds", "0.5",
                              "--attention", "xla", "--fold-bn"])
    assert "not measured" in text and "analytic/torch" in text
    text = _run(bench_train, ["--device", "cpu", "--batch", "2", "--frames", "64",
                              "--attention", "pallas", "--output-mode", "mask", "--fp32"])
    assert "train step: not measured" in text and "MFU: not measured" in text


def test_bench_io_on_the_cpu():
    text = _run(bench_io, ["--device", "cpu", "--files", "3", "--seconds", "0.25",
                           "--repeats", "1"])
    assert "numpy parser" in text


def test_bench_scaling_on_gloo_ranks():
    """Two world sizes over gloo, each rank a spawned process (its own
    interpreter: run as a program, as a user would)."""
    proc = subprocess.run(
        [sys.executable, "-m",
         "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.bench_scaling",
         "--device", "cpu", "--max-ranks", "2", "--per-device-batch", "1", "--frames", "32"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    rows = [line for line in proc.stdout.splitlines() if line.startswith("devices=")]
    assert len(rows) == 2 and all("not measured" in r for r in rows)


def test_flops_program_on_the_cpu():
    text = _run(flops, ["--device", "cpu", "--batch", "1", "--frames", "64"])
    assert "analytic/torch" in text


@pytest.mark.parametrize("name", TOOLS)
def test_cuda_without_a_card_exits_nonzero(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the refusal is for machines without one")
    module = importlib.import_module(
        f"speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.{name}")
    with pytest.raises(SystemExit) as e:
        module.main(["--device", "cuda"])
    assert e.value.code not in (0, None)


def test_attention_choice_sets_each_block():
    model = create_hybrid_vit(**TINY)
    blocks = [m for m in model.modules() if isinstance(m, MultiHeadSelfAttention)]
    assert blocks and not any(m.plain for m in blocks)
    bench_infer.use_attention(model, "xla")
    assert all(m.plain for m in blocks)
    bench_infer.use_attention(model, "pallas")
    assert not any(m.plain for m in blocks)


@pytest.mark.parametrize("name", TOOLS)
def test_the_no_jax_scan_covers_the_tool(name):
    """``tests/test_torch_no_jax.py`` scans every port source; each tool is
    among them and imports nothing of JAX."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import test_torch_no_jax as scan

    path = PORT / "tools" / f"{name}.py"
    assert path in scan.SOURCES
    assert not any(mod.split(".")[0] in scan.FORBIDDEN for mod in scan._imported_modules(path))
