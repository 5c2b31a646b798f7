"""The port's quality tools (``…_torch/tools/``, device cpu) against the
JAX package's ``benchmarks/`` scripts, run unchanged in this process as
``tests/test_round5.py`` runs ``oracle_heads``: imported from
``benchmarks/`` with ``sys.argv`` swapped and restored. The JAX
``tune_blend`` would turn on the persistent compilation cache under ``HOME``;
the test makes that call a no-op, and leaves its ``--device`` unset (the
process keeps the CPU platform it has).

Data: 4 synthetic pairs of 1-1.5 s from the port's ``cli.synth_dataset``
(speech-like clips in coloured noise at 0 to 10 dB, from its numpy seed,
written as PCM16 by the port's ``save_wav``); the committed
``tests/fixtures/tiny_denoiser`` weights, copied with a ``config.model``
that builds their architecture through both packages' ``create_hybrid_vit``
(the fixture's own ``meta.json`` holds it under ``config.tiny``).

Tolerances, port against JAX:
- ``oracle_heads``: each file's five gains within 1e-3 dB, the rounding step
  of the per-file numbers both tools print (3 decimals; two values closer
  than that may still round one step apart, so 1e-9 more for the decimal
  representation), and each head's unrounded mean within 1e-4 dB. Both are
  float32 STFTs and iSTFTs of the same audio, whose SI-SDRs agree to ~1e-5
  dB.
- ``tune_blend``: ``input_si_sdr`` exactly (the same numpy metric on the
  same decoded audio); ``est_snr``, a ratio of two float32 sums over 257 x N
  bins taken in another order, within 1e-3 dB; each of the 11 blends' gains,
  a waveform through two transformer blocks within the port's 5e-5
  waveform limit, within 1e-2 dB; the fitted parameters equal and their
  mean within 1e-2 dB; the fit is strict (a larger mean wins), so the
  runner-up's mean must lie more than 1e-2 dB below the best, or a rounding
  could choose it.
- ``bench_mask_delta.measure`` on the JAX tool's own weights (``PRNGKey(0)``,
  carried across with ``flax_to_state_dict``): the exact, unmasked and
  masked waveforms each within 5e-5 of the JAX output's peak (random weights
  put the outputs far above full scale, so an absolute 5e-5 would mean
  nothing); the relative RMS deltas within 1e-4; the max LSB deltas within
  twice the waveform limit in LSB (each side of the difference may carry it).
- ``calibrate_pesq.sweep``: exactly equal (copies of the same numpy code).
"""

import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import speech_enhancement_via_hybrid_vision_transformer_project_tpu.inference as j_inference
import speech_enhancement_via_hybrid_vision_transformer_project_tpu.utils as j_utils
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli import (
    evaluate as evaluate_cli,
    synth_dataset,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.evaluation import (
    pesq_native,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
    AudioEnhancer,
    load_model_for_inference,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools import (
    bench_mask_delta,
    calibrate_pesq,
    oracle_heads,
    tune_blend,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    flax_to_state_dict,
    read_meta,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
BENCHMARKS = ROOT / "benchmarks"
FIXTURE = Path(__file__).parent / "fixtures" / "tiny_denoiser"
SR = 16000
N_PAIRS = 4
TOL_ORACLE = 1e-3 + 1e-9
TOL_ORACLE_MEAN = 1e-4
TOL_EST_SNR = 1e-3
TOL_GAIN = 1e-2
TOL_WAVE_PEAK = 5e-5
TOL_REL_RMS = 1e-4
# the tiny fixture's architecture (tests/fixtures/make_tiny_denoiser.py TINY)
# as a config.model: a magnitude head, the decoder's three layers take the
# first three of HybridViT's default kernel sizes and upsample factors
TINY_MODEL = {"encoder": {"channels": [16, 32, 64], "dropout": 0.0},
              "transformer": {"embed_dim": 128, "num_heads": 4, "num_layers": 2,
                              "mlp_ratio": 2.0, "pos_embed": "factored_2d",
                              "attention_dropout": 0.0, "drop_path_rate": 0.0},
              "decoder": {"channels": [32, 16, 1]}}
TOOLS = "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools"


def jax_tool(name: str):
    if str(BENCHMARKS) not in sys.path:
        sys.path.insert(0, str(BENCHMARKS))
    return importlib.import_module(name)


def run_jax_main(module, argv: list) -> None:
    saved = sys.argv
    sys.argv = [module.__name__, *argv]
    try:
        assert module.main() == 0
    finally:
        sys.argv = saved


def tiny_checkpoint(path: Path) -> Path:
    """A copy of the fixture whose ``meta.json`` builds its architecture."""
    shutil.copytree(FIXTURE, path)
    meta = json.loads((path / "meta.json").read_text())
    meta["config"]["model"] = TINY_MODEL
    (path / "meta.json").write_text(json.dumps(meta, indent=1))
    return path


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """``cli.synth_dataset``'s test split at its default seed and SNRs (0 to
    10 dB), 4 pairs of 1-1.5 s."""
    root = tmp_path_factory.mktemp("pairs")
    assert synth_dataset.main([str(root), "--train", "0", "--test", str(N_PAIRS),
                               "--min-seconds", "1.0", "--max-seconds", "1.5"]) == 0
    return root / "noisy_testset_wav", root / "clean_testset_wav"


# ---------------------------------------------------------------------------
# oracle_heads
# ---------------------------------------------------------------------------


def test_oracle_heads_matches_jax(pairs, tmp_path):
    noisy, clean = pairs
    run_jax_main(jax_tool("oracle_heads"), ["--noisy-dir", str(noisy), "--clean-dir", str(clean),
                                            "--out", str(tmp_path / "jax.json")])
    assert oracle_heads.main(["--noisy-dir", str(noisy), "--clean-dir", str(clean), "--out",
                              str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    ref = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got.keys() == ref.keys()
    assert got["n"] == ref["n"] == N_PAIRS
    assert [r["file"] for r in got["per_file"]] == [r["file"] for r in ref["per_file"]]
    assert got["mean_input_si_sdr"] == ref["mean_input_si_sdr"]
    for row, ref_row in zip(got["per_file"], ref["per_file"]):
        assert row["input_si_sdr"] == ref_row["input_si_sdr"]
        for head in oracle_heads.HEADS:
            assert abs(row[head] - ref_row[head]) <= TOL_ORACLE, (row["file"], head)
    for head in oracle_heads.HEADS:
        for stat in ("mean", "median"):
            key = f"{head}_gain_{stat}"
            assert np.isfinite(got[key]) and abs(got[key] - ref[key]) <= TOL_ORACLE_MEAN, key


# ---------------------------------------------------------------------------
# tune_blend
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def blend_runs(pairs, tmp_path_factory, monkeypatch_module):
    """The JAX tool's and the port's ``--json-out`` on the tiny denoiser,
    each on its own copy; the port's run also writes the fit into its
    copy's ``meta.json``."""
    noisy, clean = pairs
    tmp = tmp_path_factory.mktemp("blend")
    monkeypatch_module.setattr(j_utils, "enable_compilation_cache", lambda *a, **k: "")
    common = ["--config-dir", str(ROOT / "config"), "--noisy-dir", str(noisy),
              "--clean-dir", str(clean)]
    run_jax_main(jax_tool("tune_blend"), ["--checkpoint", str(tiny_checkpoint(tmp / "jax_ck")),
                                          *common, "--json-out", str(tmp / "jax.json")])
    port_ck = tiny_checkpoint(tmp / "port_ck")
    assert tune_blend.main(["--checkpoint", str(port_ck), *common, "--device", "cpu",
                            "--json-out", str(tmp / "port.json"),
                            "--write-checkpoint-meta"]) == 0
    return (json.loads((tmp / "jax.json").read_text()),
            json.loads((tmp / "port.json").read_text()), port_ck)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_tune_blend_rows_match_jax(blend_runs):
    ref, got, _ = blend_runs
    assert got.keys() == ref.keys()
    assert got["output_mode"] == ref["output_mode"] == "magnitude"
    assert got["alphas"] == ref["alphas"]
    assert [r["file"] for r in got["rows"]] == [r["file"] for r in ref["rows"]]
    assert len(got["rows"]) == N_PAIRS
    for row, ref_row in zip(got["rows"], ref["rows"]):
        assert row["input_si_sdr"] == ref_row["input_si_sdr"]
        assert abs(row["est_snr"] - ref_row["est_snr"]) <= TOL_EST_SNR, row["file"]
        assert len(row["gains"]) == 11
        np.testing.assert_allclose(row["gains"], ref_row["gains"], rtol=0, atol=TOL_GAIN)


def test_tune_blend_fit_matches_jax(blend_runs):
    ref, got, _ = blend_runs
    assert got["no_blend"]["bins"].keys() == ref["no_blend"]["bins"].keys()
    assert abs(got["no_blend"]["mean"] - ref["no_blend"]["mean"]) <= TOL_GAIN
    assert ref["best"] is not None and got["best"] is not None
    assert got["best"]["params"] == ref["best"]["params"]
    assert abs(got["best"]["mean"] - ref["best"]["mean"]) <= TOL_GAIN
    assert got["best"]["bins"].keys() == ref["best"]["bins"].keys()
    # no near-tie: the runner-up lies further below the best than the gains'
    # tolerance, on either package's rows
    for rows in (ref["rows"], got["rows"]):
        means = sorted((m for m, _, _, ok in tune_blend.grid(rows) if ok), reverse=True)
        assert means[0] - means[1] > TOL_GAIN, means[:2]


def test_tune_blend_writes_the_fit_that_the_enhancer_adopts(blend_runs):
    """The enhancer built on the written ``meta.json``'s config adopts the
    fit (``load_model_for_inference`` carries only the model, audio and
    spectrogram sections into its merged config, in both packages)."""
    _, got, port_ck = blend_runs
    blend = json.loads((port_ck / "meta.json").read_text())["config"]["inference"]["blend"]
    params = got["best"]["params"]
    assert blend["mode"] == "snr_adaptive" and blend["fitted_mean_gain_db"] == got["best"]["mean"]
    enhancer = AudioEnhancer(load_model_for_inference(port_ck, {}, device="cpu")[0],
                             read_meta(port_ck)["config"], device="cpu", blend=None)
    assert enhancer.blend == "snr_adaptive"
    assert (enhancer.blend_min, enhancer.blend_pivot_db, enhancer.blend_width_db) == (
        params["min"], params["pivot"], params["width"])


def hand_built_rows(slope: float) -> list:
    """One row in each input-SNR bin, each with gains that peak where the
    sigmoid (pivot 12, width 4, min 0.2) puts that row's blend and fall by
    ``slope`` dB per unit of blend on either side."""
    rows = []
    for est, inp in zip((2.0, 9.0, 12.0, 15.0, 22.0, 30.0), (-7.0, -2.0, 3.0, 8.0, 13.0, 18.0)):
        peak = 0.2 + 0.8 / (1 + np.exp(-(12.0 - est) / 4.0))
        rows.append({"input_si_sdr": inp, "est_snr": est,
                     "gains": [float(g) for g in 1.0 - slope * np.abs(tune_blend.ALPHAS - peak)]})
    return rows


@pytest.mark.parametrize("slope,feasible", [(20.0, 1), (40.0, 0)])
def test_fit_blend_on_hand_built_rows(slope, feasible, tmp_path):
    """Exactly one grid point keeps every bin at or above -0.1 dB (slope 20),
    or none does (slope 40): the fit returns it, or None, and the meta write
    makes an ``AudioEnhancer`` adopt it."""
    rows = hand_built_rows(slope)
    points = [p for _, _, p, ok in tune_blend.grid(rows) if ok]
    assert len(points) == feasible
    fit = tune_blend.fit_blend(rows)
    assert sorted(fit["no_blend"]["bins"]) == [0, 1, 2, 3, 4, 5]
    if not feasible:
        assert fit["best"] is None
        return
    assert fit["best"]["params"] == points[0] == {"pivot": 12.0, "width": 4.0, "min": 0.2}
    ck = tiny_checkpoint(tmp_path / "ck")
    tune_blend.write_checkpoint_blend(ck, fit["best"], "hand-built rows")
    enhancer = AudioEnhancer(load_model_for_inference(ck, {}, device="cpu")[0],
                             read_meta(ck)["config"], device="cpu", blend=None)
    assert (enhancer.blend, enhancer.blend_min, enhancer.blend_pivot_db,
            enhancer.blend_width_db) == ("snr_adaptive", 0.2, 12.0, 4.0)


# ---------------------------------------------------------------------------
# bench_mask_delta
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mask_delta(monkeypatch_module):
    """The JAX tool's printed report, every waveform its enhancers returned
    and its model's variables (from the tool's own ``PRNGKey(0)``)."""
    import contextlib
    import io

    tool = jax_tool("bench_mask_delta")
    calls = []
    enhance = j_inference.AudioEnhancer.enhance

    def recorded(self, *a, **k):
        out = enhance(self, *a, **k)
        calls.append((self, np.asarray(out)))
        return out

    monkeypatch_module.setattr(j_inference.AudioEnhancer, "enhance", recorded)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_jax_main(tool, [])
    monkeypatch_module.setattr(j_inference.AudioEnhancer, "enhance", enhance)
    report = json.loads(buf.getvalue())
    waves = [tuple(out for _, out in calls[i:i + 3]) for i in range(0, len(calls), 3)]
    return report, waves, calls[0][0].variables


def test_bench_mask_delta_matches_jax(mask_delta):
    """The two smallest buckets (128 and 256 frames): the JAX tool's first
    two clips, which ``measure`` draws from the same seed."""
    report, ref_waves, variables = mask_delta
    model = bench_mask_delta.build_model(False, "learned_1d")
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    lengths = [f * 128 for f in bench_mask_delta.LENGTH_FRAMES[:2]]
    waves = []
    got = bench_mask_delta.measure(model, {}, "cpu", lengths, 0, waveforms=waves)
    assert [c["samples"] for c in got["clips"]] == [c["samples"] for c in report["clips"][:2]]
    assert got["lsb"] == report["lsb"]
    for clip, ref_clip, outs, ref_outs in zip(got["clips"], report["clips"], waves, ref_waves):
        peak = max(float(np.abs(r).max()) for r in ref_outs)
        for out, ref in zip(outs, ref_outs):
            assert out.shape == ref.shape == (clip["samples"],)
            assert float(np.abs(out - ref).max()) <= TOL_WAVE_PEAK * peak
        for mode in ("unmasked", "masked"):
            assert abs(clip[f"{mode}_rel_rms"] - ref_clip[f"{mode}_rel_rms"]) <= TOL_REL_RMS
            assert (abs(clip[f"{mode}_max_lsb"] - ref_clip[f"{mode}_max_lsb"])
                    <= 2 * TOL_WAVE_PEAK * peak * 32768.0)
    assert set(got["worst_max_lsb"]) == set(report["worst_max_lsb"]) == {"unmasked", "masked"}


# ---------------------------------------------------------------------------
# calibrate_pesq
# ---------------------------------------------------------------------------


def test_calibrate_pesq_sweep_equals_jax():
    ref = jax_tool("calibrate_pesq").sweep(1, 1.0, fit_only=True)
    got = calibrate_pesq.sweep(1, 1.0, fit_only=True)
    assert got == ref
    assert set(got["white"]) == set(calibrate_pesq.ANCHORS_WHITE) and got["pink"]


def test_calibrate_pesq_sweep_restores_the_constant():
    before = pesq_native._D_CAL
    at_9 = calibrate_pesq.sweep(1, 1.0, d_cal=9.0, fit_only=True)
    assert pesq_native._D_CAL == before
    assert at_9 != calibrate_pesq.sweep(1, 1.0, fit_only=True)  # 9.0 took effect


# ---------------------------------------------------------------------------
# protocol_report, the CLIs
# ---------------------------------------------------------------------------


def test_protocol_report_reads_the_port_outputs(tmp_path):
    """``benchmarks/protocol_report.py``, unchanged, joins the port evaluate
    CLI's ``--output`` with ``cli.synth_dataset``'s manifest."""
    data = tmp_path / "data"
    assert synth_dataset.main([str(data), "--train", "0", "--test", "3", "--test-unseen", "2",
                               "--max-seconds", "1.5"]) == 0
    assert evaluate_cli.main([
        "--checkpoint", str(tiny_checkpoint(tmp_path / "ck")), "--device", "cpu",
        "--config-dir", str(ROOT / "config"), "--noisy-dir", str(data / "noisy_testset_wav"),
        "--clean-dir", str(data / "clean_testset_wav"), "--output", str(tmp_path / "eval.json"),
        "--no-pesq", "--metric-workers", "0"]) == 0
    proc = subprocess.run(
        [sys.executable, str(BENCHMARKS / "protocol_report.py"), "--eval",
         str(tmp_path / "eval.json"), "--manifest", str(data / "manifest.json"), "--out",
         str(tmp_path / "report.json")], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads((tmp_path / "report.json").read_text())
    assert (report["pooled"]["n"], report["seen_families"]["n"],
            report["unseen_family"]["n"]) == (5, 3, 2)
    assert report["unseen_family"]["by_family"].keys() == {"impulsive"}
    assert np.isfinite(report["pooled"]["mean"])


@pytest.mark.parametrize("tool,argv", [
    (oracle_heads, ["--noisy-dir", "n", "--clean-dir", "c"]),
    (tune_blend, ["--checkpoint", "ck", "--noisy-dir", "n", "--clean-dir", "c"]),
    (bench_mask_delta, []),
], ids=["oracle_heads", "tune_blend", "bench_mask_delta"])
def test_cuda_is_refused_without_a_card(tool, argv, monkeypatch):
    """``--device cuda`` (the default) without a card exits with
    ``use_device``'s message; nothing runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(argv)


@pytest.mark.parametrize("name", ["oracle_heads", "tune_blend", "bench_mask_delta",
                                  "calibrate_pesq"])
def test_tool_runs_as_a_module(name):
    proc = subprocess.run([sys.executable, "-m", f"{TOOLS}.{name}", "--help"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("usage:")
    if name != "calibrate_pesq":
        assert "--device {cuda,cpu}" in proc.stdout
