"""PyTorch port's ``Evaluator`` and evaluate CLI (device cpu) against the
JAX package's, on a synthetic paired set and the committed
``tests/fixtures/tiny_denoiser_mask`` weights.

The set: 8 pairs of 0.5-2 s speech-like clips in coloured noise at -5 to
15 dB input SNR, and one of 3 s, longer than the largest bucket (2.04 s),
which goes through streaming.

Tolerances, port against JAX, per file and on the summary's means: the
enhanced waveforms agree within 5e-5 (the port's limit, float32 I/O), and
the metrics of such waveforms within 1e-4 dB for SI-SDR, SNR and segmental
SNR (measured <= 1.1e-5), 1e-5 for STOI and PESQ (measured <= 3.9e-7 and
3.7e-7), and 2e-2 for LSD, 0.2 dB for LSD in dB (measured <= 6.1e-3 and
5.3e-2: the log of near-empty spectral bins magnifies the waveforms'
differences). The metrics of the noisy input are exact: the same numpy
code on the same audio. Pool against serial scoring: exactly equal.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.evaluation import (
    Evaluator as JEvaluator,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.inference.enhancer import (
    AudioEnhancer as JAudioEnhancer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import (
    HybridViT as JHybridViT,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.utils.checkpoint import (
    load_model_weights as j_load_model_weights,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli import (
    evaluate as evaluate_cli,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import (
    load_audio,
    save_wav,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.evaluation import (
    Evaluator,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
    AudioEnhancer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import HybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    load_model_weights,
    read_meta,
    save_checkpoint,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from fixtures.make_tiny_denoiser import TINY, make_pairs  # noqa: E402

torch.set_num_threads(2)

SR = 16000
BUCKETS = (64, 128, 256)  # the largest holds 32640 samples (2.04 s)
FIXTURE = Path(__file__).parent / "fixtures" / "tiny_denoiser_mask"
SECONDS = (0.5, 0.7, 0.9, 1.1, 1.3, 1.5, 1.8, 2.0, 3.0)
TOL = {"si_sdr": 1e-4, "snr": 1e-4, "seg_snr": 1e-4, "stoi": 1e-5, "pesq": 1e-5,
       "lsd": 2e-2, "lsd_db": 0.2}
TINY_CONFIG = {"model": {"output_mode": "mask", "encoder": {"channels": [16, 32, 64]},
                         "transformer": {"embed_dim": 128, "num_heads": 4, "num_layers": 2,
                                         "mlp_ratio": 2.0, "pos_embed": "factored_2d"},
                         "decoder": {"channels": [32, 16, 1]}}}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("set")
    rng = np.random.default_rng(21)
    for i, sec in enumerate(SECONDS):
        clean, noisy = make_pairs(1, sec, rng, snr_lo=-5.0, snr_hi=15.0)
        save_wav(root / "clean" / f"c{i}.wav", clean[0], SR)
        save_wav(root / "noisy" / f"c{i}.wav", noisy[0], SR)
    return root / "noisy", root / "clean"


@pytest.fixture(scope="module")
def port_model():
    return load_model_weights(FIXTURE, HybridViT(**TINY))


@pytest.fixture(scope="module")
def enhancer(port_model):
    return AudioEnhancer(port_model, read_meta(FIXTURE)["config"], device="cpu",
                         buckets=BUCKETS, mask_padding=True)


@pytest.fixture(scope="module")
def both(dataset, enhancer, tmp_path_factory):
    """The port's and the JAX evaluator's results on the set (PESQ on,
    batch 3, enhanced WAVs written) and the port's output directory."""
    jm = JHybridViT(**TINY)
    template = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False),
                              jnp.zeros((1, 257, 64, 1), jnp.float32))
    je = JAudioEnhancer(jm, j_load_model_weights(FIXTURE, template), read_meta(FIXTURE)["config"],
                        buckets=BUCKETS, mask_padding=True)
    out_dir = tmp_path_factory.mktemp("enh")
    kw = dict(batch_size=3, progress=False, metric_workers=1)
    ours = Evaluator(enhancer, SR).evaluate_dataset(*dataset, output_dir=out_dir, **kw)
    ref = JEvaluator(je, SR).evaluate_dataset(*dataset, **kw)
    return ours, ref, out_dir


def _close(name, a, b):
    key = name[len("noisy_"):] if name.startswith("noisy_") else name.replace("_improvement", "")
    if name.startswith("noisy_"):
        return a == b
    return abs(a - b) <= TOL[key]


def test_per_file_and_summary_match_jax(both):
    ours, ref, _ = both
    assert ours["per_file"].keys() == ref["per_file"].keys() == {f"c{i}.wav" for i in
                                                                  range(len(SECONDS))}
    for name, row in ours["per_file"].items():
        assert row.keys() == ref["per_file"][name].keys()
        for k, v in row.items():
            assert np.isfinite(v) and _close(k, v, ref["per_file"][name][k]), (name, k)
    summary, ref_summary = ours["summary"], ref["summary"]
    for k, stats in ref_summary.items():
        if not k.startswith("_"):
            assert stats["count"] == summary[k]["count"] == len(SECONDS)
            assert _close(k, summary[k]["mean"], stats["mean"]), k
    assert summary["_by_input_snr"].keys() == ref_summary["_by_input_snr"].keys()
    meta = summary["_meta"]
    assert meta["num_files"] == len(SECONDS) and meta["pesq_impl"] == "native"
    assert meta["device"] == "cpu" and meta["audio_seconds_per_second"] > 0
    assert meta["audio_seconds"] == ref_summary["_meta"]["audio_seconds"]


def test_long_clip_streams_with_real_audio(both, dataset):
    """As JAX ``tests/test_long_clips.py::test_evaluator_handles_long_clips``."""
    ours, _, out_dir = both
    long_name = f"c{len(SECONDS) - 1}.wav"
    enh = load_audio(out_dir / long_name, SR)[0]
    assert len(enh) == len(load_audio(dataset[0] / long_name, SR)[0]) == int(3.0 * SR)
    assert np.abs(enh[-SR // 2:]).max() > 1e-4
    assert np.isfinite(ours["per_file"][long_name]["si_sdr"])


@pytest.mark.parametrize("exact", [False, True])
def test_pool_identical_to_serial_and_memory_bounded(dataset, enhancer, exact):
    """Serial and 2-worker scoring give the same rows (JAX
    ``tests/test_round5.py``); at most one window of files is loaded, and at
    most one window waits in the pool, in exact mode too (PESQ on, so the
    pool lags the enhancer)."""
    window_batches, batch_size = 1, 2
    with Evaluator(enhancer, SR) as ev:
        kw = dict(batch_size=batch_size, window_batches=window_batches, progress=False,
                  exact=exact)
        serial = ev.evaluate_dataset(*dataset, metric_workers=1, **kw)
        assert ev.last_peak_pending_metrics == 0
        pooled = ev.evaluate_dataset(*dataset, metric_workers=2, **kw)
        assert 1 <= ev.last_peak_pending_metrics <= window_batches * batch_size
        assert ev.last_peak_files_in_memory <= 2 * window_batches * batch_size
    assert ev._pool is None  # closed
    assert serial["per_file"] == pooled["per_file"]
    assert pooled["summary"]["_meta"]["metric_workers"] == 2.0


def test_evaluate_cli_end_to_end(dataset, port_model, tmp_path, monkeypatch, capsys):
    ck = save_checkpoint(tmp_path / "ck", port_model, config=TINY_CONFIG)
    args = ["--checkpoint", str(ck), "--device", "cpu", "--config-dir", str(tmp_path / "none"),
            "--noisy-dir", str(dataset[0]), "--clean-dir", str(dataset[1]), "--no-pesq",
            "--metric-workers", "0", "--batch-size", "4", "--max-files", "5",
            "--save-enhanced", str(tmp_path / "enh"), "--output", str(tmp_path / "r.json")]
    assert evaluate_cli.main(args) == 0
    results = json.loads((tmp_path / "r.json").read_text())
    assert len(results["per_file"]) == 5 and len(list((tmp_path / "enh").glob("*.wav"))) == 5
    assert results["summary"]["si_sdr"]["count"] == 5.0 and "pesq" not in results["summary"]
    assert "audio-s/s" in capsys.readouterr().out
    # --data-parallel 2: on the CPU two replicas score each file as one device
    # does (within the evaluator tests' SNR tolerance); on cuda it is refused
    # where fewer cards are visible
    assert evaluate_cli.main(args + ["--data-parallel", "2", "--output",
                                     str(tmp_path / "r2.json")]) == 0
    two = json.loads((tmp_path / "r2.json").read_text())
    assert set(two["per_file"]) == set(results["per_file"])
    for name, row in results["per_file"].items():
        assert abs(two["per_file"][name]["si_sdr"] - row["si_sdr"]) <= 1e-4
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(SystemExit, match="2 CUDA devices asked for, but 1 visible"):
            evaluate_cli.main(args[:2] + args[4:] + ["--data-parallel", "2"])
    assert "max(1, min(8, cpu_count - 2))" in " ".join(
        evaluate_cli.build_parser().format_help().split())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        evaluate_cli.main(args[:2] + args[4:])  # --device left at its default, cuda
