"""The port's training observability on the CPU, and the repo's shipped
config through the port's train CLI.

* ``MetricsLogger``: with ``use_tensorboard`` a ``torch.utils.tensorboard``
  writer gets every scalar (read back from its event file); without it, or
  where the package cannot be imported, ``tb`` is ``None`` and only
  ``metrics.jsonl`` is written. ``log_audio`` writes TensorBoard audio under
  its tag, and, when ``add_audio`` raises or there is no writer, a WAV
  ``<log_dir>/audio/step%08d_<tag>.wav`` (the JAX rule), equal to the
  samples within 2 PCM16 LSB (written at 32767 a unit, read at 32768).
* ``--profile-dir`` / ``Trainer(profile_dir=...)``: a Chrome trace whose
  ``train.step`` ranges (the recorder's spans in profiler mode) are exactly
  steps 1-5 of an 8-step epoch, each with its six children and its batch's
  ``train.h2d``; the recorder is off again afterwards.
* The shipped ``config/`` with its widths and depth cut but ``use_amp``,
  ``tpu.compute_dtype: bfloat16``, ``use_tensorboard`` and
  ``save_audio_samples`` kept trains one epoch through the CLI: bf16 input
  rounding, scalars and the validation clip's noisy and enhanced audio in
  TensorBoard, checkpoints.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.train import main
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import load_audio
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
    create_hybrid_vit,
    init_weights,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
    Trainer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.config import (
    load_all_configs,
    set_config_value,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils import tracing
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.logging import (
    MetricsLogger,
)
from test_torch_train_step import make_batch
from test_torch_trainer import _write_config, data_root, small_config  # noqa: F401

torch.set_num_threads(2)

SR = 16000
CONFIG = Path(__file__).resolve().parent.parent / "config"


def _events(log_dir: Path) -> EventAccumulator:
    acc = EventAccumulator(str(log_dir), size_guidance={"scalars": 0, "audio": 0})
    acc.Reload()
    return acc


def test_tensorboard_writer_gets_every_scalar(tmp_path):
    logger = MetricsLogger(tmp_path, "exp", use_tensorboard=True)
    assert logger.tb is not None
    logger.log_scalars(3, {"loss": 0.5, "lr": 1e-4}, prefix="epoch/")
    logger.close()
    tags = _events(tmp_path / "exp" / "tb").Tags()["scalars"]
    assert sorted(tags) == ["epoch/loss", "epoch/lr"]
    rec = json.loads((tmp_path / "exp" / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["epoch/loss"] == 0.5


def test_log_audio_tags_and_wav_fallback(tmp_path, monkeypatch, rng):
    audio = rng.uniform(-0.9, 0.9, 4000).astype(np.float32)
    logger = MetricsLogger(tmp_path, "exp", use_tensorboard=True)
    logger.log_audio(7, "audio/enhanced_0", audio, SR)
    assert not (tmp_path / "exp" / "audio").exists()

    def broken(*args, **kwargs):
        raise RuntimeError("no audio backend")

    monkeypatch.setattr(logger.tb, "add_audio", broken)
    logger.log_audio(7, "audio/noisy_1", audio, SR)
    logger.close()
    assert _events(tmp_path / "exp" / "tb").Tags()["audio"] == ["audio/enhanced_0"]
    wav = tmp_path / "exp" / "audio" / "step00000007_audio_noisy_1.wav"
    np.testing.assert_allclose(load_audio(wav, SR)[0], audio, atol=2.0 / 32767)


def test_no_writer_unless_asked_for_and_importable(tmp_path, monkeypatch, rng):
    assert MetricsLogger(tmp_path, "off", use_tensorboard=False).tb is None
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    logger = MetricsLogger(tmp_path, "absent", use_tensorboard=True)
    assert logger.tb is None
    logger.log_scalars(1, {"loss": 1.0})
    logger.log_audio(2, "audio/x", np.zeros(100, np.float32), SR)
    assert (tmp_path / "absent" / "audio" / "step00000002_audio_x.wav").exists()
    assert not (tmp_path / "absent" / "tb").exists()


def test_profile_dir_traces_steps_1_to_5(tmp_path, rng):
    config = small_config()
    model = init_weights(create_hybrid_vit(config), torch.Generator().manual_seed(0))
    batches = [make_batch(rng, True) for _ in range(8)]
    trainer = Trainer(model, config, batches, None, device="cpu",
                      checkpoint_dir=tmp_path / "ck", log_dir=tmp_path / "logs",
                      profile_dir=tmp_path / "prof")
    first = tracing.counters().get("train.steps", 0) + 1  # batch 0's step id
    tracing.clear()
    trainer.train_epoch(0)
    assert tracing.span("after") is tracing.NO_SPAN  # the recorder is off again
    traces = list((tmp_path / "prof").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = [e["name"] for e in events if str(e.get("name", "")).startswith("train.")]
    children = ("train.featurize", "train.forward", "train.backward", "train.norm",
                "train.sync", "train.optimizer")
    assert {n: names.count(n) for n in set(names)} == {
        n: 5 for n in ("train.step", "train.h2d") + children}
    steps = [s.id for s in tracing.spans() if s.name == "train.step"]
    assert steps == list(range(first + 1, first + 6))
    tracing.clear()
    trainer.train_epoch(1)  # later epochs are not traced
    assert list((tmp_path / "prof").glob("*.json")) == traces
    assert tracing.spans() == []


def test_shipped_config_trains_one_epoch(data_root, tmp_path, capsys):  # noqa: F811
    config = load_all_configs(CONFIG)
    assert config["training"]["use_amp"] and config["tpu"]["compute_dtype"] == "bfloat16"
    assert config["training"]["logging"]["use_tensorboard"]
    assert config["training"]["logging"]["save_audio_samples"]
    for key, value in (("training.batch_size", 2), ("training.num_workers", 1),
                       ("data.train_val_split", 0.84),
                       ("model.transformer.embed_dim", 64), ("model.transformer.num_heads", 4),
                       ("model.transformer.num_layers", 2),
                       ("model.encoder.channels", [16, 32, 64]),
                       ("model.decoder.channels", [32, 16, 8, 1])):
        set_config_value(config, key, value)
    cfg_dir = _write_config(tmp_path / "config", config)
    rc = main(["--config-dir", str(cfg_dir), "--data-root", str(data_root), "--device", "cpu",
               "--epochs", "1", "--checkpoint-dir", str(tmp_path / "ckpt"),
               "--log-dir", str(tmp_path / "logs"), "--profile-dir", str(tmp_path / "prof")])
    assert rc == 0
    assert "compute dtype: torch.bfloat16" in capsys.readouterr().out
    exp = tmp_path / "logs" / config["training"]["experiment_name"]
    tags = _events(exp / "tb").Tags()
    assert {"epoch/train_total", "epoch/val_total", "epoch/lr"} <= set(tags["scalars"])
    assert sorted(tags["audio"]) == ["audio/enhanced_0", "audio/noisy_0"]
    assert (exp / "metrics.jsonl").exists()
    assert (tmp_path / "ckpt" / "best_model" / "state.msgpack").exists()
    assert (tmp_path / "ckpt" / "final_model" / "state.msgpack").exists()
    assert list((tmp_path / "prof").glob("*.json"))  # 3 batches: steps 1-2 traced
