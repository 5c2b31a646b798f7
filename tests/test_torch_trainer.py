"""The port's epoch loop, checkpoints and training CLI on the CPU, at small
width, on synthetic WAV pairs written by the port's own codec.

Checkpoints: a round trip brings back the weights, BatchNorm statistics,
step, optimizer state and ``meta.json``'s JAX keys, and the JAX package's
``load_model_weights`` reads a port checkpoint to the same parameters.
Resume continues at the saved epoch + 1 with the saved state. The epoch
loop averages loss metrics over accepted steps only, keeps best / periodic /
final checkpoints, tracks the train loss without a validation loader and
stops early. The CLI trains one tiny epoch on the CPU and refuses a mesh it
cannot run (multi-process training itself: ``test_torch_mesh_cli.py``).
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import HybridViT as JHybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.utils.checkpoint import (
    load_model_weights as j_load_model_weights,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.train import main
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.dataset import (
    DataLoader,
    VoiceBankDataset,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import save_wav
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
    HybridViT,
    create_hybrid_vit,
    init_weights,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
    Optimizer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
    Trainer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    flax_to_state_dict,
    load_checkpoint,
    load_model_weights,
    read_meta,
    save_checkpoint,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.config import (
    dump_yaml,
    load_all_configs,
    set_config_value,
)
from test_torch_model import SMALL, _jax_template

torch.set_num_threads(2)

CONFIG = Path(__file__).resolve().parent.parent / "config"
SR = 16000


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vb")
    rng = np.random.default_rng(0)
    for i in range(6):
        length = int(rng.uniform(0.4, 0.9) * SR)
        clean = (0.4 * np.sin(np.arange(length) * rng.uniform(0.02, 0.08))).astype(np.float32)
        save_wav(root / "clean_trainset_28spk_wav" / f"p{i:03d}.wav", clean, SR)
        save_wav(root / "noisy_trainset_28spk_wav" / f"p{i:03d}.wav",
                 clean + 0.1 * rng.standard_normal(length).astype(np.float32), SR)
    return root


def small_config(**training):
    """The shipped config at small width, fp32, no TensorBoard."""
    config = load_all_configs(CONFIG)
    for key, value in (("training.use_amp", False), ("training.batch_size", 2),
                       ("training.num_workers", 1), ("training.num_epochs", 1),
                       ("training.logging.use_tensorboard", False),
                       ("training.logging.save_audio_samples", False),
                       ("data.train_val_split", 0.84),
                       ("model.transformer.embed_dim", 64), ("model.transformer.num_heads", 4),
                       ("model.transformer.num_layers", 2),
                       ("model.encoder.channels", [16, 32, 64]),
                       ("model.decoder.channels", [32, 16, 8, 1])):
        set_config_value(config, key, value)
    for key, value in training.items():
        set_config_value(config, f"training.{key}", value)
    return config


def make_trainer(config, data_root, tmp_path, val=True, **kw):
    loader = lambda split, shuffle: DataLoader(  # noqa: E731
        VoiceBankDataset(data_root, split, config), batch_size=2, shuffle=shuffle,
        num_workers=1, buckets=(64, 128))
    model = init_weights(create_hybrid_vit(config), torch.Generator().manual_seed(0))
    return Trainer(model, config, loader("train", True), loader("val", False) if val else None,
                   device="cpu", checkpoint_dir=tmp_path / "ckpt", log_dir=tmp_path / "logs", **kw)


def test_checkpoint_round_trip_and_jax_reader(tmp_path, rng):
    model = init_weights(HybridViT(**SMALL), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if "running" in name:
                buf.uniform_(0.5, 1.5)
    opt = Optimizer(list(model.parameters()), "adamw", lr=1e-3)
    opt.step([torch.randn_like(p) for p in model.parameters()])
    save_checkpoint(tmp_path / "ck", model, step=7, optimizer_state=opt.state_dict(), epoch=2,
                    global_step=7, best_val_loss=0.25, config={"model": {"head": "resize"}})

    fresh = HybridViT(**SMALL)
    step, opt_state, meta = load_checkpoint(tmp_path / "ck", fresh)
    assert step == 7
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[k], v), k
    other = Optimizer(list(fresh.parameters()), "adamw", lr=1.0)
    other.load_state_dict(opt_state)
    assert other.count == 1 and other.lr == 1e-3
    assert all(torch.equal(a, b) for a, b in zip(other.nu, opt.nu))
    assert {k: meta[k] for k in ("epoch", "global_step", "best_val_loss", "format")} == {
        "epoch": 2, "global_step": 7, "best_val_loss": 0.25, "format": "sevit-msgpack-v1"}
    assert meta["config"] == {"model": {"head": "resize"}}

    # the JAX package reads it to the same variables
    template = _jax_template(JHybridViT(**SMALL), np.zeros((1, 257, 32, 1), np.float32))
    variables = j_load_model_weights(tmp_path / "ck", template)
    sd = flax_to_state_dict(jax_tree_to_numpy(variables))
    own = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(sd) == set(own)
    for k, v in own.items():
        np.testing.assert_array_equal(np.asarray(sd[k]), v.numpy(), err_msg=k)


def jax_tree_to_numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def test_resume_restores_the_loop_position(data_root, tmp_path):
    config = small_config(num_epochs=1)
    first = make_trainer(config, data_root, tmp_path)
    first.train()
    assert (tmp_path / "ckpt" / "final_model" / "state.msgpack").exists()
    set_config_value(config, "training.num_epochs", 2)
    resumed = make_trainer(config, data_root, tmp_path / "r",
                           resume_from=tmp_path / "ckpt" / "final_model")
    assert resumed.current_epoch == 1 and resumed.step == first.step == 3
    assert resumed.best_val_loss == first.best_val_loss
    assert resumed.optimizer.count == first.optimizer.count
    for a, b in zip(resumed.optimizer.mu, first.optimizer.mu):
        assert torch.equal(a, b)
    for k, v in first.model.state_dict().items():  # (flax keeps no batch count)
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(resumed.model.state_dict()[k], v), k
    history = resumed.train()  # epoch 1 only
    assert len(history["train_loss"]) == 1 and resumed.step == 6


def test_epoch_averages_over_accepted_steps(data_root, tmp_path):
    trainer = make_trainer(small_config(), data_root, tmp_path, val=False)
    step, seen = trainer.train_step, []

    def poisoned(batch):
        if len(seen) == 1:
            batch = dict(batch, noisy_audio=batch["noisy_audio"].clone())
            batch["noisy_audio"][0, 10] = float("nan")
        metrics = step(batch)
        seen.append({k: float(v) for k, v in metrics.items()})
        return metrics

    trainer.train_step = poisoned
    metrics = trainer.train_epoch(0)
    assert [m["nonfinite_skipped"] for m in seen] == [0.0, 1.0, 0.0]
    assert metrics["nonfinite_skipped"] == pytest.approx(1 / 3)
    assert metrics["total"] == pytest.approx((seen[0]["total"] + seen[2]["total"]) / 2)


def test_best_on_train_loss_and_early_stopping(data_root, tmp_path, capsys):
    config = small_config(num_epochs=5)
    set_config_value(config, "training.early_stopping.patience", 2)
    set_config_value(config, "training.checkpoint.save_every_n_epochs", 2)
    trainer = make_trainer(config, data_root, tmp_path, val=False)
    losses = iter([1.0, 0.5, 0.6, 0.7, 0.1])
    trainer.train_epoch = lambda epoch: {"total": next(losses), "nonfinite_skipped": 0.0}
    history = trainer.train()
    assert history["train_loss"] == [1.0, 0.5, 0.6, 0.7]  # stopped after 2 epochs without gain
    assert trainer.best_val_loss == 0.5 and trainer.current_epoch == 4
    assert "best_model will track the training loss" in capsys.readouterr().out
    ckpt = tmp_path / "ckpt"
    assert read_meta(ckpt / "best_model")["epoch"] == 1
    assert read_meta(ckpt / "final_model")["epoch"] == 3
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "best_model", "checkpoint_epoch_2", "checkpoint_epoch_4", "final_model"]
    log = [json.loads(line) for line in (tmp_path / "logs").rglob("metrics.jsonl").__next__()
           .read_text().splitlines()]
    assert [r["epoch/lr"] for r in log if "epoch/lr" in r][0] == pytest.approx(
        1e-6 + 0.5 * (1e-4 - 1e-6) * (1 + math.cos(math.pi / 5)))


def _write_config(path: Path, config) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    (path / "train_config.yaml").write_text(dump_yaml(config))
    return path


def test_cli_trains_one_epoch_on_cpu(data_root, tmp_path):
    cfg_dir = _write_config(tmp_path / "config", small_config())
    rc = main(["--config-dir", str(cfg_dir), "--data-root", str(data_root), "--device", "cpu",
               "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "logs"),
               "--mask-padding", "--output-mode", "mask", "--head", "fullres_mask",
               "--pos-embed", "factored_2d", "--log-l1-weight", "0.05"])
    assert rc == 0
    for name in ("best_model", "final_model"):
        path = tmp_path / "ckpt" / name
        meta = read_meta(path)
        assert meta["config"]["model"]["head"] == "fullres_mask"
        assert meta["config"]["training"]["loss"]["log_l1_weight"] == 0.05
        model = load_model_weights(path, create_hybrid_vit(meta["config"]))
        assert all(bool(torch.isfinite(t).all()) for t in model.state_dict().values()
                   if t.is_floating_point())
    assert next((tmp_path / "logs").rglob("metrics.jsonl")).read_text().count("epoch/") >= 1


@pytest.mark.parametrize("args,match", [
    (["--model-parallel", "3"], r"num_heads \(4\) must be divisible by model_parallel \(3\)"),
    (["--data-parallel", "2", "--batch-size", "3"],
     r"batch_size \(3\) must be divisible by the data-parallel axis \(2"),
    (["--num-processes", "2"], "needs --coordinator host:port and --process-id"),
    (["--process-id", "1"], "needs --num-processes above it"),
    (["--device", "cuda", "--data-parallel", "2"],
     "needs 2 CUDA devices on this host, but 1 visible")])
def test_cli_refuses_what_is_not_ported(args, match, data_root, tmp_path, monkeypatch):
    """The mesh the CLI refuses before starting a process: heads the model
    axis does not divide (tensor parallelism splits whole heads, a limit of
    the port), a batch the data axis does not divide (as the JAX CLI), and
    several hosts without a rendezvous, or a host index without hosts; and
    on cuda more cards than are visible (one, here), naming both counts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    config = small_config()
    cfg_dir = _write_config(tmp_path / "config", config)
    with pytest.raises(SystemExit, match=match):
        main(["--config-dir", str(cfg_dir), "--data-root", str(data_root), "--device", "cpu",
              *args])
