"""The mesh through the port's CLIs on the CPU.

* ``cli.train --device cpu --data-parallel 2``, as JAX
  ``tests/test_multihost.py::test_two_process_cpu_train`` (which is
  slow-marked; this one is small enough for Tier-1): two gloo processes,
  started by one CLI (each rank one row of every global batch) or by two
  (the multi-host flags: each host its half of the files, in lockstep);
  both log the same global loss, rank 0 alone writes the metrics and the
  checkpoints, which read back. On one host the two ranks step the global
  batches that one process steps: their epoch losses are one process's
  within 1e-4, relative (one step's limit is 1e-5, PERF.md section 2; the
  8 AdamW steps at lr 1e-3 carry its reduction-order differences on:
  2.7e-5 measured).
* ``AudioEnhancer(mesh=...)`` with two replicas on the CPU against the JAX
  enhancer on a 2-device data mesh: float32 waveforms within 5e-5 (the port
  tests' enhancer limit), PCM16 in and out within 1 LSB, an odd batch (a pad
  row), exact mode and ``enhance_batch_async``.
* ``cli.enhance`` and ``cli.evaluate`` with ``--data-parallel 2`` on the CPU:
  their written PCM16 files within 1 LSB of the JAX mesh enhancer's.
* ``cli.serve --data-parallel 2 --fold-bn``: two folded replicas, and the
  dynamic batcher's answers through them equal to their direct ones.

A planted fault that splits the rows but returns them out of order fails the
enhancer and CLI cases; one where rank 1 also writes doubles the metrics
lines; ranks that each read their stride of the files on one host (each its
own batches, not its rows of the global one) fail the one-host train case.
"""

import json
import os
import re
import subprocess
import sys
import threading
import urllib.request
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.inference.enhancer import (
    AudioEnhancer as JAudioEnhancer,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.models import (
    HybridViT as JHybridViT,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.parallel import (
    make_mesh as j_make_mesh,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.utils.checkpoint import (
    load_model_weights as j_load_model_weights,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch import inference
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli import (
    enhance as enhance_cli,
    evaluate as evaluate_cli,
    serve as serve_cli,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import (
    load_audio,
    read_wav_bytes,
    save_wav,
    wav_bytes,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
    AudioEnhancer,
    make_server,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
    HybridViT,
    create_hybrid_vit,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.parallel import (
    mesh_for_data_parallel,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    load_model_weights,
    read_meta,
    save_checkpoint,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.config import (
    dump_yaml,
)
from test_torch_offline import TINY_CONFIG, _tone
from fixtures.make_tiny_denoiser import TINY

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = Path(__file__).parent / "fixtures" / "tiny_denoiser_mask"
SR = 16000
ATOL = 5e-5
LSB = 1.0 / 32767
BUCKETS = (64, 128)

TRAIN_CONFIG = {
    "model": {"encoder": {"channels": [4, 8, 16], "dropout": 0.0},
              "transformer": {"embed_dim": 32, "num_heads": 2, "num_layers": 1,
                              "mlp_ratio": 2, "dropout": 0.0, "attention_dropout": 0.0,
                              "drop_path_rate": 0.0},
              "decoder": {"channels": [16, 8, 4, 1], "dropout": 0.0}},
    "tpu": {"compute_dtype": "float32"},
    "data": {"train_val_split": 0.8, "augmentation": {"enabled": False},
             "bucketing": {"frame_buckets": [64]}},
    "training": {"seed": 0, "num_workers": 1, "batch_size": 2, "num_epochs": 2,
                 "use_amp": False, "optimizer": {"name": "adamw", "lr": 1e-3},
                 "early_stopping": {"enabled": False},
                 "checkpoint": {"save_every_n_epochs": 0},
                 "logging": {"use_tensorboard": False, "save_audio_samples": False}},
    "mesh": {"data_parallel": -1, "model_parallel": 1},
}


@pytest.mark.parametrize("hosts", [1, 2], ids=["one-host", "two-hosts"])
def test_train_cli_on_two_data_ranks(hosts, tmp_path):
    """``--data-parallel 2`` on one host (the CLI spawns both ranks), or as
    two hosts of one rank each (``--num-processes 2 --process-id i``, a
    ``file://`` rendezvous for ``--coordinator``)."""
    root = tmp_path / "vb"
    rng = np.random.default_rng(0)
    for i in range(10):  # all within the 64-frame bucket (8064 samples)
        n = int(SR * 0.4)
        clean = (0.4 * np.sin(2 * np.pi * (150 + 10 * i) * np.arange(n) / SR)).astype(np.float32)
        save_wav(root / "clean_trainset_28spk_wav" / f"p{i:03d}.wav", clean, SR)
        save_wav(root / "noisy_trainset_28spk_wav" / f"p{i:03d}.wav",
                 clean + 0.1 * rng.standard_normal(n).astype(np.float32), SR)
    (tmp_path / "config").mkdir()
    (tmp_path / "config" / "train_config.yaml").write_text(dump_yaml(TRAIN_CONFIG))
    # the one-process reference steps batches of 2 rows: PyTorch then takes
    # oneDNN's convolutions, whose sums follow the thread count and the
    # instruction set the host offers (a rank's one-row batches take the
    # im2col path, which does not); pinning both makes the reference the
    # same on every x86-64 host with AVX2
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               ATEN_CPU_CAPABILITY="avx2", ONEDNN_MAX_CPU_ISA="AVX2", MKL_CBWR="AVX2")
    def train_cmd(dp, out=""):
        return [sys.executable, "-m",
                "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.train",
                "--config-dir", str(tmp_path / "config"), "--data-root", str(root),
                "--device", "cpu", "--data-parallel", str(dp),
                "--checkpoint-dir", str(tmp_path / f"ck{out}"),
                "--log-dir", str(tmp_path / f"logs{out}")]

    cmd = train_cmd(2)
    if hosts > 1:
        (tmp_path / "rdv").mkdir()
        cmds = [cmd + ["--coordinator", f"file://{tmp_path / 'rdv' / 'store'}",
                       "--num-processes", "2", "--process-id", str(i)] for i in range(hosts)]
    else:
        cmds = [cmd]
    if hosts == 1:  # one process, for the losses
        cmds.append(train_cmd(1, out="1"))
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=tmp_path, env=env) for c in cmds]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
    out = "".join(outs)
    assert all(proc.returncode == 0 for proc in procs), out
    # one host: each rank one row of every global batch of 2 over the 8
    # train and 2 val files; two hosts: each its half of them, batches of 1
    for rank in (0, 1):
        want = ("train files: 8  val files: 2  rows {0}-{0} of each batch of 2" if hosts == 1
                else "train files: 4  val files: 1  rows 0-0 of each batch of 1").format(rank)
        assert f"rank {rank}: {want}" in out, out
    losses = dict(re.findall(r"rank (\d): done: best val loss ([0-9.]+)", out))
    assert set(losses) == {"0", "1"} and losses["0"] == losses["1"], out
    assert np.isfinite(float(losses["0"]))
    # rank 0 alone logged: one metrics file, one epoch line per epoch
    logs = list((tmp_path / "logs").rglob("metrics.jsonl"))
    assert len(logs) == 1
    assert logs[0].read_text().count('"epoch/val_total"') == 2
    if hosts == 1:
        def epochs(log):
            return np.array([[r["epoch/train_total"], r["epoch/val_total"]] for r in map(
                json.loads, log.read_text().splitlines()) if "epoch/val_total" in r])

        one = epochs(next((tmp_path / "logs1").rglob("metrics.jsonl")))
        np.testing.assert_allclose(epochs(logs[0]), one, rtol=1e-4, atol=0)
    for name in ("best_model", "final_model"):
        meta = read_meta(tmp_path / "ck" / name)
        model = load_model_weights(tmp_path / "ck" / name, create_hybrid_vit(meta["config"]))
        assert all(bool(torch.isfinite(t).all()) for t in model.state_dict().values()
                   if t.is_floating_point())


@pytest.fixture(scope="module")
def models():
    jm = JHybridViT(**TINY)
    template = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False),
                              jnp.zeros((1, 257, 64, 1), jnp.float32))
    return (jm, j_load_model_weights(FIXTURE, template),
            load_model_weights(FIXTURE, HybridViT(**TINY)))


def _jax_enhancer(models, **kw):
    jm, variables, _ = models
    return JAudioEnhancer(jm, variables, TINY_CONFIG,
                          mesh=j_make_mesh(data_parallel=2, devices=jax.devices()[:2]), **kw)


@pytest.mark.parametrize("io_dtype", ["float32", "int16"])
def test_enhancer_on_two_replicas_matches_jax_mesh(models, io_dtype):
    kw = dict(buckets=BUCKETS, mask_padding=True, io_dtype=io_dtype)
    ours = AudioEnhancer(models[2], TINY_CONFIG, device="cpu",
                         mesh=mesh_for_data_parallel(2, "cpu"), **kw)
    assert len(ours.replicas) == 2 and ours.replicas[0][1] is not ours.replicas[1][1]
    ref = _jax_enhancer(models, **kw)

    def close(a, b):
        assert a.shape == b.shape
        if io_dtype == "float32":
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
        else:  # PCM16 codes (the outputs are code / 32767)
            assert np.abs(np.rint(a * 32767) - np.rint(b * 32767)).max() <= 1

    wavs = [_tone(s, i, f0=150 + 30 * i) for i, s in enumerate((0.3, 0.8, 0.55))]  # a pad row
    for a, b in zip(ours.enhance_batch(wavs), ref.enhance_batch(wavs)):
        close(a, b)
    close(ours.enhance(wavs[1], exact=True), ref.enhance(wavs[1], exact=True))
    pending = ours.enhance_batch_async(wavs)
    rows = pending.result()
    assert rows.shape[0] == 3 and len(pending.hosts) == 2
    for w, row, b in zip(wavs, rows, ref.enhance_batch(wavs)):
        close(row[: len(w)], b)


def test_enhance_and_evaluate_clis_on_two_replicas_match_jax_mesh(models, tmp_path):
    ck = save_checkpoint(tmp_path / "ck", models[2], config=TINY_CONFIG)
    lengths = {}
    for i, sec in enumerate((0.4, 1.1, 0.7)):
        wav = _tone(sec, 20 + i, f0=180 + 15 * i)
        save_wav(tmp_path / "noisy" / f"f{i}.wav", wav, SR)
        save_wav(tmp_path / "clean" / f"f{i}.wav", _tone(sec, 40 + i, f0=180 + 15 * i), SR)
        lengths[f"f{i}.wav"] = len(wav)
    ref = _jax_enhancer(models)
    assert ref.enhance_directory(tmp_path / "noisy", tmp_path / "jax", batch_size=2) == 3
    common = ["--checkpoint", str(ck), "--device", "cpu", "--config-dir", str(tmp_path / "none"),
              "--data-parallel", "2", "--batch-size", "2"]
    assert enhance_cli.main(common + ["--input", str(tmp_path / "noisy"),
                                      "--output", str(tmp_path / "port")]) == 0
    assert evaluate_cli.main(common + ["--noisy-dir", str(tmp_path / "noisy"),
                                       "--clean-dir", str(tmp_path / "clean"), "--no-pesq",
                                       "--metric-workers", "0",
                                       "--save-enhanced", str(tmp_path / "eval"),
                                       "--output", str(tmp_path / "r.json")]) == 0
    for name, length in lengths.items():
        want = load_audio(tmp_path / "jax" / name, SR)[0]
        for out in ("port", "eval"):
            got = load_audio(tmp_path / out / name, SR)[0]
            assert len(got) == len(want) == length, (out, name)
            np.testing.assert_allclose(got, want, atol=LSB, rtol=0, err_msg=f"{out}/{name}")


def test_serve_cli_on_two_replicas(models, tmp_path, monkeypatch):
    ck = save_checkpoint(tmp_path / "ck", models[2], config=TINY_CONFIG)
    built = {}

    def fake_server(enhancer, *args, **kw):
        built["enhancer"] = enhancer
        raise KeyboardInterrupt  # stop before binding a port

    with monkeypatch.context() as m:
        m.setattr(inference, "make_server", fake_server)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(KeyboardInterrupt):
                serve_cli.main(["--checkpoint", str(ck), "--device", "cpu", "--config-dir",
                                str(tmp_path / "none"), "--data-parallel", "2", "--fold-bn"])
    enh = built["enhancer"]
    assert len(enh.replicas) == 2 and all(m.fold_bn for _, m, _ in enh.replicas)
    server = make_server(enh, port=0, max_batch=4, max_wait_ms=50.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = "http://%s:%d" % server.server_address[:2]
        wavs = [_tone(s, 60 + i) for i, s in enumerate((0.5, 0.9, 0.3))]
        for w in wavs:
            r = urllib.request.urlopen(urllib.request.Request(
                f"{url}/enhance", data=wav_bytes(w, SR, subtype="float32")), timeout=120)
            got = read_wav_bytes(r.read(), SR)[0]
            np.testing.assert_allclose(got, enh.enhance(w), atol=ATOL, rtol=0)
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
