"""The port's entry points outside the serving and training CLIs, on the CPU:

- ``cli/synth_dataset.py`` writes the same files, byte for byte, as the
  repository's ``scripts/synth_dataset.py`` from the same seed;
- ``cli/demo.py --device cpu`` trains, enhances, scores and plots;
- ``graft_entry.entry()``'s bf16 module against the JAX hook's ``entry()``
  forward on the same weights and a seeded input, at the bf16 model's limit
  (1e-4, ``tests/test_torch_bf16.py``), at the flagship's full depth as both
  hooks build it (measured 6.4e-5 to 7.4e-5 over four input seeds; the same
  widths cut to 2 transformer layers measured 1.0e-4 to 1.1e-4, so the
  depth is not cut);
- ``python -m …graft_entry --device cpu --ranks 2``: the entry exported, then
  ``dryrun_multichip(2)`` over gloo (tensor-parallel over 2 ranks), its
  restored weights equal to the live ones.
"""

import filecmp
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch import graft_entry
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli import (
    synth_dataset,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import (
    load_audio,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    flax_to_state_dict,
)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import __graft_entry__ as jax_graft_entry  # noqa: E402

torch.set_num_threads(2)

PKG = "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch"
ATOL_BF16 = 1e-4  # the bf16 model's forward against JAX (test_torch_bf16.py)


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu", **extra)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    return env


def _run(args, cwd, timeout):
    proc = subprocess.run([sys.executable, *args], cwd=cwd, env=_env(), capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_synth_dataset_writes_the_scripts_files_byte_for_byte(tmp_path):
    args = ["--train", "3", "--test", "2", "--test-unseen", "1", "--seed", "3"]
    _run([str(ROOT / "scripts" / "synth_dataset.py"), str(tmp_path / "jax"), *args],
         cwd=tmp_path, timeout=300)
    assert synth_dataset.main([str(tmp_path / "port"), *args]) == 0
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len([f for f in files if f.suffix == ".wav"]) == 2 * (3 + 2 + 1)
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "port",
                                               [str(f) for f in files], shallow=False)
    assert mismatch == [] and errors == [] and len(match) == len(files)


def test_synth_dataset_runs_as_a_module(tmp_path):
    out = _run(["-m", f"{PKG}.cli.synth_dataset", str(tmp_path / "d"), "--train", "2",
                "--test", "1", "--seed", "1"], cwd=tmp_path, timeout=300)
    assert "wrote 2 train + 1 test" in out
    wav, sr = load_audio(tmp_path / "d" / "noisy_testset_wav" / "t000.wav", 16000)
    assert sr == 16000 and wav.dtype == np.float32 and 16000 <= len(wav) <= 48000


def test_demo_runs_on_the_cpu(tmp_path):
    out = _run(["-m", f"{PKG}.cli.demo", "--device", "cpu", "--epochs", "1", "--files", "8",
                "--outdir", str(tmp_path / "demo")], cwd=tmp_path, timeout=600)
    line = [s for s in out.splitlines() if s.startswith("[demo] SNR improvement:")]
    assert len(line) == 1, out
    assert np.isfinite(float(line[0].split(":")[1].split("dB")[0]))
    for name in ("noisy.wav", "enhanced.wav", "clean.wav", "loss.png", "comparison.png"):
        assert (tmp_path / "demo" / name).stat().st_size > 0, name
    assert "[demo] train loss:" in out


def test_graft_entry_matches_the_jax_hooks_forward(rng):
    fn, (variables, zeros) = jax_graft_entry.entry()
    module, (example,) = graft_entry.entry("cpu")
    assert example.shape == zeros.shape == (2, 257, 256, 1) and not example.any()
    assert module.compute_dtype == torch.bfloat16 and not module.training
    assert len(module.transformer.blocks) == 6
    module.load_state_dict(flax_to_state_dict(jax.device_get(variables)), strict=True)
    x = rng.random((2, 257, 256, 1)).astype(np.float32)
    ref = np.asarray(jax.jit(fn)(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = module(torch.from_numpy(x)).numpy()
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=ATOL_BF16, rtol=0)


def test_graft_entry_exports_and_dry_runs_two_ranks(tmp_path):
    out = _run(["-m", f"{PKG}.graft_entry", "--device", "cpu", "--ranks", "2"],
               cwd=tmp_path, timeout=600)
    lines = [s for s in out.splitlines() if s.startswith(("entry OK", "dryrun_multichip"))]
    assert lines[0] == "entry OK: (2, 257, 256, 1) torch.float32 (exported)"
    assert [s.split(" OK")[0] for s in lines[1:]] == [
        "dryrun_multichip train", "dryrun_multichip eval",
        "dryrun_multichip short-shard val", "dryrun_multichip ckpt-resume"]
    assert "mesh={'data': 1, 'model': 2}" in lines[1] and lines[-1].endswith("step=2")


def test_dryrun_refuses_more_cards_than_visible():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="0 CUDA devices visible"):
        graft_entry.dryrun_multichip(2)
