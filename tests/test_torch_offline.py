"""PyTorch port's offline enhancement path (device cpu) against the JAX
package: ``wav_info``, ``enhance_batch_async``, ``enhance_directory``, the
module-level ``enhance_audio``/``enhance_file`` and the enhance CLI, on the
committed ``tests/fixtures/tiny_denoiser_mask`` weights.

Tolerances: ``wav_info`` and the async path against the blocking one are
exact (header integers; the same computation). A row enhanced alone
against the same row in a batch: 1e-6 absolute, fp32 convolutions of
another batch size blocked differently by the CPU's kernels (measured
<= 1.2e-7). Against the JAX package: 5e-5 absolute, the port's
enhanced-waveform limit with float32 I/O (PERF.md section 2), which also
covers a PCM16 sample of the written files rounding the other way
(1 LSB = 3.05e-5).
"""

import json
import struct
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.data.wavio import (
    wav_info as j_wav_info,
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
    enhance as enhance_cli,
    serve as serve_cli,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import (
    load_audio,
    save_wav,
    wav_bytes,
    wav_info,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
    AudioEnhancer,
    enhance_audio,
    enhance_file,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import HybridViT
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    load_model_weights,
    read_meta,
    save_checkpoint,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from fixtures.make_tiny_denoiser import TINY  # noqa: E402

torch.set_num_threads(2)

SR = 16000
ATOL = 5e-5
BUCKETS = (64, 128)  # the largest holds 16256 samples (1.02 s)
FIXTURES = Path(__file__).parent / "fixtures"
# TINY as a config that create_hybrid_vit reads from a checkpoint's meta.json
TINY_CONFIG = {"model": {"output_mode": "mask", "encoder": {"channels": [16, 32, 64]},
                         "transformer": {"embed_dim": 128, "num_heads": 4, "num_layers": 2,
                                         "mlp_ratio": 2.0, "pos_embed": "factored_2d"},
                         "decoder": {"channels": [32, 16, 1]}}}


def _tone(seconds, seed, f0=220.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    return (0.4 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal(len(t))).astype(
        np.float32)


@pytest.fixture(scope="module")
def port_model():
    return load_model_weights(FIXTURES / "tiny_denoiser_mask", HybridViT(**TINY))


@pytest.fixture(scope="module")
def enhancer(port_model):
    cfg = read_meta(FIXTURES / "tiny_denoiser_mask")["config"]
    return AudioEnhancer(port_model, cfg, device="cpu", buckets=BUCKETS, mask_padding=True)


@pytest.fixture(scope="module")
def checkpoint(port_model, tmp_path_factory):
    """The mask fixture's weights with a meta.json config the CLIs read."""
    return save_checkpoint(tmp_path_factory.mktemp("ck") / "tiny", port_model,
                           config=TINY_CONFIG)


# ---------------------------------------------------------------------------
# wav_info
# ---------------------------------------------------------------------------


def _chunk(cid: bytes, body: bytes) -> bytes:
    return cid + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def _extra_chunk_wav(n_frames: int, n_ch: int) -> bytes:
    """PCM16 WAV with an odd-sized LIST chunk before an 18-byte fmt chunk,
    a fact chunk before the data and an id3 chunk after it."""
    payload = np.zeros(n_frames * n_ch, "<i2").tobytes()
    fmt = struct.pack("<HHIIHHH", 1, n_ch, 22050, 22050 * 2 * n_ch, 2 * n_ch, 16, 0)
    body = (b"WAVE" + _chunk(b"LIST", b"INFOx") + _chunk(b"fmt ", fmt)
            + _chunk(b"fact", struct.pack("<I", n_frames)) + _chunk(b"data", payload)
            + _chunk(b"id3 ", b"abc"))
    return b"RIFF" + struct.pack("<I", len(body)) + body


def test_wav_info_matches_jax(tmp_path):
    wav = _tone(1.3, 5)
    cases = {
        "pcm16.wav": wav_bytes(wav, SR),
        "float32.wav": wav_bytes(wav, SR, subtype="float32"),
        "stereo_float32.wav": wav_bytes(np.stack([wav, -wav], 1), 8000, subtype="float32"),
        "extra_chunks.wav": _extra_chunk_wav(1234, 2),
    }
    want = {"pcm16.wav": (len(wav), SR, 1), "float32.wav": (len(wav), SR, 1),
            "stereo_float32.wav": (len(wav), 8000, 2), "extra_chunks.wav": (1234, 22050, 2)}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        assert wav_info(tmp_path / name) == j_wav_info(tmp_path / name) == want[name], name
    assert wav_info(tmp_path / "pcm16.wav")[0] == len(load_audio(tmp_path / "pcm16.wav", SR)[0])
    (tmp_path / "bad.wav").write_bytes(b"RIFX" + bytes(40))
    with pytest.raises(ValueError, match="not a RIFF"):
        wav_info(tmp_path / "bad.wav")


# ---------------------------------------------------------------------------
# enhance_batch_async
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("io_dtype", ["float32", "int16"])
def test_enhance_batch_async_equals_enhance_batch(port_model, io_dtype):
    cfg = read_meta(FIXTURES / "tiny_denoiser_mask")["config"]
    te = AudioEnhancer(port_model, cfg, device="cpu", buckets=BUCKETS, mask_padding=True,
                       io_dtype=io_dtype)
    wavs = [_tone(s, i) for i, s in enumerate((0.6, 0.3, 0.95))]
    pending = te.enhance_batch_async(wavs)
    out = pending.result()
    assert out.dtype == np.float32 and out.shape == (3, te._padded_len(len(wavs[2])))
    for row, ref in zip(out, te.enhance_batch(wavs)):
        np.testing.assert_array_equal(row[: len(ref)], ref)


def test_enhance_batch_async_rejects_long_clips(enhancer):
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        enhancer.enhance_batch_async([_tone(0.5, 0), _tone(1.1, 1)])


def test_rows_do_not_depend_on_the_batch(enhancer):
    """A clip alone and in a batch padded to the same bucket, beside a
    silent clip, one of 1 sample and a loud one, comes out the same."""
    clip = _tone(0.7, 3)
    others = [np.zeros(SR // 2, np.float32), np.full(1, 0.3, np.float32),
              3.0 * _tone(0.9, 4, f0=500.0)]
    assert enhancer._padded_len(max(map(len, others))) == enhancer._padded_len(len(clip))
    alone = enhancer.enhance_batch_async([clip]).result()[0]
    for pos in range(len(others) + 1):
        batch = others[:pos] + [clip] + others[pos:]
        row = enhancer.enhance_batch_async(batch).result()[pos]
        assert float(np.abs(row - alone).max()) < 1e-6


# ---------------------------------------------------------------------------
# enhance_directory, enhance_audio, enhance_file
# ---------------------------------------------------------------------------


def test_enhance_directory_matches_jax(enhancer, tmp_path):
    """Every file comes back at its own length, the long one (beyond the
    largest bucket) through streaming, equal to the JAX sweep."""
    fixture = FIXTURES / "tiny_denoiser_mask"
    jm = JHybridViT(**TINY)
    template = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False),
                              jnp.zeros((1, 257, 64, 1), jnp.float32))
    je = JAudioEnhancer(jm, j_load_model_weights(fixture, template), read_meta(fixture)["config"],
                        buckets=BUCKETS, mask_padding=True)
    lengths = {}
    for i, sec in enumerate((0.3, 1.4, 0.5, 0.75, 0.4)):
        wav = _tone(sec, i, f0=150 + 20 * i)
        save_wav(tmp_path / "in" / f"f{i}.wav", wav, SR)
        lengths[f"f{i}.wav"] = len(wav)
    assert max(lengths.values()) > enhancer.max_samples
    n = enhancer.enhance_directory(tmp_path / "in", tmp_path / "port", batch_size=2,
                                   window_batches=1)
    assert n == je.enhance_directory(tmp_path / "in", tmp_path / "jax", batch_size=2,
                                     window_batches=1) == 5
    for name, length in lengths.items():
        ours = load_audio(tmp_path / "port" / name, SR)[0]
        ref = load_audio(tmp_path / "jax" / name, SR)[0]
        assert len(ours) == len(ref) == length and np.isfinite(ours).all(), name
        assert np.abs(ours[-SR // 10:]).max() > 1e-4, name
        np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0, err_msg=name)


def test_module_level_enhance_audio_and_file(checkpoint, port_model, tmp_path):
    wav = _tone(0.8, 7)
    ref = AudioEnhancer(port_model, TINY_CONFIG, device="cpu").enhance(wav)
    np.testing.assert_array_equal(enhance_audio(wav, checkpoint, device="cpu"), ref)
    save_wav(tmp_path / "in.wav", wav, SR, subtype="float32")
    out = enhance_file(tmp_path / "in.wav", tmp_path / "out.wav", checkpoint, device="cpu")
    np.testing.assert_array_equal(out, ref)
    assert wav_info(tmp_path / "out.wav") == (len(wav), SR, 1)


# ---------------------------------------------------------------------------
# the enhance and serve CLIs
# ---------------------------------------------------------------------------


def _cli(checkpoint, inp, out, *extra):
    return enhance_cli.main(["--checkpoint", str(checkpoint), "--config-dir", "/nonexistent",
                             "--device", "cpu", "--input", str(inp), "--output", str(out),
                             *extra])


def test_enhance_cli_file_streaming_and_directory(checkpoint, port_model, tmp_path):
    wav = _tone(0.9, 8)
    save_wav(tmp_path / "in.wav", wav, SR)
    noisy = load_audio(tmp_path / "in.wav", SR)[0]
    assert _cli(checkpoint, tmp_path / "in.wav", tmp_path / "out.wav") == 0
    ref = AudioEnhancer(port_model, TINY_CONFIG, device="cpu").enhance(noisy)
    np.testing.assert_allclose(load_audio(tmp_path / "out.wav", SR)[0], ref, atol=1.0 / 32767,
                               rtol=0)  # PCM16 written
    assert _cli(checkpoint, tmp_path / "in.wav", tmp_path / "s.wav", "--streaming",
                "--chunk-seconds", "0.3") == 0
    assert wav_info(tmp_path / "s.wav") == (len(wav), SR, 1)
    for i, sec in enumerate((0.4, 0.7, 0.25)):
        save_wav(tmp_path / "dir" / f"d{i}.wav", _tone(sec, 10 + i), SR)
    assert _cli(checkpoint, tmp_path / "dir", tmp_path / "dir_out", "--batch-size", "2",
                "--fold-bn", "--io-dtype", "int16", "--mask-padding") == 0
    for i, sec in enumerate((0.4, 0.7, 0.25)):
        out = load_audio(tmp_path / "dir_out" / f"d{i}.wav", SR)[0]
        assert len(out) == int(SR * sec) and np.isfinite(out).all()


def test_enhance_cli_errors(checkpoint, tmp_path, monkeypatch):
    """As JAX ``tests/test_cli.py::test_enhance_cli_errors``, plus
    ``--data-parallel 2``: on the CPU it runs (two replicas, the files equal
    to one device's), on ``cuda`` it is refused where fewer cards are
    visible, and the card is refused where there is none."""
    save_wav(tmp_path / "dir" / "a.wav", _tone(0.3, 0), SR)
    save_wav(tmp_path / "dir" / "b.wav", _tone(0.5, 1), SR)
    cases = [
        ((tmp_path / "missing.wav", tmp_path / "x.wav"), (), "input not found"),
        ((tmp_path / "dir", tmp_path / "file.wav"), (), "directory output"),
    ]
    for (inp, out), extra, msg in cases:
        with pytest.raises(SystemExit, match=msg):
            _cli(checkpoint, inp, out, *extra)
    assert _cli(checkpoint, tmp_path / "dir", tmp_path / "one", "--batch-size", "2") == 0
    assert _cli(checkpoint, tmp_path / "dir", tmp_path / "two", "--batch-size", "2",
                "--data-parallel", "2") == 0
    for name in ("a.wav", "b.wav"):  # PCM16 files: within one LSB
        np.testing.assert_allclose(load_audio(tmp_path / "two" / name, SR)[0],
                                   load_audio(tmp_path / "one" / name, SR)[0],
                                   atol=1.0 / 32767, rtol=0)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(SystemExit, match="2 CUDA devices asked for, but 1 visible"):
            enhance_cli.main(["--checkpoint", str(checkpoint), "--input", str(tmp_path / "dir"),
                              "--output", str(tmp_path / "o"), "--data-parallel", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        enhance_cli.main(["--checkpoint", str(checkpoint), "--input", str(tmp_path / "dir"),
                          "--output", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_serve_cli_config_dir_and_fold_bn(checkpoint, tmp_path, monkeypatch):
    """``--config-dir`` supplies the runtime sections (here a fixed blend)
    and ``--fold-bn`` folds the served model."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch import inference

    (tmp_path / "cfg").mkdir()
    (tmp_path / "cfg" / "train_config.yaml").write_text("inference:\n  blend: 0.75\n")
    built = {}

    def fake_server(enhancer, *args, **kw):
        built["enhancer"] = enhancer
        raise KeyboardInterrupt  # stop before binding a port

    monkeypatch.setattr(inference, "make_server", fake_server)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(KeyboardInterrupt):
            serve_cli.main(["--checkpoint", str(checkpoint), "--device", "cpu", "--fold-bn",
                            "--config-dir", str(tmp_path / "cfg"), "--blend", "0.5"])
    enh = built["enhancer"]
    assert enh.model.fold_bn and enh.blend == 0.5 and enh.config["inference"] == {"blend": 0.75}
    assert json.loads((checkpoint / "meta.json").read_text())["config"] == TINY_CONFIG
