"""The port's dataset, preprocessing and bucketed loader against the JAX
package's, on synthetic VoiceBank-style WAV pairs written by the port's own
codec: the same file pairs and train/val/test split, the same
preprocessing, and, from the same files and seed, equal batches (float32
and PCM16 transfer, padding rows, ``valid``, buckets) over two epochs.
"""

import numpy as np
import pytest

from speech_enhancement_via_hybrid_vision_transformer_project_tpu.data import dataset as JD
from speech_enhancement_via_hybrid_vision_transformer_project_tpu.data.preprocessing import (
    AudioPreprocessor as JAudioPreprocessor,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data import dataset as D
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.preprocessing import (
    AudioPreprocessor,
)
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import save_wav

SR = 16000


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vb")
    rng = np.random.default_rng(0)
    for split, n in (("trainset_28spk", 11), ("testset", 3)):
        for i in range(n):
            length = int(rng.uniform(0.3, 2.2) * SR)
            clean = (0.4 * np.sin(np.arange(length) * rng.uniform(0.01, 0.1))).astype(np.float32)
            noisy = clean + 0.1 * rng.standard_normal(length).astype(np.float32)
            save_wav(root / f"clean_{split}_wav" / f"p{i:03d}.wav", clean, SR)
            save_wav(root / f"noisy_{split}_wav" / f"p{i:03d}.wav", noisy, SR)
    # a noisy file without its clean pair is skipped
    save_wav(root / "noisy_trainset_28spk_wav" / "zzz.wav", np.zeros(4000, np.float32), SR)
    return root


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_dataset_split_and_items_match_jax(split, data_root):
    ours = D.VoiceBankDataset(data_root, split, {"data": {"train_val_split": 0.8}})
    ref = JD.VoiceBankDataset(data_root, split, {"data": {"train_val_split": 0.8}})
    assert [p for pair in ours.file_pairs for p in pair] == [p for pair in ref.file_pairs
                                                             for p in pair]
    assert len(ours) == {"train": 8, "val": 3, "test": 3}[split]
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert set(a) == set(b) and int(a["length"]) == int(b["length"])
        for k in ("noisy_audio", "clean_audio"):
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("transfer_dtype", ["float32", "int16"])
@pytest.mark.parametrize("shuffle,pad_to_batch,drop_last", [
    (True, True, False), (False, False, False), (True, True, True)])
def test_loader_batches_match_jax(transfer_dtype, shuffle, pad_to_batch, drop_last, data_root):
    kw = dict(batch_size=3, shuffle=shuffle, num_workers=2, seed=7, buckets=(32, 128, 256),
              drop_last=drop_last, pad_to_batch=pad_to_batch, transfer_dtype=transfer_dtype)
    ours = D.DataLoader(D.VoiceBankDataset(data_root, "train"), **kw)
    ref = JD.DataLoader(JD.VoiceBankDataset(data_root, "train"), **kw)
    assert len(ours) == len(ref)
    for _ in range(2):  # the shuffle is seeded by seed + epoch
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in b:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_collate_pads_rows_and_marks_them_invalid():
    items = [{"noisy_audio": np.ones(1000, np.float32), "clean_audio": np.ones(1000, np.float32),
              "length": np.int32(1000)}]
    batch = D.collate_waveforms(items, batch_size=3, buckets=(16, 32))
    assert batch["noisy_audio"].shape == (3, 15 * 128)
    np.testing.assert_array_equal(batch["valid"], [True, False, False])
    np.testing.assert_array_equal(batch["length"], [1000, 0, 0])
    with pytest.raises(ValueError, match="transfer_dtype"):
        D.collate_waveforms(items, transfer_dtype="float16")


def test_preprocessing_chain_matches_jax(rng):
    x = (0.3 * np.sin(np.arange(20000) * 0.02) * (np.arange(20000) > 3000)).astype(np.float32)
    x += 0.001 * rng.standard_normal(20000).astype(np.float32)
    kw = dict(apply_pre_emphasis=True, apply_vad=True, vad_threshold=0.005,
              trim_silence=True, apply_compression=True, normalize=True)
    np.testing.assert_allclose(AudioPreprocessor(**kw).process(x),
                               JAudioPreprocessor(**kw).process(x), rtol=1e-6, atol=1e-7)
    config = {"data": {"normalize_audio": False,
                       "preprocessing": {"apply_pre_emphasis": True, "trim_silence": True}}}
    np.testing.assert_allclose(AudioPreprocessor.from_config(config).process(x),
                               JAudioPreprocessor.from_config(config).process(x),
                               rtol=1e-6, atol=1e-7)
