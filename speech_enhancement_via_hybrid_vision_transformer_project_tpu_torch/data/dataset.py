"""VoiceBank-DEMAND pairs, length buckets and the bucketed batch loader
(JAX ``data/dataset.py``, numpy only).

Pairing and split follow the reference: noisy files sorted, paired with
same-named clean files, train = the first ``train_val_split`` of the sorted
list, val = the tail. The loader yields padded numpy waveform batches and
their true lengths; the STFT, normalization and SpecAugment run on the
device inside the train step (``data/pipeline.py``). Given the same files
and seed it yields the JAX loader's batches.

On a data-parallel mesh every rank runs its host's loader, the one the JAX
CLI runs on that host, and keeps its own block of each batch's rows
(``part``): the bucket is the whole batch's, so the ranks' blocks together
are the JAX global batch. Several hosts run the loader's lockstep mode (as
the JAX loader on every host): ``VoiceBankDataset.shard`` keeps the host's
stride of the file list, ``fixed_bucket`` pads every batch to one frame
count, and ``max_batches`` yields exactly that many batches, ending an
exhausted shard with padding batches whose rows are all invalid, so every
host takes the same steps on the same shapes.
"""

from __future__ import annotations

import copy
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.stft import STFTConfig
from .preprocessing import AudioPreprocessor
from .wavio import load_audio

DEFAULT_BUCKETS = (128, 256, 384, 512, 768, 1024)


def bucket_for_frames(n_frames: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n_frames (the last bucket caps)."""
    for b in buckets:
        if n_frames <= b:
            return b
    return buckets[-1]


def frames_needed(n_samples: int, hop_length: int) -> int:
    """Frame bucket large enough that its waveform length (bucket-1)*hop
    covers ``n_samples`` without truncation: 1 + ceil(L / hop)."""
    return 1 + -(-n_samples // hop_length)


def pair_files(noisy_dir: Path, clean_dir: Path) -> List[Tuple[Path, Path]]:
    """Sorted noisy files paired with same-named clean files."""
    pairs = []
    for noisy_path in sorted(noisy_dir.glob("*.wav")):
        clean_path = clean_dir / noisy_path.name
        if clean_path.exists():
            pairs.append((noisy_path, clean_path))
        else:
            print(f"Warning: No clean file found for {noisy_path.name}")
    return pairs


class VoiceBankDataset:
    """Paired noisy/clean utterances with the deterministic train/val split."""

    def __init__(
        self,
        data_root: str | Path,
        split: str = "train",
        config: Optional[dict] = None,
        preprocessor: Optional[AudioPreprocessor] = None,
        cache_audio: Optional[bool] = None,
    ):
        self.config = (config or {}).get("data", config or {})
        self.data_root = Path(data_root)
        self.split = split
        self.sample_rate = self.config.get("sample_rate", 16000)
        self.stft_config = STFTConfig(
            n_fft=self.config.get("n_fft", 512),
            hop_length=self.config.get("hop_length", 128),
            win_length=self.config.get("win_length", 512),
            window=self.config.get("window", "hann"),
        )
        self.preprocessor = preprocessor or AudioPreprocessor(
            sample_rate=self.sample_rate,
            normalize=self.config.get("normalize_audio", True),
        )
        if cache_audio is None:
            cache_audio = self.config.get("cache", {}).get("enabled", False)
        self.cache_audio = cache_audio
        self._cache: Dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.file_pairs = self._load_file_pairs()

    def _load_file_pairs(self) -> List[Tuple[Path, Path]]:
        if self.split in ("train", "val"):
            noisy_dir = self.data_root / self.config.get("noisy_train_dir", "noisy_trainset_28spk_wav")
            clean_dir = self.data_root / self.config.get("clean_train_dir", "clean_trainset_28spk_wav")
        elif self.split == "test":
            noisy_dir = self.data_root / self.config.get("noisy_test_dir", "noisy_testset_wav")
            clean_dir = self.data_root / self.config.get("clean_test_dir", "clean_testset_wav")
        else:
            raise ValueError(f"Invalid split: {self.split}. Must be 'train', 'val', or 'test'")
        for d in (noisy_dir, clean_dir):
            if not d.exists():
                raise FileNotFoundError(
                    f"Audio directory not found: {d}\nDownload VoiceBank-DEMAND into {self.data_root}"
                )
        pairs = pair_files(noisy_dir, clean_dir)
        if self.split in ("train", "val"):
            split_idx = int(len(pairs) * self.config.get("train_val_split", 0.9))
            pairs = pairs[:split_idx] if self.split == "train" else pairs[split_idx:]
        return pairs

    def __len__(self) -> int:
        return len(self.file_pairs)

    def load_pair(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """Preprocessed, length-matched (noisy, clean) waveforms."""
        if self.cache_audio and idx in self._cache:
            return self._cache[idx]
        noisy_path, clean_path = self.file_pairs[idx]
        noisy, _ = load_audio(noisy_path, self.sample_rate)
        clean, _ = load_audio(clean_path, self.sample_rate)
        noisy = self.preprocessor.process(noisy)
        clean = self.preprocessor.process(clean)
        n = min(len(noisy), len(clean))
        out = (noisy[:n], clean[:n])
        if self.cache_audio:
            self._cache[idx] = out
        return out

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        noisy, clean = self.load_pair(idx)
        return {"noisy_audio": noisy, "clean_audio": clean, "length": np.int32(len(noisy))}

    def shard(self, host_id: int, num_hosts: int) -> "VoiceBankDataset":
        """A copy holding every ``num_hosts``-th pair from ``host_id`` on (a
        data rank's share of the sorted list)."""
        ds = copy.copy(self)
        ds.file_pairs = self.file_pairs[host_id::num_hosts]
        ds._cache = {}
        return ds


def collate_waveforms(
    items: List[Dict[str, np.ndarray]],
    stft_config: STFTConfig = STFTConfig(),
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    batch_size: Optional[int] = None,
    transfer_dtype: str = "float32",
    fixed_bucket: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Right-pad waveforms to the batch's bucket (zeros), or to
    ``fixed_bucket`` frames; with ``batch_size`` also pad with empty rows to
    that size, ``valid`` marking the real rows. ``transfer_dtype='int16'``
    ships PCM16 (the sources are PCM16 WAVs: at most 1 LSB of
    requantization), rescaled on the device by
    ``data.pipeline.int16_to_float``."""
    hop = stft_config.hop_length
    if fixed_bucket is not None:
        bucket = fixed_bucket
    else:
        frames = [frames_needed(len(it["noisy_audio"]), hop) for it in items]
        bucket = bucket_for_frames(max(frames), buckets)
    wav_len = (bucket - 1) * hop  # num_frames(wav_len) == bucket (center)
    b = batch_size or len(items)
    noisy = np.zeros((b, wav_len), np.float32)
    clean = np.zeros((b, wav_len), np.float32)
    lengths = np.zeros((b,), np.int32)
    valid = np.zeros((b,), bool)
    for i, it in enumerate(items):
        n = min(len(it["noisy_audio"]), wav_len)
        noisy[i, :n] = it["noisy_audio"][:n]
        clean[i, :n] = it["clean_audio"][:n]
        lengths[i] = n
        valid[i] = True
    if transfer_dtype == "int16":
        noisy = np.clip(np.rint(noisy * 32768.0), -32768, 32767).astype(np.int16)
        clean = np.clip(np.rint(clean * 32768.0), -32768, 32767).astype(np.int16)
    elif transfer_dtype != "float32":
        raise ValueError(f"transfer_dtype must be float32|int16, got {transfer_dtype!r}")
    return {"noisy_audio": noisy, "clean_audio": clean, "length": lengths, "valid": valid}


class DataLoader:
    """Thread-pool prefetching loader of collated numpy batches, in order:
    items shuffled by ``numpy.random.default_rng(seed + epoch)``, cut into
    batches, each padded to its bucket (and to ``batch_size`` rows).
    ``fixed_bucket`` and ``max_batches``: the lockstep mode (module
    docstring); a padding batch is collated from item 0 with every row
    invalid. ``part=(i, n)`` yields the ``i``-th of ``n`` equal blocks of
    each batch's rows, padded to the whole batch's bucket (a data rank's
    rows; every rank reads the whole batch's files to find that bucket)."""

    def __init__(
        self,
        dataset: VoiceBankDataset,
        batch_size: int = 16,
        shuffle: bool = True,
        num_workers: int = 4,
        seed: int = 42,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        drop_last: bool = False,
        pad_to_batch: bool = True,
        transfer_dtype: str = "float32",
        fixed_bucket: Optional[int] = None,
        max_batches: Optional[int] = None,
        part: Optional[Tuple[int, int]] = None,
    ):
        if part is not None and (batch_size % part[1] or not pad_to_batch):
            raise ValueError(f"part {part} needs rows padded to a batch ({batch_size}) "
                             f"that {part[1]} divides")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.buckets = tuple(buckets)
        self.drop_last = drop_last
        self.pad_to_batch = pad_to_batch
        self.transfer_dtype = transfer_dtype
        self.fixed_bucket = fixed_bucket
        self.max_batches = max_batches
        self.part = part
        self.epoch = 0

    def __len__(self) -> int:
        if self.max_batches is not None:
            return self.max_batches
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self) -> List[Optional[List[int]]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        batches = [list(idx[i : i + self.batch_size]) for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.max_batches is not None:  # None: a padding batch
            batches = batches[: self.max_batches]
            batches.extend([None] * (self.max_batches - len(batches)))
        return batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batch_indices()
        self.epoch += 1
        cfg = self.dataset.stft_config
        out_q: "queue.Queue" = queue.Queue(maxsize=self.num_workers * 2)
        stop = threading.Event()
        trunc_lock = threading.Lock()
        trunc_count = 0
        cap_bucket = self.fixed_bucket or self.buckets[-1]
        max_wav = (cap_bucket - 1) * cfg.hop_length

        def producer(worker_id: int):
            nonlocal trunc_count
            error = None
            try:
                for bi in range(worker_id, len(batches), self.num_workers):
                    if stop.is_set():
                        return
                    padding = batches[bi] is None
                    items = [self.dataset[i] for i in ([0] if padding else batches[bi])]
                    over = 0 if padding else sum(
                        1 for it in items if len(it["noisy_audio"]) > max_wav)
                    if over:
                        with trunc_lock:
                            trunc_count += over
                    batch = collate_waveforms(
                        items, cfg, self.buckets,
                        self.batch_size if self.pad_to_batch else None,
                        transfer_dtype=self.transfer_dtype, fixed_bucket=self.fixed_bucket,
                    )
                    if padding:
                        batch["valid"][:] = False
                    if self.part is not None:
                        i, n = self.part
                        rows = self.batch_size // n
                        batch = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                    out_q.put((bi, batch))
            except Exception as e:  # handed to the consumer, which raises it
                error = e
            finally:
                out_q.put((None, error))

        threads = [threading.Thread(target=producer, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            pending: Dict[int, Dict[str, np.ndarray]] = {}
            done_workers = 0
            next_bi = 0
            while done_workers < len(threads) or pending:
                if next_bi in pending:
                    yield pending.pop(next_bi)
                    next_bi += 1
                    continue
                bi, batch = out_q.get()
                if bi is None:
                    if batch is not None:  # a worker raised
                        raise batch
                    done_workers += 1
                    continue
                pending[bi] = batch
        finally:
            stop.set()
            while True:  # unblock producers waiting on a full queue
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
            for t in threads:
                t.join(timeout=10)
            if trunc_count:
                print(
                    f"warning: {trunc_count} utterance(s) exceeded the largest bucket "
                    f"({cap_bucket} frames ≈ {max_wav / self.dataset.sample_rate:.1f}s) "
                    "this epoch and were truncated for training (raise "
                    "data.bucketing.frame_buckets to keep full length)"
                )


def get_data_loader(dataset: VoiceBankDataset, batch_size: int = 16, shuffle: bool = True,
                    num_workers: int = 4, **kw) -> DataLoader:
    """``DataLoader(dataset, batch_size, shuffle, num_workers, **kw)`` (the
    JAX package's factory)."""
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle, num_workers=num_workers,
                      **kw)
