"""Data layer: WAV codec, VoiceBank-DEMAND dataset, bucketed loader, host
preprocessing, featurization and augmentation (the JAX package's names)."""

from .augmentation import (  # noqa: F401
    AudioAugmenter,
    SpecAugmentConfig,
    SpectrogramAugmenter,
    spec_augment,
    spec_augment_batch,
)
from .dataset import (  # noqa: F401
    DataLoader,
    VoiceBankDataset,
    bucket_for_frames,
    collate_waveforms,
    get_data_loader,
    pair_files,
)
from .pipeline import FeaturizedBatch, featurize_batch, minmax_normalize  # noqa: F401
from .preprocessing import AudioPreprocessor  # noqa: F401
from .wavio import load_audio, read_wav_bytes, save_wav, wav_bytes, wav_info  # noqa: F401
