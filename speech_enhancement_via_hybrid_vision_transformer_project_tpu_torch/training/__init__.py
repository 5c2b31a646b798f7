"""Training: losses, optimizer and schedules, the train/eval steps and the
epoch loop (the JAX package's names where the port has them)."""

from .losses import (  # noqa: F401
    LossConfig,
    combined_loss,
    create_loss_function,
    multi_resolution_stft_loss,
    perceptual_loss,
    spectrogram_loss,
    stoi_proxy_loss,
)
from .optimizer import EpochScheduler, create_scheduler, warmup_cosine_step_schedule  # noqa: F401
from .trainer import Trainer, make_step_fns  # noqa: F401
