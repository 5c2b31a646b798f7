"""Training: the train and eval steps and the epoch loop (JAX
``training/trainer.py``).

A train step: padded PCM16 batch -> featurize on the device (K1 STFT twice,
min-max, SpecAugment) -> ``HybridViT`` in train mode (attention through K2
and, for its gradient, K2's backward; with attention dropout through the
explicit-weights path) -> loss -> gradients -> global-norm clip -> the
optimizer -> a non-finite update is skipped (parameters, optimizer state and
BatchNorm statistics kept from before the step, its metrics zeroed).

The epoch loop keeps the JAX trainer's contract: the learning rate set once
per epoch from the schedule (``scheduler(0)`` at start), metrics averaged
over accepted steps, best / periodic / final checkpoints, early stopping,
best-on-train without a validation loader, resume with epoch + 1 (from the
port's checkpoints and from the JAX trainer's, optax state included),
TensorBoard scalars and audio samples when the config asks for them, and a
``torch.profiler`` trace of steps 1-5 of the first epoch with
``profile_dir``, which carries the recorder's ``train.*`` spans
(``utils/tracing.py``) as its ranges.

On a mesh (``parallel/``; one process per device) the step computes what
the JAX package's SPMD step computes over the global batch: BatchNorm's
training statistics over every data rank's rows, each loss term a rank's
sum over the global count of valid rows (or frames), the gradients and the
metrics summed over the data group in one ``all_reduce``, the replicated
parameters' gradients averaged over the model group, the clip's norm over
the tensor-parallel shards, so every rank takes the same step and skips
the same non-finite ones. The ``Trainer`` starts every rank from rank
0's weights, logs the global metrics, and writes checkpoints, logs, audio
samples and the profiler trace on rank 0 alone, after every rank has taken
part in gathering the tensor-parallel shards.
"""

from __future__ import annotations

import copy
import time
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.augmentation import SpecAugmentConfig
from ..data.pipeline import featurize_batch, int16_to_float
from ..models.components import BatchNorm, patch_validity_mask, sync_batchnorm
from ..ops.stft import STFTConfig, reconstruct
from ..parallel.collectives import all_reduce_
from ..parallel.mesh import Mesh, rank_seed
from ..parallel.sharding import gather_state_dict, shard_model, tp_gather, tp_split, unshard_model
from ..utils import tracing
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.logging import MetricsLogger, NullLogger, Stopwatch
from .losses import LossConfig, batch_si_sdr_db, combined_loss
from .optimizer import Optimizer, create_scheduler, global_norm, parameters


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy) as tensors on ``device``."""
    with tracing.span("train.h2d"):
        return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def stft_config_from(config: Dict) -> STFTConfig:
    a = config.get("audio", {})
    return STFTConfig(n_fft=a.get("n_fft", 512), hop_length=a.get("hop_length", 128),
                      win_length=a.get("win_length", 512), window=a.get("window", "hann"))


@torch.no_grad()
def parallelize(model: torch.nn.Module, mesh: Optional[Mesh], *, tensor_parallel: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """Ready ``model``, on this rank's device, for a run on ``mesh`` (in place):
    rank 0's parameters and buffers broadcast to every rank, then, with
    ``tensor_parallel`` and a model axis, this rank's shard kept
    (``shard_model``; ``generator``: dropout on its own shard), and with a
    data axis every BatchNorm synced over the data group. On no mesh, or a
    mesh of one device, the model is left as it is."""
    if mesh is None or mesh.size == 1:
        return model
    import torch.distributed as dist

    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src=0)
    if tensor_parallel and mesh.model > 1:
        shard_model(model, mesh, generator)
    if mesh.data > 1:
        sync_batchnorm(model, mesh.data_group)
    return model


def _sum_over(group, grads, metrics):
    """``grads`` and the 0-d ``metrics`` summed over ``group`` in one
    ``all_reduce`` of one flat buffer."""
    keys = list(metrics)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + ([torch.stack([metrics[k] for k in keys])] if keys else []))
    all_reduce_(flat, group)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return out, dict(zip(keys, flat[i:].unbind()))


def make_step_fns(
    model: torch.nn.Module,
    optimizer: Optimizer,
    loss_cfg: LossConfig,
    stft_cfg: STFTConfig,
    aug_cfg: SpecAugmentConfig,
    *,
    augment: bool = True,
    use_attention_mask: bool = False,
    skip_nonfinite: bool = True,
    output_mode: str = "magnitude",
    generator: Optional[torch.Generator] = None,
    mesh: Optional[Mesh] = None,
):
    """``(train_step, eval_step)``: ``train_step(batch)`` updates ``model``
    through ``optimizer`` and returns its metrics (0-d tensors on the
    device); ``eval_step(batch)`` returns the loss components. ``batch``:
    ``batch_to_device`` of a loader batch. ``generator`` draws SpecAugment
    (``augment``); dropout draws from the device's default generator.
    ``mesh``: this rank's mesh, with ``model`` already ``parallelize``d for
    it; the metrics are then the global batch's.

    ``use_attention_mask`` keeps bucket-padding patches out of attention;
    ``output_mode`` ``"mask"`` maps the Tanh output to a [0, 1] mask on the
    noisy magnitude (``"magnitude"``: the output is the normalized clean
    magnitude)."""
    if output_mode not in ("magnitude", "mask"):
        raise ValueError(f"model.output_mode must be 'magnitude' or 'mask', got {output_mode!r}")
    mask_mode = output_mode == "mask"
    if loss_cfg.si_sdr_weight > 0 and not mask_mode:
        # ROADMAP section 3: kept for parity with the JAX package
        warnings.warn(
            "loss.si_sdr_weight > 0 with output_mode 'magnitude': the SI-SDR term denormalizes "
            "the prediction by the noisy max only, while the L1 target is min-max normalized, "
            "so the two terms pull towards different optima (use output_mode 'mask')",
            stacklevel=2,
        )
    if augment and generator is None:
        raise ValueError("augment=True needs a torch.Generator for SpecAugment")
    params = optimizer.params
    bn_state = [t for m in model.modules() if isinstance(m, BatchNorm)
                for t in (m.running_mean, m.running_var, m.num_batches_tracked)]
    data_group = mesh.data_group if mesh is not None and mesh.data > 1 else None
    count_sum = None if data_group is None else (
        lambda c: all_reduce_(c.detach().clone(), data_group))
    # under tensor parallelism the replicated parameters' gradients are
    # averaged over the model group: a backward that adds with atomics
    # (F.interpolate's on CUDA) leaves them a few ulp apart on the model
    # ranks, and the replicas would drift
    tp = next((m.tp for m in model.modules() if getattr(m, "tp", None) is not None), None)
    replicated = [i for i, p in enumerate(params) if getattr(p, "tp_group", None) is None]

    def _featurize(batch, augmenting: bool):
        return featurize_batch(batch["noisy_audio"], batch["clean_audio"], batch["length"],
                               stft_cfg, augment_config=aug_cfg,
                               augment_generator=generator if augmenting else None)

    def _patch_mask(feats, batch):
        if not use_attention_mask:
            return None
        return patch_validity_mask(batch["length"], feats.noisy_spec.shape[1],
                                   feats.noisy_spec.shape[2], stft_cfg.hop_length,
                                   pool_sizes=model.encoder_pool_sizes,
                                   patch_size=model.patch_size)

    def _pred_target(out, feats):
        if not mask_mode:
            return out, feats.clean_spec
        m = (out[..., 0].float() + 1.0) * 0.5  # Tanh -> [0, 1]
        return (m * feats.noisy_over_max)[..., None], feats.clean_over_max[..., None]

    def _si_sdr_term(pred, feats, batch):
        """-mean SI-SDR (dB) of the waveform reconstructed from the predicted
        magnitude (times the noisy max) and the noisy phase. The iSTFT is the
        plain differentiable one (``ops.stft.reconstruct``), not kernel K3,
        which has no backward: the JAX package makes the same choice
        (``method="matmul"``) for the gradient."""
        est_mag = pred[..., 0].float() * torch.clamp(feats.noisy_max, min=1e-8)[:, None, None]
        est = reconstruct(est_mag, feats.noisy_phase, stft_cfg,
                          length=batch["clean_audio"].shape[-1])
        si = batch_si_sdr_db(int16_to_float(batch["clean_audio"]), est, valid=batch["valid"],
                             count_sum=count_sum)
        return -si, si

    def _loss(out, feats, batch):
        pred, target = _pred_target(out, feats)
        total, comps = combined_loss(pred, target, loss_cfg, frame_mask=feats.frame_mask,
                                     sample_valid=batch["valid"], count_sum=count_sum)
        if loss_cfg.si_sdr_weight > 0:
            term, si = _si_sdr_term(pred, feats, batch)
            total = total + loss_cfg.si_sdr_weight * term
            comps = dict(comps, si_sdr_db=si, total=total)
        return total, comps

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with tracing.span("train.step", tracing.count("train.steps")):
            return _train_step(batch)

    def _train_step(batch):
        with tracing.span("train.featurize"):
            feats = _featurize(batch, augment)
            attn_mask = _patch_mask(feats, batch)
        with tracing.span("train.forward"):
            model.train()
            saved = [t.clone() for t in bn_state] if skip_nonfinite else None
            out = model(feats.noisy_spec, mask=attn_mask)
            total, comps = _loss(out, feats, batch)
        with tracing.span("train.backward"):
            grads = torch.autograd.grad(total, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        metrics = {k: v.detach() for k, v in comps.items()}
        if data_group is not None:
            grads, metrics = _sum_over(data_group, grads, metrics)
        if tp is not None:
            summed = _sum_over(tp.group, [grads[i] for i in replicated], {})[0]
            for i, g in zip(replicated, summed):
                grads[i] = g / tp.size
        with tracing.span("train.norm"):
            gnorm = global_norm(grads, params)
        metrics["grad_norm"] = gnorm.detach()
        if not skip_nonfinite:
            with tracing.span("train.optimizer"):
                optimizer.step(grads)
            return metrics
        # one non-finite gradient would poison the parameters for good: keep
        # everything from before the step (BatchNorm's running statistics
        # moved in the forward) and zero the step's metrics
        with tracing.span("train.sync"):
            ok = bool(torch.isfinite(gnorm) & torch.isfinite(metrics["total"]))
        if ok:
            with tracing.span("train.optimizer"):
                optimizer.step(grads)
        else:
            with torch.no_grad():
                for t, s in zip(bn_state, saved):
                    t.copy_(s)
            metrics = {k: torch.zeros_like(v) for k, v in metrics.items()}
        metrics["nonfinite_skipped"] = torch.tensor(0.0 if ok else 1.0, device=gnorm.device)
        return metrics

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        feats = _featurize(batch, False)
        model.eval()
        out = model(feats.noisy_spec, mask=_patch_mask(feats, batch))
        comps = _loss(out, feats, batch)[1]
        if data_group is None:
            return comps
        return _sum_over(data_group, [], comps)[1]

    return train_step, eval_step


class Trainer:
    """The epoch loop with the reference's training contract, on one
    device (``cuda`` unless the caller asks for ``cpu``): this process's,
    of ``mesh`` when the caller gives one (its ``torch.distributed`` group
    joined, ``parallel.initialize_distributed``). Tensor parallelism
    engages on a model axis unless ``mesh.use_tensor_parallel`` is false in
    the config, as in the JAX trainer."""

    def __init__(
        self,
        model: torch.nn.Module,
        config: Dict,
        train_loader,
        val_loader=None,
        *,
        device: str | torch.device = "cuda",
        mesh: Optional[Mesh] = None,
        checkpoint_dir: Optional[str | Path] = None,
        log_dir: Optional[str | Path] = None,
        resume_from: Optional[str | Path] = None,
        profile_dir: Optional[str | Path] = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: device cuda asked for, but no CUDA device is available")
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0
        self.profile_dir = profile_dir if self.is_main else None
        self.use_tp = (mesh is not None and mesh.model > 1
                       and config.get("mesh", {}).get("use_tensor_parallel", True))
        self.config = config
        self.train_loader = train_loader
        self.val_loader = val_loader
        tc = config.get("training", {})
        self.num_epochs = tc.get("num_epochs", 100)
        self.log_every = tc.get("logging", {}).get("log_every_n_steps", 10)
        self.seed = tc.get("seed", 42)
        self.sample_rate = config.get("data", {}).get("sample_rate", 16000)
        ckpt_cfg = tc.get("checkpoint", {})
        self.checkpoint_dir = Path(checkpoint_dir or ckpt_cfg.get("save_dir", "checkpoints"))
        self.save_every = ckpt_cfg.get("save_every_n_epochs", 5)
        self.val_every = tc.get("validation", {}).get("val_every_n_epochs", 1)
        es = tc.get("early_stopping", {})
        self.early_stopping = es.get("enabled", True)
        self.patience = es.get("patience", 10)
        self.min_delta = es.get("min_delta", 1e-4)

        # dropout, drop-path and SpecAugment: one stream per data rank, shared
        # by the model ranks of its data shard; dropout on a tensor-parallel
        # shard: one stream per rank
        data_rank = mesh.data_rank if mesh is not None else 0
        torch.manual_seed(rank_seed(self.seed, data_rank))
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(self.seed, data_rank))
        tp_generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(self.seed, data_rank, mesh.model_rank)) if self.use_tp else None
        self.model = parallelize(model.to(self.device), mesh, tensor_parallel=self.use_tp,
                                 generator=tp_generator)
        self.param_names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        self.stft_cfg = stft_config_from(config)
        self.loss_cfg = LossConfig.from_config(config)
        self.aug_cfg = SpecAugmentConfig.from_config(config)
        self.optimizer = Optimizer.from_config(parameters(self.model), config)
        self.scheduler = create_scheduler(config, self.num_epochs)
        self.optimizer.lr = self.scheduler(0)

        lc = tc.get("logging", {})
        self.logger = MetricsLogger(log_dir or lc.get("log_dir", "logs"),
                                    tc.get("experiment_name", "experiment"),
                                    use_tensorboard=lc.get("use_tensorboard", True)
                                    ) if self.is_main else NullLogger()
        # as the JAX trainer: audio samples only where a TensorBoard writer is
        # (rank 0's); under tensor parallelism every rank gathers the weights
        self.audio_samples_asked = lc.get("save_audio_samples", False)
        self.log_audio_samples = self.audio_samples_asked and self.logger.tb is not None
        self.num_audio_samples = lc.get("num_audio_samples", 5)

        self.step = 0
        self.current_epoch = 0
        self.best_val_loss = float("inf")
        self.epochs_no_improve = 0
        if resume_from:
            self.load(resume_from)

        aug = config.get("data", {}).get("augmentation", {})
        self.train_step, self.eval_step = make_step_fns(
            self.model, self.optimizer, self.loss_cfg, self.stft_cfg, self.aug_cfg,
            augment=aug.get("enabled", True),
            use_attention_mask=tc.get("mask_padding", False),
            skip_nonfinite=tc.get("skip_nonfinite_updates", True),
            output_mode=config.get("model", {}).get("output_mode", "magnitude"),
            generator=self.generator,
            mesh=mesh,
        )
        self.stopwatch = Stopwatch()

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch; loss and gradient metrics averaged over the accepted
        steps, ``nonfinite_skipped`` over all of them."""
        totals: Dict[str, torch.Tensor] = {}
        count = 0
        prof = None
        for batch in self.train_loader:
            if self.profile_dir and epoch == 0 and count == 1:
                prof = self._start_profiler()  # steps 1-5: batch 0 builds the kernels
            audio_sec = float(batch["length"].sum()) / self.sample_rate
            metrics = self.train_step(batch_to_device(batch, self.device))
            self.step += 1
            count += 1
            if prof is not None and count >= 6:
                self._stop_profiler(prof)
                prof = None
            for k, v in metrics.items():
                totals[k] = v if k not in totals else totals[k] + v
            if count % self.log_every == 0:
                self.logger.log_scalars(count, {k: float(v) for k, v in metrics.items()},
                                        prefix="train/batch_")
            self.stopwatch.tick(audio_sec)
        if prof is not None:  # fewer than 6 batches in the epoch
            self._stop_profiler(prof)
        host = {k: float(v) for k, v in totals.items()}
        skipped = host.get("nonfinite_skipped", 0.0)
        accepted = count - skipped
        if count and accepted <= 0:
            # every step diverged: NaN, which never wins a best-loss compare
            return {k: (1.0 if k == "nonfinite_skipped" else float("nan")) for k in host}
        return {k: v / (max(count, 1) if k == "nonfinite_skipped" else max(accepted, 1.0))
                for k, v in host.items()}

    def _start_profiler(self):
        """Start a profiler, with the recorder's spans as its ranges."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        tracing.enable(profiler_ranges=True)
        return prof

    def _stop_profiler(self, prof) -> None:
        """Stop ``prof`` once the device has finished, and write its Chrome
        trace into ``profile_dir``."""
        tracing.disable()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "train_steps.pt.trace.json"))

    def _log_audio_samples(self, epoch: int) -> None:
        """Enhance ``num_audio_samples`` validation clips with the current
        weights and log the noisy (first epoch) and enhanced audio (rank 0)."""
        if self.val_loader is None:
            return
        model = self.model
        if self.use_tp and self.audio_samples_asked:
            full = gather_state_dict(self.model.state_dict(), self.mesh)  # every rank
            if self.log_audio_samples:
                model = unshard_model(self._detached_copy(), full)
        if not self.log_audio_samples:
            return
        try:
            from ..inference.enhancer import AudioEnhancer

            enhancer = AudioEnhancer(model, self.config, device=self.device,
                                     buckets=tuple(self.train_loader.buckets))
            ds = self.val_loader.dataset
            wavs = [ds.load_pair(i)[0] for i in range(min(self.num_audio_samples, len(ds)))]
            for i, (noisy, enh) in enumerate(zip(wavs, enhancer.enhance_batch(wavs))):
                if epoch == 0:
                    self.logger.log_audio(self.step, f"audio/noisy_{i}", noisy, self.sample_rate)
                self.logger.log_audio(self.step, f"audio/enhanced_{i}", enh, self.sample_rate)
        except Exception as e:  # never stop training over logging
            print(f"warning: audio sample logging failed: {e}")

    def _detached_copy(self) -> torch.nn.Module:
        """A copy of the model that shares no process group or generator."""
        shared = [self.mesh.data_group, self.mesh.model_group]
        shared += [m.tp.generator for m in self.model.modules() if getattr(m, "tp", None)]
        model = copy.deepcopy(self.model, {id(o): o for o in shared if o is not None})
        return sync_batchnorm(model, None)

    def validate(self) -> Dict[str, float]:
        if self.val_loader is None:
            return {}
        totals: Dict[str, torch.Tensor] = {}
        count = 0
        for batch in self.val_loader:
            for k, v in self.eval_step(batch_to_device(batch, self.device)).items():
                totals[k] = v if k not in totals else totals[k] + v
            count += 1
        return {k: float(v) / max(count, 1) for k, v in totals.items()}

    def train(self) -> Dict[str, list]:
        """The full run: epochs, schedule, checkpoints, early stopping."""
        history = {"train_loss": [], "val_loss": []}
        if self.val_loader is None and self.is_main:
            print("warning: no validation loader — best_model will track the training loss "
                  "instead of a validation loss")
        for epoch in range(self.current_epoch, self.num_epochs):
            t0 = time.perf_counter()
            train_metrics = self.train_epoch(epoch)
            run_val = (epoch + 1) % max(self.val_every, 1) == 0
            val_metrics = self.validate() if run_val else {}
            validated = run_val and "total" in val_metrics
            val_loss = val_metrics.get("total", train_metrics.get("total", 0.0))
            # the plateau schedule consumes only a validation loss
            lr = self.scheduler(epoch + 1, val_loss if validated else None)
            self.optimizer.lr = lr

            scalars = {f"train_{k}": v for k, v in train_metrics.items()}
            scalars.update({f"val_{k}": v for k, v in val_metrics.items()})
            scalars["lr"] = lr
            scalars["epoch_time_s"] = time.perf_counter() - t0
            scalars["audio_seconds_per_s"] = self.stopwatch.audio_seconds_per_second
            self.logger.log_scalars(self.step, scalars, prefix="epoch/")
            history["train_loss"].append(train_metrics.get("total", 0.0))
            history["val_loss"].append(val_loss)
            self._log_audio_samples(epoch)
            self.logger.flush()

            # best-model and patience bookkeeping only on validated epochs
            # (or on the train loss when there is no validation loader)
            if validated or self.val_loader is None:
                if val_loss < self.best_val_loss - self.min_delta:
                    self.best_val_loss = val_loss
                    self.epochs_no_improve = 0
                    self.save(self.checkpoint_dir / "best_model", epoch)
                else:
                    self.epochs_no_improve += 1
            if self.save_every and (epoch + 1) % self.save_every == 0:
                self.save(self.checkpoint_dir / f"checkpoint_epoch_{epoch + 1}", epoch)
            self.current_epoch = epoch + 1
            if self.early_stopping and self.epochs_no_improve >= self.patience:
                print(f"Early stopping at epoch {epoch + 1}")
                break
        self.save(self.checkpoint_dir / "final_model", self.current_epoch - 1)
        return history

    def save(self, path: str | Path, epoch: int) -> Path:
        """Write a checkpoint (rank 0), its tensor-parallel shards gathered
        first (every rank)."""
        sd, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self.use_tp:
            sd = gather_state_dict(sd, self.mesh)
            opt = {k: ([tp_gather(n, t, self.mesh) for n, t in zip(self.param_names, v)]
                       if isinstance(v, list) else v) for k, v in opt.items()}
        if not self.is_main:
            return Path(path)
        return save_checkpoint(path, self.model, state_dict=sd, step=self.step,
                               optimizer_state=opt, epoch=epoch,
                               global_step=self.step, best_val_loss=self.best_val_loss,
                               config=self.config)

    def load(self, path: str | Path) -> None:
        """Resume: weights, BatchNorm statistics, optimizer state (the port's,
        or a JAX checkpoint's optax state), step and the loop position (the
        saved epoch + 1). Under tensor parallelism each rank keeps its shard
        of what it reads."""
        shard = None
        if self.use_tp:
            mp, m = self.mesh.model, self.mesh.model_rank
            shard = lambda name, t: tp_split(name, t, mp, m)  # noqa: E731
        step, opt_state, meta = load_checkpoint(path, self.model, self.optimizer.name, shard=shard)
        if opt_state is None:
            raise ValueError(f"{path} holds no optimizer state to resume from")
        self.optimizer.load_state_dict(opt_state)
        self.step = step
        self.current_epoch = int(meta.get("epoch", -1)) + 1
        self.best_val_loss = float(meta.get("best_val_loss", float("inf")))
