"""Batched and streaming audio enhancement (JAX ``inference/enhancer.py``).

The per-batch pipeline: peak normalize -> STFT with magnitude (kernel K1 on
CUDA, or K1g at a geometry K1 does not take) -> phase -> max-only magnitude
normalize -> HybridViT (attention through kernel K2 on CUDA) -> mask or
magnitude denorm -> do-no-harm blend -> noisy-phase iSTFT (kernel K3 on
CUDA, or K3g) -> output denorm, optionally with PCM16 in and out. The STFT
geometry is the config's ``audio`` section.

CMGAN's generator (``models.cmgan.TSCNet``) has its own front and back end
(``_cmgan_core``; the enhancer binds one core or the other when it is
built): each row scaled to unit RMS over its
true length, the STFT (K1), the complex spectrum power-compressed
(``|X|^0.3`` at the noisy phase) as ``[B, 2, T, F]``, the model with the
padded frames masked (K2r), the output decompressed (``|Y|^(1/0.3)`` at its
own phase), the iSTFT (K3), the scale undone. It takes no blend.
SEMamba's generator (``models.semamba.SEMamba``) has MP-SENet's front and
back end (``_semamba_core``): the same RMS scale and STFT, the model's input
``(sqrt(re^2 + im^2 + 1e-9)^0.3, atan2(im + 1e-10, re + 1e-5))`` (0.3 the
model's ``compress_factor``), its output magnitude decompressed and put at
its output phase by the iSTFT (K3), the scale undone; no blend either.

Waveforms are padded to length buckets; clips longer than the largest bucket
go through chunked overlap-add streaming.

On CUDA a batch is dispatched without waiting for the device: its input is
staged in pinned host memory and copied with ``non_blocking=True`` (a copy
from pageable memory would first wait for every kernel queued on the
stream), and its output is copied into pinned host memory right after its
own kernels, followed by a CUDA event. ``enhance_batch_async`` returns that
``PendingBatch``, so a caller can dispatch the next batch before it reads
this one; the blocking paths read theirs at once.

Each batch counts its true and padded samples (``enhance.*`` counters),
and with the recorder on its dispatch and its result are spans under one
batch id (``utils/tracing.py``).

With a ``mesh`` (``parallel.mesh_for_data_parallel``; JAX ``mesh=``) the
enhancer keeps one replica of the model on each device of the data axis.
A batch's rows are padded to a multiple of the replicas and split into
contiguous parts, one a replica, each run on its device's own stream; every
part is dispatched before any is waited on, and the rows come back in order.
"""

from __future__ import annotations

import copy
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.dataset import DEFAULT_BUCKETS, bucket_for_frames, frames_needed
from ..data.wavio import load_audio, save_wav, wav_info
from ..models import create_model
from ..models.cmgan import TSCNet
from ..models.components import patch_validity_mask
from ..models.fold import fold_batchnorm
from ..models.semamba import SEMamba
from ..ops.cuda_stft import istft_polar, stft_mag
from ..ops.stft import STFTConfig
from ..utils import tracing
from ..utils.checkpoint import load_model_weights, read_meta


class PendingBatch:
    """One batch that ``enhance_batch_async`` dispatched. ``result()`` waits
    for this batch alone and returns its rows ``[B, padded_len]`` float32
    on the host; the caller trims each row to its clip's length.

    ``hosts`` are the parts of the output, one a replica, in row order, and
    ``rows`` the batch's own rows (the rest pad the replicas' parts). On
    CUDA each part is the pinned host tensor that its device-to-host copy
    fills, and ``events`` the CUDA events recorded after those copies, which
    ``result()`` waits on; on the CPU the parts are finished and ``events``
    is empty. The parts stay referenced here until the batch is read, so a
    pinned buffer is not reused while the copy into it is in flight (the
    pinned input buffers are held the same way by PyTorch's caching host
    allocator, which records the copy's stream). ``id`` is the batch's id
    in the recorder's spans."""

    def __init__(self, hosts: List[torch.Tensor], events: List[torch.cuda.Event], rows: int,
                 id: Optional[int] = None):
        self.hosts = hosts
        self.events = events
        self.rows = rows
        self.id = id

    def result(self) -> np.ndarray:
        with tracing.span("enhance.result", self.id):
            with tracing.span("enhance.wait"):
                for event in self.events:
                    event.synchronize()
            with tracing.span("enhance.unpack"):
                out = self.hosts[0].numpy() if len(self.hosts) == 1 else np.concatenate(
                    [h.numpy() for h in self.hosts])
                out = out[: self.rows]
                if out.dtype == np.int16:
                    out = out.astype(np.float32) / 32767.0
            return out


class EnhancerCore(torch.nn.Module):
    """An enhancer's core as a module: ``forward(noisy, lengths)`` is
    ``AudioEnhancer._core`` on the enhancer's own model and blend
    (``noisy [B, wav_len]``, PCM16 in and out when it is int16, as the
    enhancer stages it under ``io_dtype='int16'``; ``lengths [B]`` true
    sample counts). The JAX enhancer exports its
    per-length jitted ``_core``; this is what
    ``utils.checkpoint.export_program`` takes for the same program:
    ``export_program(path, EnhancerCore(enhancer), (noisy, lengths))``."""

    def __init__(self, enhancer: "AudioEnhancer"):
        super().__init__()
        self.model = enhancer.model
        self._enhancer = enhancer

    def forward(self, noisy: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        return self._enhancer._core(noisy, lengths, self.model)


class AudioEnhancer:
    """Speech enhancer around a HybridViT with loaded weights.

    ``device`` is where the model and every batch run: ``"cuda"`` launches
    the kernels, ``"cpu"`` runs their plain versions. The model is moved
    there and put in eval mode.

    ``mask_padding=True`` excludes bucket-padding patches from attention.
    ``blend``: 1.0 is the raw model output, a float in [0, 1) mixes
    ``blend*enhanced + (1-blend)*noisy`` magnitudes, ``"snr_adaptive"``
    backs off per clip where the model's own SNR estimate is high. ``None``
    adopts the checkpoint's fitted ``inference.blend`` for magnitude-head
    models, else 1.0. ``fold_bn=True`` enhances with a copy of the model
    whose eval-mode BatchNorm is folded into its convs (``models/fold.py``;
    equal to the unfolded output to fp32 rounding).

    ``mesh``: one replica of the model on each of ``mesh.replicas`` (the
    module docstring); ``device`` is then the replicas' device type.

    A CMGAN ``TSCNet`` or a ``SEMamba`` runs its own front and back end (the
    module docstring); ``mask_padding`` masks its padded frames, and a
    ``blend`` other than 1.0 is refused.

    ``dft_precision`` (``"highest"``, ``"high"`` or ``"default"``) is the JAX
    enhancer's precision of its reconstruction matmul: ``high`` and
    ``default`` permit less precision and do not demand it. The
    reconstruction here computes in float32 whatever is set: kernel K3 is an
    fp32 FFT on the card, and the plain matmul path on the CPU is float32,
    as the JAX package's matmuls are on the CPU.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        config: Optional[Dict] = None,
        *,
        device: str | torch.device,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        io_dtype: str = "float32",
        mask_padding: bool = False,
        blend: float | str | None = None,
        blend_min: float = 0.3,
        blend_pivot_db: float = 18.0,
        blend_width_db: float = 4.0,
        fold_bn: bool = False,
        dft_precision: str = "highest",
        mesh=None,
    ):
        if dft_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"dft_precision must be highest|high|default, got {dft_precision!r}"
            )
        self.dft_precision = dft_precision
        self.device = torch.device(device)
        if fold_bn:
            model = fold_batchnorm(model)
        self.replicas = None
        if mesh is not None:
            devices = [torch.device(d) for d in mesh.replicas]
            if any(d.type != self.device.type for d in devices):
                raise ValueError(f"mesh devices {devices} are not of device {self.device}")
            self.device = devices[0]
            models = [model] + [copy.deepcopy(model) for _ in devices[1:]]
            self.replicas = [
                (d, m.to(d).eval(),
                 torch.cuda.Stream(device=d) if d.type == "cuda" else None)
                for d, m in zip(devices, models)
            ]
        self.model = model.to(self.device).eval()
        self.config = config or {}
        audio_cfg = self.config.get("audio", {})
        self.stft_cfg = STFTConfig(
            n_fft=audio_cfg.get("n_fft", 512),
            hop_length=audio_cfg.get("hop_length", 128),
            win_length=audio_cfg.get("win_length", 512),
            window=audio_cfg.get("window", "hann"),
        )
        self.sample_rate = audio_cfg.get("sample_rate", 16000)
        self.buckets = tuple(buckets)
        self.output_mode = self.config.get("model", {}).get("output_mode", "magnitude")
        if self.output_mode not in ("magnitude", "mask"):
            raise ValueError(
                f"model.output_mode must be 'magnitude' or 'mask', got {self.output_mode!r}"
            )
        if io_dtype not in ("float32", "int16"):
            raise ValueError(f"io_dtype must be float32|int16, got {io_dtype}")
        self.io_dtype = io_dtype
        self.mask_padding = bool(mask_padding)
        arch_core = {TSCNet: self._cmgan_core, SEMamba: self._semamba_core}.get(type(model))
        if arch_core is not None:
            self._arch_core = arch_core
            if blend not in (None, 1.0):
                raise ValueError(f"blend {blend!r}: {type(model).__name__}'s enhancer takes no "
                                 "blend (1.0 only)")
            self.blend, self.blend_min, self.blend_pivot_db, self.blend_width_db = (
                1.0, float(blend_min), float(blend_pivot_db), float(blend_width_db))
            return
        self._arch_core = self._hvit_core
        meta_blend = self.config.get("inference", {}).get("blend")
        if not isinstance(meta_blend, dict):
            meta_blend = {}
        if blend is None:
            if self.output_mode == "magnitude" and meta_blend.get("mode") == "snr_adaptive":
                blend = "snr_adaptive"
                blend_min = float(meta_blend.get("min", blend_min))
                blend_pivot_db = float(meta_blend.get("pivot_db", blend_pivot_db))
                blend_width_db = float(meta_blend.get("width_db", blend_width_db))
                print(
                    "note: using the checkpoint's fitted snr_adaptive "
                    f"blend (min={blend_min:g}, pivot={blend_pivot_db:g} dB, "
                    f"width={blend_width_db:g} dB); pass --blend 1.0 for "
                    "raw reference-parity output"
                )
            else:
                blend = 1.0
        if not (blend == "snr_adaptive" or (
            isinstance(blend, (int, float)) and 0.0 <= float(blend) <= 1.0
        )):
            raise ValueError(
                f"blend must be a float in [0,1] or 'snr_adaptive', got {blend!r}"
            )
        if self.output_mode == "magnitude" and blend == 1.0:
            warnings.warn(
                "magnitude-head checkpoint served with blend=1.0: this "
                "configuration measurably harms already-clean input; pass "
                "--blend snr_adaptive or fit do-no-harm parameters into the "
                "checkpoint's meta.json (the mask-head recipe does not need "
                "this mitigation).",
                UserWarning,
                stacklevel=2,
            )
        self.blend = blend
        self.blend_min = float(blend_min)
        self.blend_pivot_db = float(blend_pivot_db)
        self.blend_width_db = float(blend_width_db)

    # ------------------------------------------------------------------
    def _patch_mask(self, mag_shape, lengths: torch.Tensor) -> torch.Tensor:
        return patch_validity_mask(
            lengths,
            int(mag_shape[-2]),
            int(mag_shape[-1]),
            self.stft_cfg.hop_length,
            pool_sizes=getattr(self.model, "encoder_pool_sizes", (2, 2, 1)),
            patch_size=getattr(self.model, "patch_size", 4),
        )

    def _apply_blend(self, enhanced_mag: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
        """Do-no-harm blend: magnitude-domain mix with the noisy magnitude
        (with the shared noisy phase and a linear iSTFT this equals the
        waveform-domain mix)."""
        if self.blend == "snr_adaptive":
            sig = torch.sum(enhanced_mag * enhanced_mag, dim=(-2, -1), keepdim=True)
            diff = mag - enhanced_mag
            res = torch.sum(diff * diff, dim=(-2, -1), keepdim=True)
            est_snr = 10.0 * torch.log10(
                torch.clamp(sig, min=1e-12) / torch.clamp(res, min=1e-12)
            )
            alpha = self.blend_min + (1.0 - self.blend_min) * torch.sigmoid(
                (self.blend_pivot_db - est_snr) / self.blend_width_db
            )
            return alpha * enhanced_mag + (1.0 - alpha) * mag
        if float(self.blend) != 1.0:
            a = float(self.blend)
            return a * enhanced_mag + (1.0 - a) * mag
        return enhanced_mag

    def _denoise(self, mag: torch.Tensor, phase: torch.Tensor, wav_len: int,
                 mask: Optional[torch.Tensor], model: torch.nn.Module) -> torch.Tensor:
        """Spectrogram -> waveform: max-normalize, model, denorm, blend,
        noisy-phase iSTFT."""
        mag_max = torch.amax(mag, dim=(-2, -1), keepdim=True)
        mag_max = torch.where(mag_max > 1e-8, mag_max, torch.ones_like(mag_max))
        out = model((mag / mag_max)[..., None], mask=mask)[..., 0]
        if self.output_mode == "mask":
            enhanced_mag = torch.clamp((out + 1.0) * 0.5, 0.0, 1.0) * mag
        else:
            enhanced_mag = out * mag_max
        enhanced_mag = self._apply_blend(enhanced_mag, mag)
        return istft_polar(enhanced_mag.contiguous(), phase, self.stft_cfg, length=wav_len)

    def _hvit_core(self, x: torch.Tensor, lengths: Optional[torch.Tensor],
                   model: torch.nn.Module, host_lens: Optional[np.ndarray]) -> torch.Tensor:
        """The HybridViT's front end, model and back end on float ``x [B,
        wav_len]``: with ``lengths`` each row peak-normalised (and, with
        ``mask_padding``, its padding patches masked) and the scale undone
        on the output; ``host_lens`` is unused."""
        scale = None
        if lengths is not None:
            max_val = torch.amax(x.abs(), dim=-1, keepdim=True)
            scale = torch.where(max_val > 1e-8, max_val, torch.ones_like(max_val))
            x = (x / scale).contiguous()
        re, im, mag = stft_mag(x, self.stft_cfg)
        phase = torch.atan2(im, re)
        mask = (self._patch_mask(mag.shape, lengths)
                if lengths is not None and self.mask_padding else None)
        y = self._denoise(mag, phase, x.shape[-1], mask, model)
        return y if scale is None else y * scale

    @staticmethod
    def _rms_scale(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
        """Each row's factor to unit RMS over its true length (1 for a
        silent row, or where ``lengths`` is None), ``[B, 1]``."""
        if lengths is None:
            return torch.ones_like(x[:, :1])
        energy = torch.sum(x * x, dim=-1, keepdim=True)
        return torch.where(energy > 0, torch.sqrt(lengths[:, None].to(x.dtype) / energy),
                           torch.ones_like(energy))

    def _frames(self, lengths: Optional[torch.Tensor], host_lens: Optional[np.ndarray]):
        """``(n_valid, kept)``: with ``lengths`` and ``mask_padding``, each
        row's valid frames ``1 + length // hop`` on the device and, where
        ``host_lens`` (the same lengths on the host) is given, their sum for
        the model's counters; else None."""
        if lengths is None or not self.mask_padding:
            return None, None
        hop = self.stft_cfg.hop_length
        kept = None if host_lens is None else int((1 + host_lens.astype(np.int64) // hop).sum())
        return 1 + lengths.to(torch.int64) // hop, kept

    def _cmgan_core(self, x: torch.Tensor, lengths: Optional[torch.Tensor],
                    model: torch.nn.Module, host_lens: Optional[np.ndarray]) -> torch.Tensor:
        """CMGAN's front end, model and back end on float ``x [B, wav_len]``:
        with ``lengths`` each row scaled to unit RMS over its true length
        (a silent row by 1) and, with ``mask_padding``, frames from
        ``1 + length // hop`` on masked; ``host_lens`` (the same lengths on
        the host) feeds the model's counters."""
        c = self._rms_scale(x, lengths)
        re, im, mag = stft_mag((x * c).contiguous(), self.stft_cfg)
        phase = torch.atan2(im, re)
        mag = mag ** 0.3
        spec = torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)], dim=1)
        y_re, y_im = model(spec.transpose(2, 3), *self._frames(lengths, host_lens))
        y_re, y_im = y_re[:, 0].transpose(1, 2), y_im[:, 0].transpose(1, 2)
        y_mag = torch.sqrt(y_re * y_re + y_im * y_im) ** (1.0 / 0.3)
        y = istft_polar(y_mag.contiguous(), torch.atan2(y_im, y_re).contiguous(), self.stft_cfg,
                        length=x.shape[-1])
        return y / c

    def _semamba_core(self, x: torch.Tensor, lengths: Optional[torch.Tensor],
                      model: torch.nn.Module, host_lens: Optional[np.ndarray]) -> torch.Tensor:
        """SEMamba's front end (MP-SENet's ``mag_pha_stft`` on the recipe's
        centred, reflect-padded STFT), model and back end on float ``x [B,
        wav_len]``, scaled and masked as CMGAN's core scales and masks."""
        c = self._rms_scale(x, lengths)
        re, im, _ = stft_mag((x * c).contiguous(), self.stft_cfg)
        # imaginary parts that are 0 in exact arithmetic: bin 0 and n_fft / 2
        # of every frame, and every bin of the first frame (reflect padding
        # makes it even about its centre, and the Hann window keeps it so).
        # The FFT leaves rounding there, whose sign would put the phase input
        # at +pi or -pi where re < 0, so they are set to their exact 0
        im[:, 0] = 0.0
        if self.stft_cfg.n_fft % 2 == 0:
            im[:, -1] = 0.0
        im[:, :, 0] = 0.0
        mag = torch.sqrt(re * re + im * im + 1e-9) ** model.compress_factor
        pha = torch.atan2(im + 1e-10, re + 1e-5)
        y_mag, y_pha = model(torch.stack([mag, pha], dim=1).transpose(2, 3),
                             *self._frames(lengths, host_lens))
        y_mag = y_mag[:, 0].transpose(1, 2) ** (1.0 / model.compress_factor)
        y = istft_polar(y_mag.contiguous(), y_pha[:, 0].transpose(1, 2).contiguous(),
                        self.stft_cfg, length=x.shape[-1])
        return y / c

    def _core(self, noisy: torch.Tensor, lengths: Optional[torch.Tensor],
              model: torch.nn.Module, host_lens: Optional[np.ndarray] = None) -> torch.Tensor:
        """The enhancement core on one padded batch on ``model``'s device:
        ``noisy [B, wav_len]``, float or int16 PCM (then PCM16 out too);
        ``lengths [B]`` true sample counts, or None for the unnormalised
        path (no normalisation, no mask); ``host_lens`` the same counts on
        the host, for CMGAN's and SEMamba's counters."""
        io16 = noisy.dtype == torch.int16
        if io16:
            noisy = noisy.to(torch.float32) / 32768.0
        y = self._arch_core(noisy, lengths, model, host_lens)
        if io16:
            return (torch.clamp(y, -1.0, 1.0) * 32767.0).to(torch.int16)
        return y

    def _padded_len(self, n_samples: int) -> int:
        frames = frames_needed(max(n_samples, 1), self.stft_cfg.hop_length)
        bucket = bucket_for_frames(frames, self.buckets)
        return (bucket - 1) * self.stft_cfg.hop_length

    @property
    def max_samples(self) -> int:
        """Largest waveform the bucketed batch path holds without
        truncation; longer clips go to ``enhance_streaming``."""
        return (self.buckets[-1] - 1) * self.stft_cfg.hop_length

    @staticmethod
    def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
        t = torch.from_numpy(a)
        if device.type != "cuda":
            return t
        staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        staged.copy_(t)
        return staged.to(device, non_blocking=True)

    def _launch(self, batch: np.ndarray, lens: np.ndarray, normalize: bool,
                model: torch.nn.Module, device: torch.device):
        """Enqueue ``batch`` on ``device``'s current stream: ``(host output,
        CUDA event after its copy, or None on the CPU)``."""
        with tracing.span("enhance.stage"):
            x = self._to_device(batch, device)
            n = self._to_device(lens, device) if normalize else None
        with tracing.span("enhance.launch"):
            out = self._core(x, n, model, lens)
        if device.type != "cuda":
            return out, None
        with tracing.span("enhance.d2h"):
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return host, event

    @staticmethod
    def _count(lens: np.ndarray, wav_len: int) -> int:
        """Count one batch of clips ``lens`` padded to ``wav_len``; returns
        its id."""
        tracing.count("enhance.true_samples", int(lens.sum()))
        tracing.count("enhance.padded_samples", len(lens) * wav_len)
        return tracing.count("enhance.batches")

    @torch.inference_mode()
    def _dispatch(self, batch: np.ndarray, lens: np.ndarray, normalize: bool,
                  id: Optional[int] = None) -> PendingBatch:
        """Enqueue one padded batch (see the module docstring) and return
        without waiting for the device."""
        rows = batch.shape[0]
        if self.replicas is None:
            host, event = self._launch(batch, lens, normalize, self.model, self.device)
            return PendingBatch([host], [event] if event is not None else [], rows, id)
        n = len(self.replicas)
        part = -(-rows // n)
        if part * n > rows:  # zero rows of length 1 pad the last replica's part
            batch = np.concatenate([batch, np.zeros((part * n - rows,) + batch.shape[1:],
                                                    batch.dtype)])
            lens = np.concatenate([lens, np.ones(part * n - rows, lens.dtype)])
        hosts, events = [], []
        for i, (device, model, stream) in enumerate(self.replicas):
            rows_i = slice(i * part, (i + 1) * part)
            if stream is None:
                host, _ = self._launch(batch[rows_i], lens[rows_i], normalize, model, device)
            else:
                # the replica's own stream, after what its device's stream has
                # queued (its weights' copy among it)
                stream.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.device(device), torch.cuda.stream(stream):
                    host, event = self._launch(batch[rows_i], lens[rows_i], normalize, model,
                                               device)
                events.append(event)
            hosts.append(host)
        return PendingBatch(hosts, events, rows, id)

    # ------------------------------------------------------------------
    def enhance(self, noisy_audio: np.ndarray, normalize: bool = True,
                exact: bool = False) -> np.ndarray:
        """Enhance one waveform. ``exact=True`` processes it at its exact
        length (no bucket padding)."""
        if not exact and len(noisy_audio) > self.max_samples:
            return self.enhance_streaming(noisy_audio)
        if not exact:
            return self.enhance_batch([noisy_audio], normalize=normalize)[0]
        x = np.asarray(noisy_audio, np.float32)[None, :]
        if normalize and self.io_dtype == "int16":
            x = (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)
        lens = np.full((1,), x.shape[-1], np.int32)
        bid = self._count(lens, x.shape[-1])
        with tracing.span("enhance.dispatch", bid):
            pending = self._dispatch(x, lens, normalize, bid)
        return pending.result()[0]

    def enhance_batch_async(self, wavs: List[np.ndarray], normalize: bool = True) -> PendingBatch:
        """Pad one batch to its length bucket and dispatch it without waiting
        for the device (JAX ``enhance_batch_async``, which returns the device
        array). Returns a ``PendingBatch``: its ``result()`` is the
        ``[len(wavs), padded_len]`` float32 output on the host; trim each row
        to its clip's length. Every waveform must fit the largest bucket
        (``max_samples``); route longer clips to ``enhance`` or
        ``enhance_streaming``."""
        longest = max(len(w) for w in wavs)
        if longest > self.max_samples:
            raise ValueError(
                f"waveform of {longest} samples exceeds the largest bucket "
                f"({self.max_samples} samples ≈ "
                f"{self.max_samples / self.sample_rate:.2f}s); use "
                f"enhance()/enhance_streaming() for long clips"
            )
        wav_len = self._padded_len(longest)
        io16 = self.io_dtype == "int16" and normalize
        lens = np.array([len(w) for w in wavs], np.int32)
        bid = self._count(lens, wav_len)
        with tracing.span("enhance.dispatch", bid):
            with tracing.span("enhance.pad"):
                batch = np.zeros((len(wavs), wav_len), np.int16 if io16 else np.float32)
                for row, w in enumerate(wavs):
                    w = np.asarray(w, np.float32)
                    batch[row, : len(w)] = (
                        (np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16) if io16 else w
                    )
            return self._dispatch(batch, lens, normalize, bid)

    def enhance_batch(self, wavs: List[np.ndarray], normalize: bool = True) -> List[np.ndarray]:
        """Enhance a list of waveforms as one padded batch; clips longer than
        the largest bucket go through chunked streaming."""
        if not wavs:
            return []
        fits = [i for i, w in enumerate(wavs) if len(w) <= self.max_samples]
        fit_set = set(fits)
        results: List[Optional[np.ndarray]] = [None] * len(wavs)
        if fits:
            out = self.enhance_batch_async([wavs[i] for i in fits], normalize).result()
            for row, i in enumerate(fits):
                results[i] = out[row, : len(wavs[i])].copy()
        for i in range(len(wavs)):
            if i not in fit_set:
                results[i] = self.enhance_streaming(np.asarray(wavs[i], np.float32))
        return results

    def enhance_streaming(
        self,
        noisy_audio: np.ndarray,
        chunk_seconds: float = 2.0,
        overlap_seconds: float = 0.25,
        batch_chunks: int = 8,
    ) -> np.ndarray:
        """Chunked overlap-add enhancement for long audio: fixed chunks with
        overlap, enhanced in batches, crossfaded with a linear ramp."""
        sr = self.sample_rate
        chunk = min(int(chunk_seconds * sr), self.max_samples)
        overlap = min(int(overlap_seconds * sr), chunk // 2)
        hop = chunk - overlap
        x = np.asarray(noisy_audio, np.float32)
        if len(x) <= chunk:
            return self.enhance(x)
        starts = list(range(0, max(len(x) - overlap, 1), hop))
        chunks = []
        for s in starts:
            c = x[s : s + chunk]
            if len(c) < chunk:
                c = np.pad(c, (0, chunk - len(c)))
            chunks.append(c)
        enhanced: List[np.ndarray] = []
        for i in range(0, len(chunks), batch_chunks):
            enhanced.extend(self.enhance_batch(chunks[i : i + batch_chunks]))
        out = np.zeros(starts[-1] + chunk, np.float32)
        weight = np.zeros_like(out)
        ramp = np.ones(chunk, np.float32)
        if overlap > 0:
            ramp[:overlap] = np.linspace(0.0, 1.0, overlap, endpoint=False)
            ramp[-overlap:] = np.linspace(1.0, 0.0, overlap, endpoint=False)
        for s, e in zip(starts, enhanced):
            out[s : s + chunk] += e * ramp
            weight[s : s + chunk] += ramp
        out = out / np.maximum(weight, 1e-8)
        return out[: len(x)]

    def enhance_file(self, input_path: str | Path, output_path: str | Path) -> np.ndarray:
        """Enhance a WAV file into another (PCM16)."""
        audio, sr = load_audio(input_path, self.sample_rate)
        enhanced = self.enhance(audio)
        save_wav(output_path, enhanced, sr)
        return enhanced

    def enhance_directory(
        self,
        input_dir: str | Path,
        output_dir: str | Path,
        pattern: str = "*.wav",
        batch_size: int = 8,
        window_batches: int = 4,
    ) -> int:
        """Enhance every ``pattern`` file of ``input_dir`` into a PCM16 file
        of the same name under ``output_dir``, in padded batches; returns the
        number of files. Memory is bounded: the files are length-sorted from
        their WAV headers alone (``wav_info``), then loaded, enhanced and
        written in windows of ``window_batches * batch_size`` files, so at
        most one window of audio is on the host at a time."""
        input_dir, output_dir = Path(input_dir), Path(output_dir)
        files = sorted(input_dir.glob(pattern))
        lengths = [wav_info(f)[0] for f in files]
        order = np.argsort(lengths, kind="stable")
        window = max(1, window_batches) * batch_size
        for w0 in range(0, len(order), window):
            idx = order[w0 : w0 + window]
            loaded = {j: load_audio(files[j], self.sample_rate)[0] for j in idx}
            for i in range(0, len(idx), batch_size):
                chunk = idx[i : i + batch_size]
                outs = self.enhance_batch([loaded[j] for j in chunk])
                for j, out in zip(chunk, outs):
                    save_wav(output_dir / files[j].name, out, self.sample_rate)
        return len(files)


def load_model_for_inference(
    checkpoint_path: str | Path,
    config: Optional[Dict] = None,
    *,
    device: str | torch.device,
):
    """Build the model from the checkpoint's ``meta.json`` config and load
    its weights onto ``device``. The checkpoint's ``model``/``audio``/
    ``spectrogram`` sections override the caller's; runtime sections stay
    the caller's. Returns ``(model, merged_config)``; build the
    ``AudioEnhancer`` from the merged config."""
    config = dict(config or {})
    saved = read_meta(checkpoint_path).get("config", {})
    if not isinstance(saved, dict):
        saved = {}
    for section in ("model", "audio", "spectrogram"):
        if isinstance(saved.get(section), dict) and saved[section]:
            if config.get(section) and config[section] != saved[section]:
                print(
                    f"note: using the checkpoint's '{section}' config "
                    "(weights must match the trained architecture)"
                )
            config[section] = saved[section]
    model = create_model(config)
    load_model_weights(checkpoint_path, model)
    return model.to(device).eval(), config


def enhance_audio(
    noisy_audio: np.ndarray,
    checkpoint_path: str | Path,
    config: Optional[Dict] = None,
    *,
    device: str | torch.device,
) -> np.ndarray:
    """Enhance one waveform with the checkpoint's model on ``device``."""
    model, config = load_model_for_inference(checkpoint_path, config, device=device)
    return AudioEnhancer(model, config, device=device).enhance(noisy_audio)


def enhance_file(
    input_path: str | Path,
    output_path: str | Path,
    checkpoint_path: str | Path,
    config: Optional[Dict] = None,
    *,
    device: str | torch.device,
) -> np.ndarray:
    """Enhance a WAV file into another (PCM16) with the checkpoint's model
    on ``device``."""
    model, config = load_model_for_inference(checkpoint_path, config, device=device)
    return AudioEnhancer(model, config, device=device).enhance_file(input_path, output_path)
