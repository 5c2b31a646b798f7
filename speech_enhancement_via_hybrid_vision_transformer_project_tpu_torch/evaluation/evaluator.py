"""Dataset evaluation (JAX ``evaluation/evaluator.py``): enhance and score a
paired test set such as VoiceBank-DEMAND's.

* Enhancement reuses the ``AudioEnhancer``: padded batches over
  length-sorted windows, with two batches in flight on the device
  (``enhance_batch_async``) while the host loads audio, scores the batch
  before them and writes WAVs. Clips longer than the largest bucket go
  through chunked streaming; ``exact=True`` enhances each clip alone at its
  own length.
* Metrics run on the host, in this process or in a spawn-context process
  pool that the ``Evaluator`` owns (``close()`` ends it). Pool and serial
  scoring give identical results.
* ``nan`` metrics (a PESQ that failed) are excluded from aggregation rather
  than averaged in.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..data.wavio import load_audio, save_wav, wav_info
from ..inference.enhancer import AudioEnhancer
from .metrics import compute_all_metrics, metrics_pool_init, metrics_task, pesq_implementation

METRIC_KEYS = ("pesq", "stoi", "si_sdr", "snr", "seg_snr", "lsd", "lsd_db")


def default_metric_workers() -> int:
    """``max(1, min(8, cpu_count - 2))``: two cores stay with the pipeline
    (audio decode, batch dispatch, WAV writes), so a host of 3 cores or
    fewer scores serially."""
    return max(1, min(8, (os.cpu_count() or 1) - 2))


class Evaluator:
    """Enhance and score paired (noisy, clean) WAV directories."""

    def __init__(self, enhancer: AudioEnhancer, sample_rate: int = 16000,
                 include_pesq: bool = True):
        self.enhancer = enhancer
        self.sample_rate = sample_rate
        self.include_pesq = include_pesq
        self._pool = None
        self._pool_size = 0
        # diagnostics of the last evaluate_dataset, asserted in tests
        self.last_peak_files_in_memory = 0
        self.last_peak_pending_metrics = 0

    def _metric_pool(self, workers: int):
        """The process pool of ``workers`` scorers, created on first use and
        kept for later sweeps. Spawned, not forked: a fork of a process that
        holds a CUDA context is unsafe. A worker imports only the metrics
        module (numpy and scipy)."""
        if self._pool is not None and self._pool_size != workers:
            self.close()
        if self._pool is None:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            self._pool = ProcessPoolExecutor(
                max_workers=workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=metrics_pool_init,
            )
            self._pool_size = workers
        return self._pool

    def close(self) -> None:
        """End the metric pool's worker processes, if any."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool, self._pool_size = None, 0

    def __enter__(self) -> "Evaluator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    def evaluate_pair(self, noisy: np.ndarray, clean: np.ndarray,
                      enhanced: Optional[np.ndarray] = None) -> Dict[str, float]:
        """Metrics for one utterance (enhanced here unless given)."""
        if enhanced is None:
            enhanced = self.enhancer.enhance(noisy)
        return compute_all_metrics(clean, enhanced, noisy, self.sample_rate,
                                   include_pesq=self.include_pesq)

    # ------------------------------------------------------------------
    def evaluate_dataset(
        self,
        noisy_dir: str | Path,
        clean_dir: str | Path,
        output_dir: Optional[str | Path] = None,
        batch_size: int = 8,
        max_files: Optional[int] = None,
        progress: bool = True,
        exact: bool = False,
        window_batches: int = 4,
        metric_workers: Optional[int] = None,
    ) -> Dict[str, Dict]:
        """Sweep a test set: pair files by name, enhance in batches, score
        each file, aggregate mean and std. Returns ``{"summary": ...,
        "per_file": {name: metrics}}``; ``summary["_meta"]`` holds the
        sweep's audio-seconds per second of wall time (on CUDA after a
        warm-up batch of every bucket the sweep uses), the metric workers,
        the device and which PESQ implementation scored.

        Host memory is bounded: clips are length-sorted from their WAV
        headers alone, then loaded, enhanced, scored and written in windows
        of ``window_batches * batch_size`` files, so at most one window of
        noisy and clean audio is loaded at a time
        (``last_peak_files_in_memory``).

        ``metric_workers``: size of the metric process pool; ``None`` takes
        ``default_metric_workers()``, ``max(1, min(8, cpu_count - 2))``; 0 or
        1 scores serially in this process. At most one window of files
        waits in the pool (``last_peak_pending_metrics``): submitting
        another first waits for the oldest, and finished rows are drained
        once per window of files, in ``exact`` mode too."""
        noisy_dir, clean_dir = Path(noisy_dir), Path(clean_dir)
        files = [f for f in sorted(noisy_dir.glob("*.wav")) if (clean_dir / f.name).exists()]
        if max_files:
            files = files[:max_files]
        if not files:
            raise FileNotFoundError(f"no paired wavs under {noisy_dir}")
        sr = self.sample_rate

        lengths = np.asarray([wav_info(f)[0] for f in files])
        order = np.argsort(lengths, kind="stable")
        # clips beyond the largest bucket stream: padding would cut them
        cap = self.enhancer.max_samples
        long_idx = [j for j in order if lengths[j] > cap]
        if not exact:
            order = np.asarray([j for j in order if lengths[j] <= cap], order.dtype)
        window = max(1, window_batches) * batch_size

        per_file: Dict[str, Dict[str, float]] = {}
        self.last_peak_files_in_memory = 0
        self.last_peak_pending_metrics = 0
        if metric_workers is None:
            metric_workers = default_metric_workers()
        pool = self._metric_pool(metric_workers) if metric_workers > 1 else None
        futures: Dict[str, object] = {}
        if pool is not None:
            pool.submit(int, 0)  # the workers spawn and import beside the warm-up

        def drain(block: bool = False) -> None:
            for name in list(futures):
                if block or futures[name].done():
                    per_file[name] = futures.pop(name).result()

        def score(j: int, noisy: np.ndarray, clean: np.ndarray, enh: np.ndarray) -> None:
            name = files[j].name
            if pool is None:
                per_file[name] = self.evaluate_pair(noisy, clean, enhanced=enh)
            else:
                while len(futures) >= window:  # a waiting task holds its audio
                    oldest = next(iter(futures))
                    per_file[oldest] = futures.pop(oldest).result()
                futures[name] = pool.submit(metrics_task,
                                            (clean, enh, noisy, sr, self.include_pesq))
                self.last_peak_pending_metrics = max(self.last_peak_pending_metrics,
                                                     len(futures))
            if output_dir is not None:
                save_wav(Path(output_dir) / name, enh, sr)

        def load(j: int) -> tuple[np.ndarray, np.ndarray]:
            return (load_audio(files[j], sr)[0], load_audio(clean_dir / files[j].name, sr)[0])

        if not exact and self.enhancer.device.type == "cuda":
            # one batch per bucket the sweep uses, before the clock starts
            # (from header lengths, no audio decoded): kernel builds, cuDNN's
            # first calls and pinned-buffer growth are not the sweep's
            # throughput (the CPU has none of these to warm)
            seen = set()
            for j in order:
                wav_len = self.enhancer._padded_len(int(lengths[j]))
                if wav_len not in seen:
                    seen.add(wav_len)
                    warm = np.zeros(int(lengths[j]), np.float32)
                    warm[:: sr // 100] = 0.5
                    self.enhancer.enhance_batch_async([warm] * batch_size).result()

        t0 = time.perf_counter()
        done = 0

        def progress_tick(n: int) -> None:
            nonlocal done
            done += n
            if progress:
                print(f"\r[eval] {done}/{len(files)} files", end="", flush=True)

        if exact:
            # each clip alone at its own length, one pair loaded at a time
            for n, j in enumerate(order, 1):
                noisy, clean = load(j)
                self.last_peak_files_in_memory = max(self.last_peak_files_in_memory, 2)
                score(j, noisy, clean, self.enhancer.enhance(noisy, exact=True))
                progress_tick(1)
                if n % window == 0:
                    drain()
        else:
            for w0 in range(0, len(order), window):
                widx = order[w0 : w0 + window]
                loaded = {j: load(j) for j in widx}
                self.last_peak_files_in_memory = max(self.last_peak_files_in_memory,
                                                     2 * len(loaded))
                pending: deque = deque()

                def consume(idx, batch) -> None:
                    out = batch.result()  # waits for this batch alone
                    for row, j in enumerate(idx):
                        noisy, clean = loaded[j]
                        score(j, noisy, clean, out[row, : len(noisy)].copy())
                    progress_tick(len(idx))

                for i in range(0, len(widx), batch_size):
                    idx = widx[i : i + batch_size]
                    pending.append((idx, self.enhancer.enhance_batch_async(
                        [loaded[j][0] for j in idx])))
                    if len(pending) > 2:  # two batches stay in flight
                        consume(*pending.popleft())
                while pending:
                    consume(*pending.popleft())
                loaded.clear()
                drain()
            for j in long_idx:
                noisy, clean = load(j)
                self.last_peak_files_in_memory = max(self.last_peak_files_in_memory, 2)
                score(j, noisy, clean, self.enhancer.enhance_streaming(noisy))
                progress_tick(1)
        drain(block=True)
        if progress:
            print()
        elapsed = time.perf_counter() - t0

        audio_seconds = float(lengths.sum()) / sr
        summary = self.aggregate(per_file)
        summary["_by_input_snr"] = self.aggregate_by_input_snr(per_file)
        summary["_meta"] = {
            "num_files": float(len(files)),
            "audio_seconds": audio_seconds,
            "wall_seconds": float(elapsed),
            "audio_seconds_per_second": float(audio_seconds / max(elapsed, 1e-9)),
            "metric_workers": float(max(metric_workers, 1)),
            "device": str(self.enhancer.device),
        }
        if self.include_pesq:
            # ITU-scored and native-scored PESQ are not on one scale
            summary["_meta"]["pesq_impl"] = pesq_implementation()
        return {"summary": summary, "per_file": per_file}

    # ------------------------------------------------------------------
    @staticmethod
    def aggregate(per_file: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
        """Mean, std and count per metric, nan excluded."""
        keys = set()
        for m in per_file.values():
            keys.update(m.keys())
        out: Dict[str, Dict[str, float]] = {}
        for k in sorted(keys):
            vals = np.asarray([m[k] for m in per_file.values() if k in m], np.float64)
            vals = vals[np.isfinite(vals)]
            if len(vals):
                out[k] = {"mean": float(vals.mean()), "std": float(vals.std()),
                          "count": float(len(vals))}
        return out

    @staticmethod
    def aggregate_by_input_snr(
        per_file: Dict[str, Dict[str, float]],
        edges: tuple = (-5.0, 0.0, 5.0, 10.0, 15.0),
        keys: tuple = ("si_sdr_improvement", "snr_improvement", "stoi_improvement",
                       "lsd_improvement"),
    ) -> Dict[str, Dict[str, float]]:
        """Mean improvement per input-SNR bin, binned on each file's measured
        ``noisy_snr``: a model can help at -5 dB and hurt already-clean
        audio, which the dataset mean hides. Values outside the edges land
        in open-ended ``<lo`` and ``>=hi`` bins. ``count`` is the bin's
        clips; a metric with fewer finite values gets ``<metric>_count``."""
        out: Dict[str, Dict[str, list]] = {}
        labels = ([f"<{edges[0]:g}dB"]
                  + [f"[{lo:g},{hi:g})dB" for lo, hi in zip(edges, edges[1:])]
                  + [f">={edges[-1]:g}dB"])
        counts: Dict[str, int] = {}
        for m in per_file.values():
            s = m.get("noisy_snr")
            if s is None or not np.isfinite(s):
                continue
            bin_key = labels[int(np.searchsorted(np.asarray(edges), s, side="right"))]
            counts[bin_key] = counts.get(bin_key, 0) + 1
            bucket = out.setdefault(bin_key, {k: [] for k in keys})
            for k in keys:
                v = m.get(k)
                if v is not None and np.isfinite(v):
                    bucket[k].append(float(v))
        report: Dict[str, Dict[str, float]] = {}
        for bin_key in labels:
            if bin_key not in out:
                continue
            row: Dict[str, float] = {"count": float(counts[bin_key])}
            for k in keys:
                vals = out[bin_key][k]
                if vals:
                    row[k] = float(np.mean(vals))
                    if len(vals) != counts[bin_key]:
                        row[f"{k}_count"] = float(len(vals))
            report[bin_key] = row
        return report

    # ------------------------------------------------------------------
    @staticmethod
    def save_results(results: Dict, path: str | Path) -> Path:
        """Write the results as JSON (per-file rows included)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(results, indent=2, default=float))
        return path

    @staticmethod
    def format_report(results: Dict) -> str:
        """Human-readable report of ``evaluate_dataset``'s results."""
        summary = results.get("summary", results)
        lines = ["=" * 60, "Evaluation Report", "=" * 60]
        for k, stats in summary.items():
            if k.startswith("_"):
                continue
            if isinstance(stats, dict) and "mean" in stats:
                lines.append(f"{k:>24s}: {stats['mean']: .4f} ± {stats['std']:.4f}"
                             f"  (n={int(stats['count'])})")
        by_snr = summary.get("_by_input_snr", {})
        if by_snr:
            lines.append("-" * 60)
            lines.append("mean improvement by input SNR bin:")
            for bin_key, row in by_snr.items():
                parts = [f"{k.replace('_improvement', '')} {v:+.2f}"
                         for k, v in row.items() if k != "count"]
                lines.append(f"{bin_key:>14s} (n={int(row.get('count', 0))}): "
                             + "  ".join(parts))
        meta = summary.get("_meta", {})
        if meta:
            lines.append("-" * 60)
            lines.append(f"{'files':>24s}: {int(meta.get('num_files', 0))}")
            lines.append(f"{'throughput':>24s}: "
                         f"{meta.get('audio_seconds_per_second', 0.0):.2f} audio-s/s")
        lines.append("=" * 60)
        return "\n".join(lines)
