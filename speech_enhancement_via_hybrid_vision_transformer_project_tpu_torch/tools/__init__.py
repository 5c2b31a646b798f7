"""The measurement and quality tools, on the card or the CPU: the port's
counterparts of the repository's ``bench.py`` and ``benchmarks/`` scripts.
Each module takes the name of its JAX script and runs as
``python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.<name>``.

The measurement tools:

- ``bench``: ``bench.py``, enhancement throughput at batch 32 x 3 s, end to
  end and on the device alone, and ``mfu_pct``, as one JSON line (K1, K2
  and K3).
- ``flops``: ``benchmarks/flops.py``, the analytic FLOP count, the card's
  data-sheet peaks, ``mfu_report``, and PyTorch's own count
  (``torch_program_flops``, with formulas for the ``sevit`` ops).
- ``roofline``: ``benchmarks/roofline.py``, each stage's bound at the card's
  peaks beside ``bench_stages``' times.
- ``bench_stages``: ``benchmarks/bench_stages.py``, the core's nested
  prefixes timed on the device (K1 in the front, K2, K3 in ``full``).
- ``bench_infer``: ``benchmarks/bench_infer.py``, the core's device
  throughput, FLOPs and launches a step (K1, K2, K3).
- ``bench_train``: ``benchmarks/bench_train.py``, the train step's ms,
  audio-s/s and share of the peak (K1 twice, K2 and its backward).
- ``bench_scaling``: ``benchmarks/bench_scaling.py``, weak scaling of the
  train step over data ranks (NCCL, one rank a card; gloo on the CPU).
- ``bench_io``: ``benchmarks/bench_io.py``, the native WAV decoder against
  the numpy codec (host).
- ``tracecheck``: no JAX script; the port's recorder (``utils/tracing.py``)
  in the cells of ``portbench/``: what its spans read in a traced run, the
  idle they name, and what the recorder costs (run from a checkout's root).

The quality tools:

- ``oracle_heads``: ``benchmarks/oracle_heads.py``, the constructed SI-SDR
  reference points of the output-head geometries (K1 and K3 on the card).
- ``tune_blend``: ``benchmarks/tune_blend.py``, the fit of the
  ``snr_adaptive`` do-no-harm blend, written into a checkpoint's
  ``meta.json`` with ``--write-checkpoint-meta`` (K1, K2 and K3).
- ``bench_mask_delta``: ``benchmarks/bench_mask_delta.py``, the bucketing's
  error budget: each bucketed ``mask_padding`` mode against the exact-length
  oracle (K1, K2 and K3).
- ``calibrate_pesq``: ``benchmarks/calibrate_pesq.py``, the mid-scale
  calibration of the native P.862 model (host numpy).

``benchmarks/protocol_report.py`` has no counterpart: it is numpy only and
imports nothing of either package, so it runs as it is on the port's
evaluate CLI ``--output`` JSON and ``cli.synth_dataset``'s ``manifest.json``.

The tools that take a device default to ``--device cuda`` and exit without
a card; ``--device cpu`` runs the kernels' plain versions, and the
measurement tools then write no device metric (every time, rate and share
null or "not measured"). Every number a measurement tool prints on the card
stands beside the card's name and power limit.
"""
