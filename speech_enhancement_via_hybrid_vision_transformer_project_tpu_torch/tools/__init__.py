"""The quality tools, on the card or the CPU: the port's counterparts of the
repository's ``benchmarks/`` scripts that the README's quality claims were
made with. Each module takes the name of its ``benchmarks/`` script and runs
as ``python -m speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools.<name>``:

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
a card; ``--device cpu`` runs the kernels' plain versions.
"""
