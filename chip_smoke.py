"""Drive the PyTorch port's serving and training paths on a CUDA card and
check them.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout (it imports the
port package beside this file); it imports nothing of JAX. Phases, each of
which raises on failure:

1. device: a CUDA card is required; prints its name and power limit and
   turns TF32 off (float32 end to end).
2. build: compiles the eight kernels (K1, K2 forward and backward, K3, K1g
   and K3g for the STFT geometries K1 and K3 do not take, and the
   optimizer's ``global_sq_norm`` and ``adam_update``, one source) from the
   port's ``csrc/``, one nvcc per source, all started together, and the
   native WAV runtime (``native/``) with the host compiler; prints K2's
   registers, shared memory and blocks per SM and its backward's registers
   and spills per pass at every head-dim instance (16, 32, 64, 128), and
   checks that K2's forward, both passes of its backward, K1g and K3g's
   product hold TF32 tensor-core instructions (``HMMA ... TF32`` in
   ``cuobjdump -sass``).
3. kernels: each kernel against its plain PyTorch version at the serving
   path's shapes (batch 32 x 3 s; attention under the serving batch's own
   mask and under a mix of clip lengths) and at ragged shapes (attention: a
   fully masked row, a row keeping one key), max errors within the stated
   tolerances.
4. trained weights: the ``tests/fixtures/tiny_denoiser_mask`` checkpoint,
   read by the port's msgpack reader, enhances two synthetic clips on
   cuda and on cpu; the waveforms agree.
5. full width: the 28M configuration (embed 512, 8 heads, 6 layers) with
   the serving recipe (factored_2d, mask output, fullres_mask head,
   mask_padding), seeded random weights, enhances 32 x 3 s PCM16 on cuda;
   the output is finite, of the right shape, matches a cpu run on a short
   clip, and went through all three kernels.
6. serving: the HTTP server around that enhancer answers 6 concurrent
   requests, each equal to a direct ``enhance``.
7. times: each kernel against its plain version and its one-call PyTorch
   yardstick (``torch.stft``, ``scaled_dot_product_attention``,
   ``torch.istft``; the port never calls these), per-call CUDA-event times
   over fresh inputs and the device time alone (``torch.profiler``),
   beside its bound: the larger of its operations over the card's peak
   rate for their type (the FFTs: fp32; attention's fp32-accurate matrix
   products, forward and backward: 3xTF32 on the tensor cores) and
   its bytes over the memory rate. K2's inputs carry the mask of the
   slice's own batch (32 clips of 3 s, which keep every key); K2 is also
   timed under a mix of clip lengths (1 to 3.06 s, a third of the keys
   masked) and with no mask. Then the slice's audio-seconds per second at
   batch 32 x 3 s, and each kernel's device time per launch in one
   profiled batch.
7b. optimizer kernels: ``global_sq_norm`` and ``adam_update`` at the
   parameter sets of the benchmark's 28M and 168M models (110 and 182 fp32
   tensors): the norm twice, the same bits, within 1e-7 of a float64 sum;
   two AdamW steps (clip 1.0, engaged) of the kernel and of the plain loop
   from the same state by the same norm, p, m and v bit-equal; one launch
   a call. Each kernel's time against the plain loop and PyTorch's own
   multi-tensor call (``_foreach_norm``, ``AdamW(fused=True)``) beside its
   bytes bound; the clip and AdamW a step against ``clip_grad_norm_(
   foreach=True)`` and fused AdamW; ``adam_update``'s host ms a call with
   its per-tensor checks skipped and made.
8. offline (its wall time printed): the 28M serving recipe with seeded
   weights and seeded non-trivial BatchNorm statistics, written with the
   port's checkpoint writer; 64 synthetic PCM16 pairs of 1-6 s at -5 to
   15 dB and one of 10 s (longer than the largest bucket: streaming). The
   enhance CLI on cuda over the directory, plain and with ``--fold-bn``:
   every file written at its input's length, finite, folded within
   ``TOL_WAVE`` of plain, K1, K2 and K3 launched and K2's backward not.
   The evaluate CLI on cuda (batch 32, 2 metric workers): 65 rows with
   finite SI-SDR, STOI and PESQ; the same CLI on cpu over the first 4
   files scores each within the evaluator tests' tolerances of cuda's.
   Then the same batches swept twice, through ``enhance_batch_async``
   with two batches in flight and through the blocking
   ``enhance_batch``, at batch 8 and 32: wall time, audio-seconds per
   second and the pipelined sweep's device busy share (profiler).
9. training (its wall time printed):
   a. K2's backward (``csrc/attention_bwd.cu``: a dq pass and a dk/dv
      pass, each on the tensor cores in 3xTF32 as the forward; the gradient
      of K2's op, ``sevit::attention_bwd``) against autograd through the plain
      version, at q/k/v [16, 8, 384, 64] under the train batch's own patch
      mask, under a 1-3.06 s length mix and with no mask, and at N = 200
      with a fully masked row and N = 37 with a one-key row; dq, dk and dv
      each within ``TOL_BWD`` of its largest magnitude, masked keys' dk
      exactly 0.
   b. full width: the 28M configuration with the README's recipe, dropout
      and drop-path 0.1, attention dropout 0 (so attention runs through K2),
      fp32, AdamW at lr 1e-4, clip 1.0, seeded weights, SpecAugment on, a
      PCM16 batch of 16 clips of 1.5-3.06 s (the 384-frame bucket) from the
      port's collate: 5 train steps, through the port's step functions, and
      one eval step. The loss is finite and falls; K1 runs twice a step, K2
      forward and backward 6 times a step, ``global_sq_norm`` twice (the
      trainer's norm and the clip's) and ``adam_update`` once, and the eval
      step launches neither. One step at depth 1 (dropouts 0)
      on cuda matches the same step on cpu from the same weights: loss,
      BatchNorm statistics, each parameter's gradient relative to its own
      largest, and the parameters after AdamW against AdamW on the cpu
      from cuda's gradients (``step_cuda_vs_cpu``, ``check_step``).
   c. the shipped dropouts (attention dropout 0.1): 2 steps through the
      explicit-weights path, which launches no K2.
   d. the training CLI: one epoch on 8 synthetic WAV pairs at small width,
      fp32, attention dropout 0, on cuda; its best and final checkpoints
      read back.
   e. times: K2's backward against its plain version (autograd through
      ``attention_plain``), SDPA's backward (the port never calls it) and
      its bound (3xTF32, as the forward's); the full-width train step in ms
      and audio-seconds per second, and beside it the same step without
      the non-finite skip (whose check waits for the device); one profiled
      step split by operator.

10. shipped config (its wall time printed):
   a. the train CLI on the repo's own ``config/``, unmodified (28M, resize
      head, bf16 input rounding, dropouts 0.1, batch 16), over 120 synthetic
      pairs of 1.5-3.06 s with ``--max-files 48 --epochs 1 --profile-dir``:
      exit 0, finite losses, each train step's wall time, the launches of
      the epoch (K1 in every featurize, K2 in validation and the audio-sample
      enhancer, K3 there only where TensorBoard is installed, no K2
      backward), and the files it wrote (metrics, checkpoints read back, the
      profiler trace, TensorBoard events or the JSON-lines-only note). Then
      the shipped config's train step at depth 1, dropouts 0, on cuda and on
      cpu, at phase 9's limits (the cpu step takes the cuda step's bf16
      model input).
   b. remat: the phase 9 training recipe at 28M and at 12L/1024d/16h, one
      step each with and without ``remat`` at batch 16 in the 384-frame
      bucket: step ms, peak device memory, launches (K2's forward twice a
      block under remat); at 28M with dropouts 0.1, remat's gradients
      against no remat's from one seed.
   c. linear attention: the 28M serving recipe with ``attention_type:
      linear`` enhances one clip on cuda and on cpu, within ``TOL_WAVE``.

11. mesh (its wall time printed; ranks are processes started by the port's
    launcher, each with a timeout, a failing rank failing the phase):
   a. NCCL at world size 1 (``initialize_distributed(backend="nccl")``): an
      all-reduce of a known tensor comes back unchanged; the 28M recipe's
      step at batch 16 through the mesh code against the plain step (cuDNN
      deterministic): loss terms and BatchNorm statistics bit for bit; the
      update within max(1e-5, 10 x) two plain runs' difference, as phase 10b
      holds remat (F.interpolate's bilinear backward adds with atomics). At
      one device the mesh code runs no collective (``parallelize`` leaves
      the model as it is, the step has no data group): this proves the NCCL
      group and that a mesh of one is the one-process path, nothing more.
   b. two data ranks on this card (gloo, CUDA tensors): the depth-1 step
      (dropouts 0) on 2 x 8 rows against one device's step on the same 16
      rows, and again with the second rank's 8 rows a padding batch (every
      row invalid; BatchNorm normalizes over every row, as the JAX step over
      its global batch): loss and BatchNorm statistics within 1e-5, the
      all-reduced gradients within phase 9's limits. Then 3 full-width
      recipe steps at 2 x 8: losses finite and equal on both ranks, K1 2, K2
      6, K2's backward 6, ``global_sq_norm`` 2 and ``adam_update`` 1 a step
      on each rank.
   c. tensor parallelism over 2 ranks of this card (gloo) at 12L/1024d/16h
      (dropouts 0): the eval output against TP = 1 within 2e-5 or TP = 1's
      own cuda-vs-cpu difference, whichever is larger, one step at
      batch 4 in the 384-frame bucket against TP = 1 at phase 9's limits, K2
      on 8 of the 16 heads on each rank; then an AdamW step of each rank's
      shards by their gradients: one ``adam_update``, and no
      ``global_sq_norm`` (the clip's norm under TP is the shards' squares
      all-reduced).
   d. the 28M serving recipe on two replicas of this card (a mesh over
      [cuda:0, cuda:0]), 32 x 3 s PCM16: waveforms within ``TOL_WAVE`` of
      phase 5's, K1 1, K2 6 and K3 1 a replica; the enhance CLI asking for
      one card more than visible exits non-zero naming both counts.
   e. times: the gradients' all-reduce (gloo at 2 ranks, NCCL at world size
      1), the 2-rank step beside the one-process step, and the 2-replica
      batch beside one device's. Two ranks on one card measure the mesh's
      overhead, not its scaling.

12. DSP (its wall time printed): a. the native WAV runtime, built in phase
    2 from the port's ``native/sevit_audio.cpp`` with the host compiler
    (its build time printed; ``available()`` must be True: this machine has a compiler, so
    the numpy fallback may not hide a failed build); phase 8's 65 PCM16
    files decoded by ``native.read_wav`` within 1e-7 of the numpy codec and
    by ``native.decode_batch`` within 2e-4, with host ms a file for each.
    b. Griffin-Lim on the magnitude of one 32 x 3 s batch ([32, 257, 384]
    from K1), 32 rounds: 32 K1 and 33 K3 launches, finite output of 49024
    samples, against the plain (re, im) rounds on cuda from the same drawn
    phase (after 1 round within K1's and K3's composed limits, after 32 within
    ``TOL_GL_ROUNDS`` of the peak), the spectral convergence falling from
    round 1 to 32; ms a call and a round, audio-s/s. c. ``stft``, ``istft``,
    ``reconstruct`` and ``spectrogram`` with ``method="auto"`` launch K1 or K3
    once and equal ``method="matmul"`` within K1's and K3's limits,
    ``method="fft"`` within 2e-3; a tensor that needs grad is refused.
13. export (its wall time printed): the kernels are ``torch.library`` ops
    (``torch.ops.sevit.*``). a. ``export_program`` of phase 5's 28M serving
    core (``inference.EnhancerCore``) on cuda, PCM16 [32, 49024] with
    lengths: its graph holds exactly 1 ``sevit.stft_mag``, 6
    ``sevit.attention_fwd`` and 1 ``sevit.istft_polar`` and none of the
    ops the plain versions would put there. b. The program loaded in a fresh
    process that imports only the port (``load_program``): K1 1, K2 6 and K3
    1 launches on phase 5's batch, its PCM16 within 1 LSB of the eager
    core's (the count of differing samples printed), the wall of both. c.
    ``graft_entry.entry()``'s bf16 flagship exported on cuda: 6 K2 ops,
    the loaded module within 1e-5 of the eager one. d. Host microseconds a
    call of each op and of its CUDA impl called directly on a tiny input:
    the dispatcher's cost, beside phase 7's wall and phase 12b's ms a round.
    e. ``cli.synth_dataset`` writes 8 + 2 pairs, then ``cli.demo --device
    cuda`` trains on them for an epoch and prints its SNR line.
14. quality tools (``tools/``; its wall time printed): a. ``cli.synth_dataset``
    writes 12 + 4 held-out-family test pairs of 1-3 s. b. ``tune_blend`` on
    the trained ``tests/fixtures/tiny_denoiser`` (a copy with a
    ``config.model``) over 8 of them on cuda and on cpu: each file's input
    SI-SDR equal, its SNR estimate and 11 blend gains within the stated
    limits, the same fit; the fit written with ``--write-checkpoint-meta``
    on cuda and adopted by ``AudioEnhancer(blend=None)``. c. ``tune_blend``
    on a 28M magnitude-head checkpoint of seeded weights over all 16 files on
    cuda: files a second, K1 1, K2 6 and K3 1 launches a file. d.
    ``oracle_heads`` on cuda and cpu: each head's mean gain within the stated
    limit, K1 1 and K3 1 a file. e. ``bench_mask_delta --full-size
    --pos-embed factored_2d`` on cuda: its worst max LSB, K1 3, K2 18 and K3
    3 a clip. f. ``calibrate_pesq --clips 1 --seconds 2``: its residuals, on
    a machine without jax. A tool on cpu launches nothing.
15. measurement tools (``tools/``; its wall time printed): a. ``tools.bench``
    (the port's ``bench.py``) at its defaults, its one JSON line printed:
    ``mfu_pct`` in (0, 100], K1 1, K2 6 and K3 1 launches a device step; its
    device core on cuda against the same core on cpu (rows 0-3 of a 32 x 3 s
    batch) within ``TOL_WAVE``. b. ``tools.flops`` at batch 4 x 256 frames on
    cuda (the ``sevit`` ops' FLOP formulas). c. ``bench_infer`` at 32 x 3 s:
    ms, audio-s/s, PyTorch's FLOP count within 2% of the analytic one, the
    share of the peak in (0, 100], launches 1 / 6 / 1. d. ``bench_stages`` at
    32 x 3 s (its full prefix within 25% of a.'s device step), then
    ``roofline`` on its JSON: each stage's bound at the card's data-sheet
    peaks beside its time. e. ``bench_train`` at the 28M recipe (fullres
    head, mask output, attention dropout 0, batch 16, 384 frames, fp32): ms,
    audio-s/s, the share of the peak in (0, 100], K1 2, K2 6, K2's
    backward 6, ``global_sq_norm`` 2 and ``adam_update`` 1 launches a step.
    f. ``bench_io`` on phase 8's PCM16 files.
    g. ``bench_scaling`` over NCCL at the ranks the visible cards allow.
16. geometry (its wall time printed): every STFT geometry and head dim the
    JAX package runs. 1. At 400/100/400, 320/160/320, 400/160/400,
    512/100/400, 512/100/512, 4096/1024/4096, 512/128/512 with zero
    padding, 384/96/384 (a radix-3 stage) and 450/100/450 (odd M) under
    reflect and edge padding (``cuda_stft.GEOMETRIES``), the kernel
    ``cuda_stft.route`` picks (K1 on the mixed radices or K1g, K3 or K3g)
    launches once, and nothing
    else, against its plain version within K1's and K3's limits, on the
    serving batch's 32 rows of 51100 samples, on the shortest row one
    reflection pads, and on rows of n_fft/2 and 100 samples (padded first,
    as ``jnp.pad`` pads). 2. K2 at head dims 24, 48, 80, 96 and 112 (the
    next instance, zero-padded) and 192 and 256 (the sliced instance),
    [32, 8, 384, D] under the train mask: forward within ``TOL_ATTN``,
    backward within ``TOL_BWD``; the sliced forward's device time. 3. The
    28M serving recipe at 400/100/400, 32 x 3 s PCM16 through
    ``AudioEnhancer``: a 1 s clip cuda vs cpu within ``TOL_WAVE``, launches
    K1 1, K2 6, K3 1; wall ms a batch.
    4. The DCCRN geometry 512/100/400 through the same enhancer: K1 1, K2 6,
    K3g 1. 5. The recipe's train step at 400/100/400: depth 1 cuda vs cpu at
    phase 9's limits; at full width, batch 16, K1 2, K2 6 and its backward 6,
    ``global_sq_norm`` 2 and ``adam_update`` 1. 6. A model with D = 48
    (embed 384, 8 heads, depth 2): cuda vs cpu within ``TOL_WAVE``. 7.
    ``griffin_lim`` at 4096/1024 on [4, 2049, 50]: K1g 4 and
    K3g 5 launches, the spectral convergence falling. 8. K1 and K3 at
    400/100 and 320/160, K1g at 4096/1024 and K3g at 4096/1024, 400/160 and
    512/100/400 (the geometries they still serve), each beside its plain
    version, ``torch.stft`` + ``abs`` or ``torch.istft`` of ``torch.polar``,
    each timed output against the plain version's, and its bound: the
    function's (an FFT's operations at the fp32 peak, or the bytes), not the
    dense product K1g and K3g do. Part 8 runs in a fresh process
    (``geometry_times``), with the same batch's busy ms and K1's and K3's
    device ms in it: late in this script the profiler loses records.
17. CMGAN (``cmgan``): K2r (``attention_relpos``) against its plain version,
    the published einsums, in float64 at head dim 16 and N = 101, 401 and
    1001, with and without prefix masks, within ``TOL_RELPOS``; its
    registers and blocks an SM; its per-call and device time at a 32-clip
    batch in the 819-frame bucket (time attention under the batch's mask,
    frequency attention), beside the einsums (on an eighth of the rows, x8)
    and its bound; a CMGAN batch of 32 x 4 s clips at the published widths
    (the benchmark's seeded weights) through ``AudioEnhancer``: K1 1, K2r 8,
    K3 1 and K2 0 launches, two clips cuda vs cpu within ``TOL_WAVE``.
    ``add_layer_norm`` (the conformers' residual add and LayerNorm) against
    its plain version in fp32 and float64 at 33, 303 and 9,409 rows, delta
    as rows and channel-first, the epilogue on and off, within
    ``TOL_ADD_NORM``; its per-call and device time at [32 x 101 x 819, 64]
    (the attention's and the convolution's boundary) beside ATen's add and
    ``layer_norm`` and its bytes bound; the CMGAN batch launches it 40
    times, and its device time there a launch, with the batch's ten
    largest device functions. ``instance_norm`` (the masked InstanceNorm
    and its PReLU) against its plain version in fp32 and float64 within
    ``TOL_INSTANCE_NORM`` (ragged and no counts, odd T x F, one channel,
    channels-last),
    the same bits on a second call; its per-call and device time at the
    cell's four shapes, [32, 64, 819, 201], [32, 64, 819, 101] (contiguous
    and channels-last), [32, 64, 819, 202] and [32, 1, 819, 201] with the
    batch's ragged counts, beside
    ATen's unfused chain (its plain version) and its bytes bounds, each
    output first held against ATen's and the float64 plain version's within
    ``TOL_INSTANCE_NORM``; the CMGAN batch launches it 16 times, and its
    device time there a launch.
18. SEMamba (``semamba``): the selective scan (``selective_scan``) against
    its plain version in float64 at small shapes and in fp32 at the cell's
    (time [3,200, 819, 256] both ways under a batch's lengths, frequency
    [26,208, 100, 256] over its valid frames), within ``TOL_SCAN`` of the
    output's largest; its per-call and device time there beside the plain
    version's and its bound; the depthwise conv with its SiLU
    (``conv1d_silu``) against its plain version in float64 within
    ``TOL_CONV``, and its per-call and device time at the cell's two shapes,
    both directions, beside ATen's chain (its plain version) and its bytes
    bound; a SEMamba batch of 32 x 4 s clips at the published widths through
    ``AudioEnhancer``: K1 1, ``instance_norm`` 16, ``selective_scan`` 16,
    ``conv1d_silu`` 16, K3 1 launches, two clips cuda vs cpu within
    ``TOL_WAVE``, its ten largest device functions.

``python3 chip_smoke.py --cards N`` (a machine with N >= 2 cards) builds the
kernels and runs phase 11 alone over NCCL, one rank a card: N data ranks,
TP = 2 x DP = N / 2 and N inference replicas, with the same checks and
times (no 11a); then the train CLI itself at ``--data-parallel N`` and at 1
on the shipped ``config/`` (two epochs of synthetic files, a third resumed
on N cards): every rank's final loss equal, rank 0 alone writing the
metrics and the checkpoints, which read back, and the epoch's wall per
batch; then ``tools.bench_scaling`` at 1, 2, 4, ... ranks up to N; and
prints the launches and the result JSON.

Before its last three lines it prints its own wall time, start to result.
Prints, on its last three lines: the card's ``nvidia-smi`` name and power
limit, a JSON line of per-kernel results (``launches`` in the phase 5
batch, ``offline_launches`` in the phase 8 evaluate run,
``train_launches`` in the phase 9 train steps, ``shipped_launches`` in the
phase 10 CLI epoch, ``remat_train_launches`` in one 28M remat step,
``mesh_train_launches`` per rank in one 2-rank step, ``tp_train_launches``
per rank in one TP step, ``mesh_serve_launches`` per replica in one mesh
batch, ``griffin_lim_launches`` in one phase 12 Griffin-Lim call,
``exported_launches`` in one call of the phase 13 program loaded in a fresh
process, ``tools_launches`` a file in phase 14c's ``tune_blend`` run,
``bench_launches`` a step of phase 15a's device core, ``bench_train_launches``
a step of phase 15e's ``bench_train``, ``geometry_serve_launches`` in one
phase 16 batch at 400/100/400, ``dccrn_serve_launches`` in one at
512/100/400, ``geometry_train_launches`` in one phase 16 train step at
400/100/400, ``geometry_gl_launches`` in phase 16's Griffin-Lim call at
4096/1024, ``cmgan_serve_launches`` in phase 17's CMGAN batch,
``semamba_serve_launches`` in phase 18's SEMamba batch; K2r's
times under ``time`` and ``freq``, ``add_layer_norm``'s under ``rows`` and
``channels_first``, ``instance_norm``'s by shape; K1's and K3's times at
400/100 and 320/160 and K3g's at its other geometries under
``at_<geometry>``; the optimizer kernels' times and
errors from phase 7b at the 28M parameter set, the 168M set's under
``at_hvit168m``, and ``adam_update``'s host ms a call by set, its checks
skipped (``host_ms``) and made (``host_checked_ms``)), and the result JSON.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

STARTED = time.perf_counter()  # the script's own wall time runs from here
ROOT = Path(__file__).resolve().parent
SR = 16000
BATCH, SECONDS = 32, 3.0
# tolerances (max abs error), with their reasons
TOL_STFT = 2e-3  # the plain version's fp32 DFT sums of 512 terms of |x|<~5 vs an fp32 FFT
TOL_ATTN = 2e-5  # fp32 softmax(QK^T)V, online vs two-pass softmax
TOL_ISTFT = 2e-5  # fp32 inverse DFT vs inverse FFT, overlap-add in another order
TOL_WAVE = 2e-4  # waveform through ~20 fp32 layers on two devices (~6 PCM16 LSB)
# H100 SXM peaks at the 700 W limit (NVIDIA data sheet): fp32 outside the
# tensor cores, and HBM3
FP32_PEAK = 67e12  # FLOP/s
HBM_RATE = 3.35e12  # bytes/s
# fp32-accurate matrix products on the tensor cores: 3xTF32, three dense
# TF32 products (495 TFLOP/s) per fp32 product. The fastest route to fp32
# accuracy for a matrix product on this card, and the one both K2 and its
# SDPA yardstick (PyTorch's memory-efficient kernel) take.
TF32X3_PEAK = 495e12 / 3  # FLOP/s
# K2's backward: dq, dk and dv each within 1e-4 of its largest magnitude
# (fp32 sums of up to 448 products in another order, the weights recomputed
# from the forward's log-sum-exp rather than a two-pass softmax)
TOL_BWD = 1e-4
# one train step on cuda against the same step on cpu, fp32 on both (cuDNN's
# convolutions sum in another, not fixed, order): loss components and new
# BatchNorm statistics (absolute); each parameter's gradient, its max abs
# error relative to its own largest |grad| on cpu. The gradients are
# ill-conditioned in fp32 where they sum over the spectrogram's positions
# (BatchNorm's affine parameters, the convs under it, the patch embedding,
# the positional tables): BatchNorm's backward sums dout over positions to
# ~0 per channel, so these gradients cancel and amplify rounding, K1's
# against the plain STFT included; the transformer block's parameters come
# after the encoder and cancel less. Measured on an H100 over 16 such steps
# (weight seeds and batches): at most 1.7e-2 outside the block
# (decoder.0.bn.bias) and 6.2e-3 inside (norm2.weight); with K2's backward
# planted without its scale (dq and dk 8x) the block is off by 0.13-0.19
# (qkv, norm1) in each of 3 steps. The block's limit lies midway (geometric)
# between those two readings. The parameters after AdamW on cuda against
# AdamW on the cpu applied to cuda's own gradients (the same elementwise
# fp32 arithmetic): in units in the last place of the larger of the
# parameter before and after the step, as an update that cancels a
# parameter to ~0 rounds at the scale of its operands; CUDA divides by a
# host scalar (Adam's bias corrections) as a product with its reciprocal,
# which puts the update a few ulp off: 4 ulp in each of 11 such steps.
TOL_STEP_LOSS = 1e-5
TOL_STEP_STATS = 1e-5
TOL_STEP_GRAD = 5e-2
TOL_STEP_GRAD_BLOCK = 3e-2
TOL_STEP_PARAM_ULPS = 8
SERVING = ("stft_mag", "attention_fwd", "istft_polar")  # the kernels each path runs
TRAINING = ("stft_mag", "attention_fwd", "attention_bwd")
# the optimizer's kernels a train step through the port's Optimizer (AdamW,
# clip 1.0): the trainer's norm (``train.norm``), the clip's norm and one
# update (a table of at most 512 tensors)
OPT_STEP = {"global_sq_norm": 2, "adam_update": 1}
# the benchmark's models, at whose parameter sets phase 7b checks and times
# the optimizer's kernels
OPT_CONFIGS = ("hvit28m", "hvit168m")
TRAIN_BATCH, TRAIN_LR, TRAIN_STEPS = 16, 1e-4, 5
# the evaluator tests' tolerances on a metric of two enhanced waveforms
# within the port's limits (tests/test_torch_evaluator.py)
TOL_METRIC = {"si_sdr": 1e-4, "snr": 1e-4, "seg_snr": 1e-4, "stoi": 1e-5, "pesq": 1e-5,
              "lsd": 2e-2, "lsd_db": 0.2}
# the README's recipe with attention dropout 0, so that attention runs through K2
RECIPE = {"model": {"output_mode": "mask", "head": "fullres_mask",
                    "transformer": {"pos_embed": "factored_2d", "attention_dropout": 0.0}}}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def speechlike(n: int, rng: np.random.Generator) -> np.ndarray:
    """Harmonic tone with a syllable-rate envelope plus white noise."""
    t = np.arange(n) / SR
    f0 = rng.uniform(100, 250)
    x = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.28)) / h for h in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * t))
    x = 0.3 * env * x / np.max(np.abs(x)) + 0.05 * rng.standard_normal(n)
    return x.astype(np.float32)


def median_ms(fn, inputs, reps: int = 5) -> float:
    """Per-call time of ``fn``: CUDA events around ``fn(*args)`` for every
    argument tuple of ``inputs`` back to back (fresh data each call: the
    tuples together exceed the 50 MB L2), divided by their number; the
    median of ``reps`` such runs, after one warm-up run."""
    for args in inputs:
        fn(*args)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for args in inputs:
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(inputs))
    return statistics.median(times)


def device_times(run, attempts: int = 3, need=()) -> dict[str, float]:
    """Device time (ms) of every CUDA kernel and copy ``run()`` enqueues,
    summed by name, as ``torch.profiler`` records it. Now and then the
    profiler hands back an empty trace, or, late in a long process, one
    without the records of the first work ``run()`` enqueues (a serving
    batch's host-to-device copy and its STFT kernel); then ``run()`` is
    profiled again, up to ``attempts`` times in all, until each of ``need``
    (``kernel_ms`` names that ``run()`` launches) has a record. The last
    trace is returned whatever it lacks. (A warm-up step on a profiler
    schedule fared worse on an H100: whole traces came back empty, late in
    this script and in a fresh process alike.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        times = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
        missing = [name for name in need if not kernel_ms(times, name)]
        if sum(times.values()) > 0 and (not missing or attempt == attempts - 1):
            return times
        if missing:
            print(f"profile {attempt + 1} holds no record of {missing} among its "
                  f"{len(times)} CUDA functions {sorted(k[:60] for k in times)}; profiling "
                  f"again", flush=True)
    raise RuntimeError(f"the profiler recorded no device time in {attempts} runs")


def device_ms(fn, inputs) -> float:
    """Per-call device time of ``fn`` over one call per argument tuple of
    ``inputs``, after one warm-up call each. Unlike ``median_ms`` it leaves
    out the host's launch cost."""
    for args in inputs:
        fn(*args)

    def run():
        for args in inputs:
            fn(*args)

    return sum(device_times(run).values()) / len(inputs)


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of ``flops`` over
    ``peak`` and ``nbytes`` over the memory rate, and which binds."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def rfft_flops(n: int) -> float:
    """Operations of one real FFT of ``n`` points (half a complex one's
    5 n log2 n)."""
    return 2.5 * n * np.log2(n)


def stft_work(cfg, batch: int, wav_len: int) -> dict[str, tuple[float, float]]:
    """Operations and bytes that an STFT with its magnitude (``stft``) and
    an iSTFT from magnitude and phase (``istft``) of ``batch`` rows of
    ``wav_len`` samples must do and move, whichever kernel computes them: a
    real FFT of each windowed frame, the magnitude or the polar recombine
    and the overlap-add; every input read once, every output written once,
    fp32. Bound them at the fp32 peak."""
    n_frames, bins = cfg.num_frames(wav_len), cfg.num_bins
    frames = batch * n_frames
    return {"stft": (frames * (rfft_flops(cfg.n_fft) + cfg.n_fft + 4 * bins),
                     4 * (batch * wav_len + 3 * batch * bins * n_frames)),
            "istft": (frames * (rfft_flops(cfg.n_fft) + 2 * bins + 2 * cfg.n_fft)
                      + batch * wav_len,
                      4 * (2 * batch * bins * n_frames + batch * wav_len))}


def tf32_hmma(cuobjdump: str, lib: Path) -> dict[str, list[str]]:
    """The TF32 tensor-core instructions (``HMMA ... TF32``) in a library's
    SASS, by the (mangled) name of the function that holds them."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    found, fn = {}, ""
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
        elif "HMMA" in line and "TF32" in line:
            found.setdefault(fn, []).append(line.split(";")[0].split("*/")[-1].strip())
    return found


def max_err(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def kernel_ms(times: dict[str, float], name: str) -> float:
    """Device time of the kernel record ``name``'s CUDA functions
    (``<name>*_kernel``) in a ``device_times`` result, under their demangled
    or their mangled names (``...15stft_dft_kernelEPKf...``)."""
    return sum(t for key, t in times.items()
               if re.search(rf"(?<![A-Za-z_]){name}\w*?_kernel(?![a-z])", key))


def op_split(run, attempts: int = 3) -> dict[str, float]:
    """Device ms of one ``run()`` by operator: cuDNN convolutions forward and
    backward, fp32 GEMMs, the hand-written kernels, and the rest of the busy
    time (``torch.profiler``: operators' device time with their kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kern = {e.key: e.self_device_time_total / 1e3 for e in events
                if e.device_type == DeviceType.CUDA}
        ops = {e.key: e.device_time_total / 1e3 for e in events
               if e.device_type == DeviceType.CPU}
        busy = sum(kern.values())
        if busy <= 0:
            continue
        split = {
            "convs": sum(ops.get(k, 0.0) for k in ("aten::cudnn_convolution",
                                                   "aten::convolution_backward")),
            "gemms": sum(ops.get(k, 0.0) for k in ("aten::mm", "aten::addmm", "aten::bmm",
                                                   "aten::baddbmm")),
            **{name: kernel_ms(kern, name) for name in TRAINING},
        }
        split["rest"] = busy - sum(split.values())
        split["busy"] = busy
        return split
    raise RuntimeError(f"the profiler recorded no device time in {attempts} runs")


def audio_config(config: dict | None):
    """The STFT geometry of a config's ``audio`` section (512/128 by
    default), as the enhancer reads it."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig

    audio = (config or {}).get("audio", {})
    return STFTConfig(n_fft=audio.get("n_fft", 512), hop_length=audio.get("hop_length", 128),
                      win_length=audio.get("win_length", 512))


def loader_batch(n: int, lo: float, hi: float, rng: np.random.Generator, cfg=None) -> dict:
    """A loader batch (the port's collate, PCM16, bucketed at the STFT
    config ``cfg``'s hop, 512/128 by default) of n speech-like pairs,
    lengths spread evenly from lo to hi samples."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.dataset import (
        collate_waveforms,
    )

    items = []
    for length in np.linspace(lo, hi, n).astype(int):
        clean = speechlike(int(length), rng)
        noisy = (clean + 0.1 * rng.standard_normal(length)).astype(np.float32)
        items.append({"noisy_audio": noisy, "clean_audio": clean, "length": np.int32(length)})
    return collate_waveforms(items, cfg or audio_config(None), transfer_dtype="int16")


def step_cuda_vs_cpu(rng: np.random.Generator, seed: int = 1, config: dict | None = None,
                     loss_cfg=None, compute_dtype: torch.dtype = torch.float32) -> dict:
    """One train step of the 28M recipe at depth 1 (dropouts 0, SpecAugment
    off, weights from seed ``seed``) on cuda and on cpu, on one batch of 4
    PCM16 clips in the 128-frame bucket; or of ``config`` (its model at
    depth 1 with dropouts 0, its loss ``loss_cfg``, output mode,
    ``training.mask_padding`` and STFT geometry) in ``compute_dtype``. In bf16 the cpu step
    takes the cuda step's model input (its noisy spectrogram): bf16 rounding
    turns the two devices' float32 featurizations, which differ in the last
    places, into one-ulp (2^-8) flips of a few elements, and those move the
    gradients more than the float32 path does. Returns the max abs error of the
    loss components (``loss``) and of the new BatchNorm statistics
    (``stats``); per parameter, its gradient's max abs error relative to its
    own largest |grad| on cpu (``leaf``) and to the model's largest
    (``model``); and the largest difference between the parameters after
    AdamW on cuda and AdamW on the cpu applied to cuda's gradients, in units
    in the last place of the larger of each parameter before and after the
    step (``param_ulps``)."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.augmentation import (
        SpecAugmentConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
        create_hybrid_vit, init_weights,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.losses import (
        LossConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
        Optimizer, parameters,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training import (
        trainer as trainer_module,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
        batch_to_device, make_step_fns,
    )

    class Capturing(Optimizer):
        """AdamW that keeps a copy of the gradients it is handed."""

        def step(self, grads):
            self.grads = [x.detach().cpu().clone() for x in grads]
            return super().step(grads)

    cfg = audio_config(config)
    if config is None:
        config = {"model": {**RECIPE["model"], "encoder": {"dropout": 0.0},
                            "transformer": {**RECIPE["model"]["transformer"], "num_layers": 1,
                                            "drop_path_rate": 0.0}}}
        loss_cfg, output_mode, mask_padding = LossConfig(log_l1_weight=0.05), "mask", True
    else:
        mc = config["model"]
        config = {**config, "model": {
            **mc, "encoder": {**mc.get("encoder", {}), "dropout": 0.0},
            "transformer": {**mc.get("transformer", {}), "num_layers": 1, "drop_path_rate": 0.0,
                            "attention_dropout": 0.0}}}
        output_mode = mc.get("output_mode", "magnitude")
        mask_padding = config.get("training", {}).get("mask_padding", False)
    model = init_weights(create_hybrid_vit(config, compute_dtype=compute_dtype),
                         torch.Generator().manual_seed(seed))
    names = [name for name, p in model.named_parameters() if p.requires_grad]
    initial = [model.state_dict()[name].clone() for name in names]
    batch = loader_batch(4, 0.6 * SR, 127 * cfg.hop_length, rng, cfg)  # the 128-frame bucket
    adamw = dict(name="adamw", lr=TRAIN_LR, weight_decay=0.01, max_norm=1.0)
    res = {}
    featurize, model_input = trainer_module.featurize_batch, {}

    def same_input(*args, **kwargs):  # the cuda step's model input, on both devices
        feats = featurize(*args, **kwargs)
        if "spec" not in model_input:
            model_input["spec"] = feats.noisy_spec.detach()
        return feats._replace(noisy_spec=model_input["spec"].to(feats.noisy_spec.device))

    for device in ("cuda", "cpu"):
        m = create_hybrid_vit(config, compute_dtype=compute_dtype)
        m.load_state_dict(model.state_dict())
        m.to(device)
        opt = Capturing(parameters(m), **adamw)
        step, _ = make_step_fns(m, opt, loss_cfg, cfg, SpecAugmentConfig(), augment=False,
                                use_attention_mask=mask_padding, output_mode=output_mode)
        if compute_dtype != torch.float32:
            trainer_module.featurize_batch = same_input
        try:
            metrics = step(batch_to_device(batch, device))
        finally:
            trainer_module.featurize_batch = featurize
        res[device] = ({k: float(v) for k, v in metrics.items()}, opt.grads,
                       {k: v.cpu() for k, v in m.state_dict().items() if "running" in k},
                       [p.detach().cpu() for p in parameters(m)])
    (lc, gc, sc, pc), (lp, gp, sp, _) = res["cuda"], res["cpu"]
    g_scale = max(float(x.abs().max()) for x in gp)
    leaf, whole = {}, {}
    for name, a, b in zip(names, gc, gp):
        err, own = float((a - b).abs().max()), float(b.abs().max())
        leaf[name] = err / own if own > 0 else (0.0 if err == 0 else float("inf"))
        whole[name] = err / g_scale
    ref = Optimizer([t.clone() for t in initial], **adamw)
    ref.step(gc)
    ulps = (0.0, "")
    for name, a, b, p0 in zip(names, pc, ref.params, initial):
        unit = torch.maximum(p0.abs(), b.abs())
        spacing = torch.nextafter(unit, torch.tensor(float("inf"))) - unit
        ulps = max(ulps, (float(((a - b).abs() / spacing).max()), name))
    return {"loss": max(abs(lc[k] - lp[k]) for k in lp if k != "grad_norm"),
            "stats": max_err([sc[k] for k in sp], list(sp.values())),
            "leaf": leaf, "model": whole, "param_ulps": ulps}


def check_step(errs: dict, what: str = "one step, depth 1") -> None:
    """Print ``step_cuda_vs_cpu``'s errors; raise unless each is within its
    tolerance."""
    def worst(in_block: bool) -> tuple[float, str]:
        return max((e, n) for n, e in errs["leaf"].items()
                   if n.startswith("transformer.blocks.") == in_block)

    (block_err, block_name), (other_err, other_name) = worst(True), worst(False)
    top = sorted(((e, n) for n, e in errs["leaf"].items()), reverse=True)[:4]
    model_err, model_name = max((e, n) for n, e in errs["model"].items())
    ulps, ulps_name = errs["param_ulps"]
    print(f"{what}, cuda vs cpu: loss components {errs['loss']:.2e} (tolerance "
          f"{TOL_STEP_LOSS}), BatchNorm statistics {errs['stats']:.2e} (tolerance "
          f"{TOL_STEP_STATS}); gradients, max abs error relative to each parameter's largest "
          f"|grad|: the transformer block's {block_err:.2e} ({block_name}; tolerance "
          f"{TOL_STEP_GRAD_BLOCK}), every other parameter's {other_err:.2e} ({other_name}; "
          f"tolerance {TOL_STEP_GRAD}), largest {[(n, f'{e:.2e}') for e, n in top]}; relative to "
          f"the model's largest |grad| {model_err:.2e} ({model_name}); parameters after AdamW "
          f"against AdamW on the cpu from cuda's gradients {ulps:g} ulp ({ulps_name}; tolerance "
          f"{TOL_STEP_PARAM_ULPS})", flush=True)
    if (errs["loss"] > TOL_STEP_LOSS or errs["stats"] > TOL_STEP_STATS
            or block_err > TOL_STEP_GRAD_BLOCK or other_err > TOL_STEP_GRAD
            or ulps > TOL_STEP_PARAM_ULPS):
        raise AssertionError(f"{what}: a train step on cuda differs from the same step on cpu")


def sweep(enhancer, batches, in_flight: int) -> None:
    """Enhance ``batches`` (lists of waveforms) and trim every row to its
    clip: through ``enhance_batch_async`` with ``in_flight`` batches
    dispatched ahead of the one being read, or, at 0, through the blocking
    ``enhance_batch``."""
    if not in_flight:
        for b in batches:
            enhancer.enhance_batch(b)
        return

    def take(wavs, batch) -> list:
        out = batch.result()
        return [out[i, : len(w)].copy() for i, w in enumerate(wavs)]

    pending = []
    for b in batches:
        pending.append((b, enhancer.enhance_batch_async(b)))
        if len(pending) > in_flight:
            take(*pending.pop(0))
    for wavs, batch in pending:
        take(wavs, batch)


def optimizer_kernels(dev: torch.device, smi: str) -> dict:
    """7b: ``global_sq_norm`` and ``adam_update`` at the parameter sets of the
    benchmark's 28M and 168M models (``OPT_CONFIGS``), fresh fp32 tensors:
    the norm twice (the same bits, within 1e-7 of a float64 sum), two AdamW
    steps (clip 1.0, engaged) of the kernel and of the plain loop from the
    same state by the same norm (p, m and v bit-equal), one launch of each a
    call; then each kernel's time against its plain version and PyTorch's
    own multi-tensor calls, beside its bytes bound, the whole chain against
    PyTorch's (``clip_grad_norm_(foreach=True)`` and ``AdamW(fused=True)``),
    and the host cost of the wrapper's per-tensor checks, which it skips on a
    pointer table it has checked before."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
        create_hybrid_vit,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_optimizer as co, kernels,
    )

    phase("optimizer kernels: global_sq_norm and adam_update at the 28M and 168M parameter sets")
    hyper = dict(lr=TRAIN_LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01, adamw=True)
    errs = {"global_sq_norm": [], "adam_update": []}
    ms = {"global_sq_norm": {}, "adam_update": {}}
    n_fresh = 8
    for i, name in enumerate(OPT_CONFIGS):
        c = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
        with torch.device("meta"):
            shapes = [tuple(p.shape) for p in create_hybrid_vit(
                {"model": c["model"], "audio": c["audio"]}).parameters()]
        g = torch.Generator(device=dev).manual_seed(i)
        # gradients of norm ~1e-3 sqrt(n) > 1: the clip engages
        params, grads, mu = ([torch.randn(s, device=dev, generator=g) * scale for s in shapes]
                             for scale in (1.0, 1e-3, 1e-3))
        nu = [torch.rand(s, device=dev, generator=g) * 1e-6 for s in shapes]
        n = sum(p.numel() for p in params)

        kernels.reset_launch_counts()
        norm, again = co.global_norm(grads), co.global_norm(grads)
        norm_launches = kernels.launched()
        exact = sum(float(torch.sum(t.double() ** 2)) for t in grads) ** 0.5
        plain_norm = float(co.global_norm_plain(grads))
        errs["global_sq_norm"].append(abs(float(norm) - exact))
        start = [[t.clone() for t in x] for x in (params, mu, nu)]
        kernels.reset_launch_counts()
        for count in (1, 2):
            co.adam_update(params, grads, mu, nu, count=count, g_norm=norm, max_norm=1.0, **hyper)
        adam_launches = kernels.launched()
        for count in (1, 2):
            co.adam_update_plain(start[0], grads, *start[1:], count=count, g_norm=norm,
                                 max_norm=1.0, **hyper)
        gap = max(float((a - b).abs().max()) for x, y in zip((params, mu, nu), start)
                  for a, b in zip(x, y))
        errs["adam_update"].append(gap)
        print(f"{name}: {len(shapes)} tensors, {n:,} parameters; global_sq_norm {float(norm)!r} "
              f"(again {float(again)!r}; float64 sum {exact!r}, plain fp32 {plain_norm!r}), "
              f"launches {norm_launches}; two adam_update steps by it vs the plain loop: max abs "
              f"gap of p, m, v {gap:.3g}, launches {adam_launches}", flush=True)
        if (not torch.equal(norm, again) or abs(float(norm) - exact) > 1e-7 * exact
                or norm_launches != {"global_sq_norm": 2}):
            raise AssertionError(f"{name}: global_sq_norm not deterministic, off the float64 sum "
                                 f"or not one launch a call")
        if gap != 0.0 or adam_launches != {"adam_update": 2}:
            raise AssertionError(f"{name}: adam_update differs from the loop's bits or is not one "
                                 f"launch a step")
        del start

        # times: the count of each call is its input (each call a new step)
        steps = [(k + 3,) for k in range(n_fresh)]
        pl = [torch.nn.Parameter(p.clone()) for p in params]
        for p, gr in zip(pl, grads):
            p.grad = gr.clone()
        lib_opt = torch.optim.AdamW(pl, lr=TRAIN_LR, weight_decay=0.01, fused=True)
        timed = {  # name: (kernel, plain version, PyTorch's multi-tensor call, inputs, bytes)
            "adam_update": (
                lambda k: co.adam_update(params, grads, mu, nu, count=k, g_norm=norm,
                                         max_norm=1.0, **hyper),
                lambda k: co.adam_update_plain(params, grads, mu, nu, count=k, g_norm=norm,
                                               max_norm=1.0, **hyper),
                lambda k: lib_opt.step(), steps, 28 * n),  # p, g, m, v read; p, m, v written
            "global_sq_norm": (
                lambda: co.global_norm(grads), lambda: co.global_norm_plain(grads),
                lambda: torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))),
                [()] * n_fresh, 4 * n),  # g read
        }
        for kname, (kern, plain, lib_call, inputs, nbytes) in timed.items():
            k1, p1, l1, l2, p2, k2 = (median_ms(f, inputs[:4] if f is plain else inputs)
                                      for f in (kern, plain, lib_call, lib_call, plain, kern))
            b_ms, b_by = bound(0.0, nbytes, FP32_PEAK)
            m = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": min(l1, l2),
                 "bound_ms": b_ms, "bound_by": b_by, "device_ms": device_ms(kern, inputs),
                 "plain_device_ms": device_ms(plain, inputs[:2]),
                 "library_device_ms": device_ms(lib_call, inputs)}
            if i == 0:
                ms[kname].update(m)
            else:
                ms[kname][f"at_{name}"] = m
            print(f"{name} {kname}: per call {m['ms']:.4f} ms (device {m['device_ms']:.4f}), "
                  f"plain loop {m['plain_ms']:.4f} ms (device {m['plain_device_ms']:.4f}), "
                  f"PyTorch's multi-tensor call {m['library_ms']:.4f} ms (device "
                  f"{m['library_device_ms']:.4f}); bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e9:.3f} "
                  f"GB at {HBM_RATE / 1e12:g} TB/s); share of bound {b_ms / m['ms']:.1%} per call, "
                  f"{b_ms / m['device_ms']:.1%} on the device (per call: median of 5 runs of "
                  f"{len(inputs)} calls back to back; {smi})", flush=True)
        # the whole chain a step, ours against PyTorch's multi-tensor calls
        chain = {
            "global_sq_norm + adam_update": lambda k: co.adam_update(
                params, grads, mu, nu, count=k, g_norm=co.global_norm(grads), max_norm=1.0,
                **hyper),
            "clip_grad_norm_(foreach) + AdamW(fused)": lambda k: (
                torch.nn.utils.clip_grad_norm_(pl, 1.0, foreach=True), lib_opt.step()),
        }
        walls = {what: [median_ms(f, steps) for _ in range(2)] for what, f in chain.items()}
        dev_chain = {what: device_ms(f, steps) for what, f in chain.items()}
        print(f"{name} the clip and AdamW a step: " + "; ".join(
            f"{what} {min(w):.4f} ms (device {dev_chain[what]:.4f})" for what, w in walls.items())
            + f" ({smi})", flush=True)
        # the wrapper's host cost a call, its p, m, v checks skipped (the table
        # checked before) and made (the record of checked tables cleared)
        warm = [host_us(timed["adam_update"][0], (3,), calls=20) for _ in range(3)]
        cold = [host_us(lambda k: (co._checked.clear(), timed["adam_update"][0](k)), (3,),
                        calls=20) for _ in range(3)]
        ms["adam_update"].setdefault("host_ms", {})[name] = statistics.median(warm) / 1e3
        ms["adam_update"].setdefault("host_checked_ms", {})[name] = statistics.median(cold) / 1e3
        print(f"{name} adam_update host ms a call: {statistics.median(warm) / 1e3:.4f} with the "
              f"checks skipped, {statistics.median(cold) / 1e3:.4f} with the p, m, v checks "
              f"made ({len(shapes)} tensors; medians of 3 x 20 calls; {smi})", flush=True)
        del params, grads, mu, nu, pl, lib_opt, timed, chain
        torch.cuda.empty_cache()
    return {"errs": errs, "ms": ms}


def offline(dev: torch.device, smi: str, rng: np.random.Generator, keep: Path) -> dict:
    """Phase 8. Returns every kernel's launches in the evaluate CLI's cuda
    run; copies the noisy PCM16 files to ``keep`` (phase 12 decodes them)."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.enhance import (
        main as enhance_cli,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.evaluate import (
        main as evaluate_cli,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import (
        load_audio, save_wav, wav_info,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
        AudioEnhancer, load_model_for_inference,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
        create_hybrid_vit, init_weights,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import kernels
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )

    phase("offline: enhance and evaluate at full width")
    t_phase = time.perf_counter()

    def check_path(launches: dict, what: str) -> None:
        if set(launches) != set(SERVING):
            raise AssertionError(f"{what}: a kernel of the path did not run, or another "
                                 f"kernel did: {launches}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 1. the 28M serving recipe, BatchNorm made non-trivial (at init the
        # fold would be nearly the identity)
        config = {"model": {"output_mode": "mask", "head": "fullres_mask",
                            "transformer": {"pos_embed": "factored_2d"}}}
        model = init_weights(create_hybrid_vit(config), torch.Generator().manual_seed(0))
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, torch.nn.BatchNorm2d):
                    n = mod.num_features
                    mod.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
                    mod.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.3, n)))
                    mod.running_mean.copy_(torch.from_numpy(rng.normal(0.0, 0.5, n)))
                    mod.running_var.copy_(torch.from_numpy(rng.uniform(0.2, 3.0, n)))
        ckpt = save_checkpoint(tmp / "ckpt", model, config=config)
        del model
        # 2. 64 pairs of 1-6 s and one of 10 s, PCM16, noise at -5 to 15 dB
        seconds = list(rng.uniform(1.0, 6.0, 64)) + [10.0]
        for i, sec in enumerate(seconds):
            clean = speechlike(int(sec * SR), rng)
            noise = rng.standard_normal(len(clean)).astype(np.float32)
            gain = np.sqrt(np.mean(clean**2) / np.mean(noise**2) / 10 ** (rng.uniform(-5, 15) / 10))
            save_wav(tmp / "clean" / f"p{i:03d}.wav", clean, SR)
            save_wav(tmp / "noisy" / f"p{i:03d}.wav", np.clip(clean + gain * noise, -1, 1), SR)
        names = sorted(p.name for p in (tmp / "noisy").glob("*.wav"))
        shutil.copytree(tmp / "noisy", keep)
        audio_s = sum(wav_info(tmp / "noisy" / n)[0] for n in names) / SR
        common = ["--checkpoint", str(ckpt), "--config-dir", str(tmp / "no_config")]

        # 3. the enhance CLI over the directory, plain and folded
        outs, enhance_s = {}, {}
        for mode, extra in (("plain", []), ("folded", ["--fold-bn"])):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = enhance_cli(common + ["--device", "cuda", "--input", str(tmp / "noisy"),
                                       "--output", str(tmp / mode), "--batch-size", "32",
                                       "--mask-padding"] + extra)
            enhance_s[mode] = time.perf_counter() - t0
            launches = kernels.launched()
            check_path(launches, f"enhance CLI ({mode})")
            outs[mode] = {}
            for n in names:
                y = load_audio(tmp / mode / n, SR)[0]
                if rc or len(y) != wav_info(tmp / "noisy" / n)[0] or not np.isfinite(y).all():
                    raise AssertionError(f"enhance CLI ({mode}): exit {rc}, {n} malformed")
                outs[mode][n] = y
            print(f"enhance CLI ({mode}): {len(names)} files, {audio_s:.1f} audio-s in "
                  f"{enhance_s[mode]:.2f} s (model load and kernel use included), launches "
                  f"{launches}; {smi}", flush=True)
        fold_err = max(float(np.abs(outs["folded"][n] - outs["plain"][n]).max()) for n in names)
        print(f"enhance CLI folded vs plain: max abs err {fold_err:.3g} over {len(names)} PCM16 "
              f"files (tolerance {TOL_WAVE})", flush=True)
        if fold_err > TOL_WAVE:
            raise AssertionError("the folded model's output differs from the plain model's")

        # 4. the evaluate CLI on cuda, then on cpu over the first 4 files
        results = {}
        offline_launches = None
        for device, extra in (("cuda", ["--batch-size", "32", "--metric-workers", "2"]),
                              ("cpu", ["--batch-size", "32", "--metric-workers", "0",
                                       "--max-files", "4"])):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = evaluate_cli(common + ["--device", device, "--noisy-dir", str(tmp / "noisy"),
                                        "--clean-dir", str(tmp / "clean"), "--mask-padding",
                                        "--output", str(tmp / f"eval_{device}.json")] + extra)
            wall = time.perf_counter() - t0
            if device == "cuda":
                offline_launches = kernels.launched()
                check_path(offline_launches, "evaluate CLI")
            results[device] = json.loads((tmp / f"eval_{device}.json").read_text())
            meta = results[device]["summary"]["_meta"]
            print(f"evaluate CLI on {device}: exit {rc}, {len(results[device]['per_file'])} "
                  f"files in {wall:.2f} s; its own sweep {meta['audio_seconds_per_second']:.1f} "
                  f"audio-s/s ({meta['audio_seconds']:.1f} audio-s in {meta['wall_seconds']:.2f} "
                  f"s, {meta['metric_workers']:g} metric workers, PESQ {meta['pesq_impl']}); "
                  f"{smi}", flush=True)
            if rc:
                raise AssertionError(f"the evaluate CLI on {device} exited {rc}")
        rows = results["cuda"]["per_file"]
        if sorted(rows) != names or not all(np.isfinite(r[k]) for r in rows.values()
                                            for k in ("si_sdr", "stoi", "pesq")):
            raise AssertionError("the evaluate CLI's rows are missing or not finite")
        summary = results["cuda"]["summary"]
        print("evaluate summary (cuda): " + ", ".join(
            f"{k} {summary[k]['mean']:.4f}" for k in ("si_sdr", "si_sdr_improvement", "stoi",
                                                     "pesq", "lsd")), flush=True)
        worst = {}
        for n, row in results["cpu"]["per_file"].items():
            for k, v in row.items():
                key = k.replace("noisy_", "").replace("_improvement", "")
                worst[k] = max(worst.get(k, 0.0), abs(v - rows[n][k]))
                if abs(v - rows[n][k]) > TOL_METRIC[key]:
                    raise AssertionError(f"{n} {k}: cpu {v} vs cuda {rows[n][k]}")
        print(f"evaluate cpu vs cuda over {len(results['cpu']['per_file'])} files, max abs "
              f"difference per metric {({k: float(f'{v:.3g}') for k, v in worst.items()})} "
              f"(tolerances {TOL_METRIC})", flush=True)

        # 5. the same batches swept with two in flight and one at a time
        model, cfg = load_model_for_inference(ckpt, device=dev)
        enhancer = AudioEnhancer(model, cfg, device=dev, mask_padding=True)
        clips = [load_audio(tmp / "noisy" / n, SR)[0] for n in names[:64]]
        clips.sort(key=len)
        sweep_s = sum(len(c) for c in clips) / SR
        for size in (8, 32):
            batches = [clips[i : i + size] for i in range(0, len(clips), size)]
            sweep(enhancer, batches, 2)  # each bucket's first call
            sweep(enhancer, batches, 0)

            def timed(in_flight: int) -> float:
                walls = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sweep(enhancer, batches, in_flight)
                    walls.append(time.perf_counter() - t0)
                return statistics.median(walls)

            a1, b1, b2, a2 = (timed(k) for k in (2, 0, 0, 2))
            piped, blocking = min(a1, a2), min(b1, b2)
            times = device_times(lambda: sweep(enhancer, batches, 2))
            busy = sum(times.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sweep(enhancer, batches, 2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"sweep of {len(clips)} clips ({sweep_s:.1f} audio-s) in {len(batches)} batches "
                  f"of {size}: two in flight {piped * 1e3:.1f} ms = {sweep_s / piped:.1f} "
                  f"audio-s/s, blocking {blocking * 1e3:.1f} ms = {sweep_s / blocking:.1f} "
                  f"audio-s/s ({blocking / piped:.3f}x; better median of 3 of two runs each); "
                  f"device busy {busy:.2f} ms of the pipelined sweep's {wall * 1e3:.1f} ms wall = "
                  f"{busy / (wall * 1e3):.1%} (profiler; wall unprofiled); {smi}", flush=True)
        del enhancer, model
    print(f"offline phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": offline_launches}


def training(dev: torch.device, smi: str, rng: np.random.Generator, g: torch.Generator) -> dict:
    """Phase 9. Returns K2 backward's max abs errors and times, and every
    kernel's launches in the ``TRAIN_STEPS`` full-width train steps."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.train import (
        main as train_cli,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.augmentation import (
        SpecAugmentConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import save_wav
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
        create_hybrid_vit, init_weights,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models.components import (
        patch_validity_mask,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_attention, kernels,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.losses import (
        LossConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
        Optimizer, parameters,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
        batch_to_device, make_step_fns,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
        load_model_weights, read_meta,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.config import (
        dump_yaml, load_all_configs, set_config_value,
    )

    phase("training")
    t_phase = time.perf_counter()
    cfg = STFTConfig()
    heads, dh, n_frames, n_tok = 8, 64, 384, 16 * 24  # the 384-frame bucket's patch grid
    wav_len = (n_frames - 1) * cfg.hop_length
    scale = dh**-0.5

    tb = loader_batch(TRAIN_BATCH, 1.5 * SR, wav_len, rng)
    assert tb["noisy_audio"].shape == (TRAIN_BATCH, wav_len) and tb["noisy_audio"].dtype == np.int16

    def patch_mask(lengths: np.ndarray) -> torch.Tensor:
        return patch_validity_mask(torch.from_numpy(lengths), cfg.num_bins, n_frames,
                                   cfg.hop_length).to(dev)

    # a. K2's backward against autograd through the plain version
    train_mask = patch_mask(tb["length"].astype(np.int64))
    mix_mask = patch_mask(np.linspace(SR, wav_len, TRAIN_BATCH).astype(np.int64))
    ragged = torch.rand(4, 200, generator=g) > 0.3
    ragged[0] = False  # a row with every key masked
    single = torch.rand(3, 37, generator=g) > 0.3
    single[1] = False
    single[1, 20] = True  # a row keeping a single key
    rel_errs, abs_errs = [], []
    for b, n, mask in ((TRAIN_BATCH, n_tok, train_mask), (TRAIN_BATCH, n_tok, mix_mask),
                       (TRAIN_BATCH, n_tok, None), (4, 200, ragged.to(dev)),
                       (3, 37, single.to(dev))):
        q, k, v, dout = (torch.randn(b, heads, n, dh, generator=g).to(dev) for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(cuda_attention.attention(*leaves, scale=scale, mask=mask),
                                  leaves, dout)
        ref = cuda_attention.attention_bwd_plain(q, k, v, dout, scale=scale, mask=mask)
        rel_errs.append([float((a - r).abs().max() / r.abs().max()) for a, r in zip(got, ref)])
        abs_errs.append(max_err(got, ref))
        if mask is not None:  # [B, N] masks as [B, N, H, D]: dk of a masked key is 0, and
            by_key = [t.permute(0, 2, 1, 3) for t in got]  # its dv unless its row keeps none
            if by_key[1][~mask].any() or by_key[2][~mask & mask.any(dim=1, keepdim=True)].any():
                raise AssertionError(f"K2 backward: a masked key's dk or dv is not 0 (N = {n})")
    print(f"attention_bwd vs plain (train mask, length mix, no mask, N = 200 with a fully masked "
          f"row, N = 37 with a one-key row): dq/dk/dv max err relative to the largest |grad| "
          f"{[[f'{e:.2e}' for e in r] for r in rel_errs]} (tolerance {TOL_BWD}); max abs err "
          f"{[f'{e:.2e}' for e in abs_errs]}", flush=True)
    if max(max(r) for r in rel_errs) > TOL_BWD:
        raise AssertionError("K2's backward disagrees with its plain version")

    # b. full width: the README's recipe, attention dropout 0 so that K2 runs
    shipped = {"model": {**RECIPE["model"], "transformer": {"pos_embed": "factored_2d"}}}
    aug_gen = torch.Generator(device=dev)

    def step_fns(model, opt, **kw):
        return make_step_fns(model, opt, LossConfig(log_l1_weight=0.05), cfg, SpecAugmentConfig(),
                             augment=True, use_attention_mask=True, output_mode="mask",
                             generator=aug_gen, **kw)

    def build(config):
        model = init_weights(create_hybrid_vit(config), torch.Generator().manual_seed(0)).to(dev)
        opt = Optimizer(parameters(model), "adamw", lr=TRAIN_LR, weight_decay=0.01, max_norm=1.0)
        return (model, opt, *step_fns(model, opt))

    model, opt, train_step, eval_step = build(RECIPE)
    batch = batch_to_device(tb, dev)
    kernels.reset_launch_counts()
    losses = []
    for _ in range(TRAIN_STEPS):
        aug_gen.manual_seed(1)  # the same SpecAugment draws each step, so the batch's loss can fall
        metrics = train_step(batch)
        losses.append(float(metrics["total"]))
        if float(metrics["nonfinite_skipped"]):
            raise AssertionError("a full-width train step was skipped as non-finite")
    train_launches = kernels.launched()
    kernels.reset_launch_counts()
    val = {k: float(v) for k, v in eval_step(batch).items()}
    eval_launches = kernels.launched()
    print(f"full width: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M parameters, "
          f"batch {TRAIN_BATCH} x {tb['length'].min() / SR:.2f}-{tb['length'].max() / SR:.2f} s "
          f"PCM16; losses of {TRAIN_STEPS} steps on one batch {[f'{x:.5f}' for x in losses]}; "
          f"launches {train_launches}; eval step {val}, launches {eval_launches}", flush=True)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"the full-width loss is not finite and falling: {losses}")
    want = {"stft_mag": 2, "attention_fwd": 6, "attention_bwd": 6, **OPT_STEP}
    if train_launches != {k: TRAIN_STEPS * c for k, c in want.items()}:
        raise AssertionError(f"train steps' launches {train_launches}, not {want} a step")
    if eval_launches != {"stft_mag": 2, "attention_fwd": 6} or not np.isfinite(val["total"]):
        raise AssertionError(f"eval step: launches {eval_launches}, loss {val['total']}")

    # one step at depth 1, dropouts 0, on cuda and on cpu from the same weights
    check_step(step_cuda_vs_cpu(rng))

    # c. the shipped dropouts: attention dropout 0.1 trains through explicit weights
    _, _, shipped_step, _ = build(shipped)
    kernels.reset_launch_counts()
    shipped_losses = [float(shipped_step(batch)["total"]) for _ in range(2)]
    shipped_launches = kernels.launched()
    print(f"shipped dropouts (attention dropout 0.1): losses {shipped_losses}, launches "
          f"{shipped_launches}", flush=True)
    if not np.isfinite(shipped_losses).all() or shipped_launches != {
            "stft_mag": 4, **{k: 2 * c for k, c in OPT_STEP.items()}}:
        raise AssertionError("the explicit-weights path launched K2, or its loss is not finite")

    # d. the training CLI, one epoch on 8 synthetic pairs at small width
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for i, length in enumerate(np.linspace(SR, 2 * SR, 8).astype(int)):
            clean = speechlike(int(length), rng)
            save_wav(tmp / "data" / "clean_trainset_28spk_wav" / f"p{i:03d}.wav", clean, SR)
            save_wav(tmp / "data" / "noisy_trainset_28spk_wav" / f"p{i:03d}.wav",
                     clean + 0.1 * rng.standard_normal(length).astype(np.float32), SR)
        conf = load_all_configs(ROOT / "config")
        for key, value in (("training.use_amp", False), ("training.num_epochs", 1),
                           ("training.batch_size", 4), ("training.num_workers", 2),
                           ("training.logging.use_tensorboard", False),
                           ("training.logging.save_audio_samples", False),
                           ("model.transformer.attention_dropout", 0.0),
                           ("model.transformer.embed_dim", 64), ("model.transformer.num_heads", 4),
                           ("model.transformer.num_layers", 2),
                           ("model.encoder.channels", [16, 32, 64]),
                           ("model.decoder.channels", [32, 16, 8, 1])):
            set_config_value(conf, key, value)
        (tmp / "config").mkdir()
        (tmp / "config" / "train_config.yaml").write_text(dump_yaml(conf) + "\n")
        kernels.reset_launch_counts()
        rc = train_cli(["--config-dir", str(tmp / "config"), "--data-root", str(tmp / "data"),
                        "--checkpoint-dir", str(tmp / "ckpt"), "--log-dir", str(tmp / "logs"),
                        "--device", "cuda", "--mask-padding", "--output-mode", "mask",
                        "--head", "fullres_mask", "--pos-embed", "factored_2d"])
        cli_launches = kernels.launched()
        read_back = {}
        for name in ("best_model", "final_model"):
            path = tmp / "ckpt" / name
            m = load_model_weights(path, create_hybrid_vit(read_meta(path)["config"]))
            read_back[name] = all(bool(torch.isfinite(t).all()) for t in m.state_dict().values()
                                  if t.is_floating_point())
        print(f"training CLI: exit {rc}, launches {cli_launches}, checkpoints read back "
              f"{read_back}", flush=True)
        if rc != 0 or not all(read_back.values()) or not {*TRAINING, *OPT_STEP} <= set(
                cli_launches):
            raise AssertionError("the training CLI failed")

    # e. times: K2's backward on fresh inputs under the train batch's mask
    n_fresh = 8
    bwd_in = []
    for _ in range(n_fresh):
        q, k, v, dout = (torch.randn(TRAIN_BATCH, heads, n_tok, dh, generator=g).to(dev)
                         for _ in range(4))
        out, lse = cuda_attention._forward_kernel(q, k, v, train_mask, scale, with_lse=True)
        bwd_in.append((q, k, v, out, lse, dout))

    def graphs(fwd):
        """Each input's forward through ``fwd``, kept for a backward alone."""
        made = []
        for q, k, v, _, _, dout in bwd_in:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            made.append((leaves, fwd(*leaves), dout))
        return made

    plain_in = graphs(lambda q, k, v: cuda_attention.attention_plain(q, k, v, scale=scale,
                                                                     mask=train_mask))
    sdpa_in = graphs(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, attn_mask=train_mask[:, None, None, :], scale=scale))

    def kern(q, k, v, out, lse, dout):  # the launch that sevit::attention_bwd makes
        return cuda_attention._backward_kernel(q, k, v, out, lse, dout, train_mask, scale)

    def grad(leaves, out, dout):
        return torch.autograd.grad(out, leaves, dout, retain_graph=True)

    p1, k1, l1, l2, k2, p2 = (median_ms(f, inputs) for f, inputs in (
        (grad, plain_in), (kern, bwd_in), (grad, sdpa_in), (grad, sdpa_in), (kern, bwd_in),
        (grad, plain_in)))
    kept = int(train_mask.sum())
    flops = 10.0 * heads * n_tok * dh * kept  # S, dP, dq, dk, dv over the kept keys
    nbytes = (4 * (8 * TRAIN_BATCH * heads * n_tok * dh + TRAIN_BATCH * heads * n_tok)
              + TRAIN_BATCH * n_tok)  # q, k, v, O, dO, lse, mask read; dq, dk, dv written
    b_ms, b_by = bound(flops, nbytes, TF32X3_PEAK)  # fp32-accurate products, as K2's forward
    bwd = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": min(l1, l2),
           "bound_ms": b_ms, "bound_by": b_by, "device_ms": device_ms(kern, bwd_in),
           "max_rel_err": max(max(r) for r in rel_errs)}
    print(f"attention_bwd at q/k/v [{TRAIN_BATCH}, {heads}, {n_tok}, {dh}] under the train "
          f"batch's mask ({kept} of {TRAIN_BATCH * n_tok} keys kept): per call {bwd['ms']:.4f} ms "
          f"(device {bwd['device_ms']:.4f}); plain (autograd through attention_plain) "
          f"{bwd['plain_ms']:.4f} ms (device {device_ms(grad, plain_in):.4f}); SDPA's backward "
          f"{bwd['library_ms']:.4f} ms (device {device_ms(grad, sdpa_in):.4f}); bound {b_ms:.4f} "
          f"ms by {b_by} ({flops / 1e9:.3f} GFLOP at {TF32X3_PEAK / 1e12:g} TFLOP/s 3xTF32, "
          f"{nbytes / 1e6:.2f} MB at {HBM_RATE / 1e12:g} TB/s), {b_ms / bwd['device_ms']:.1%} of "
          f"it on the device; {smi}", flush=True)
    del plain_in, sdpa_in
    fwd_in = [t[:3] for t in bwd_in]
    with_lse, without = (
        lambda q, k, v, lse=lse: cuda_attention._forward_kernel(q, k, v, train_mask, scale, lse)
        for lse in (True, False))
    a1, b1, b2, a2 = (median_ms(f, fwd_in) for f in (without, with_lse, with_lse, without))
    print(f"attention_fwd at the train shape and mask: per call {min(a1, a2):.4f} ms without the "
          f"log-sum-exp (serving, eval), {min(b1, b2):.4f} ms with it (training); {smi}", flush=True)

    # the full-width train step, on two batches in turns
    batches = [batch, batch_to_device(loader_batch(TRAIN_BATCH, 1.5 * SR, wav_len, rng), dev)]
    audio_s = float(tb["length"].sum()) / SR

    def step_s(step) -> float:
        walls = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batches[i % 2])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls[1:])

    # the same step without the non-finite skip, whose check waits for the
    # device (a host sync between the backward and the optimizer's launches)
    unchecked = step_fns(model, opt, skip_nonfinite=False)[0]
    s1, u1, u2, s2 = (step_s(f) for f in (train_step, unchecked, unchecked, train_step))
    wall, wall_unchecked = min(s1, s2), min(u1, u2)
    print(f"train step, 28M recipe, batch {TRAIN_BATCH} ({audio_s:.2f} audio-s, 384-frame bucket): "
          f"{wall * 1e3:.1f} ms (better median of 5 of two runs) = {audio_s / wall:.1f} audio-s/s; "
          f"without the non-finite skip (no host sync, no BatchNorm copy) "
          f"{wall_unchecked * 1e3:.1f} ms = {audio_s / wall_unchecked:.1f} audio-s/s, so the skip "
          f"costs {(wall - wall_unchecked) * 1e3:.1f} ms ({(wall - wall_unchecked) / wall:.1%} of "
          f"the step); {smi}", flush=True)
    split = op_split(lambda: train_step(batches[0]))
    bwd["path_device_ms"] = split["attention_bwd"] / want["attention_bwd"]
    print(f"train step device time (profiler, one step): busy {split['busy']:.2f} ms; "
          + ", ".join(f"{k} {t:.3f} ms ({t / split['busy']:.1%})" for k, t in split.items()
                      if k != "busy")
          + f"; per launch: attention_fwd {split['attention_fwd'] / want['attention_fwd']:.4f} ms, "
          f"attention_bwd {bwd['path_device_ms']:.4f} ms; {smi}", flush=True)
    print(f"training phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"errs": abs_errs, "ms": bwd, "launches": train_launches}

class GradCapture:
    """Stands in for the optimizer: keeps the gradients it is handed."""

    def __init__(self, params):
        self.params = list(params)
        self.grads = None

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]


def max_leaf_rel(a: list, b: list) -> float:
    """Largest of each leaf's max abs difference over its own largest |a|."""
    return max(float((x - y).abs().max()) / max(float(x.abs().max()), 1e-30)
               for x, y in zip(a, b))


def shipped(dev: torch.device, smi: str, rng: np.random.Generator) -> dict:
    """Phase 10. Returns every kernel's launches in the shipped config's CLI
    epoch and in the 28M remat step."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.train import (
        main as train_cli,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.augmentation import (
        SpecAugmentConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import save_wav
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
        AudioEnhancer,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
        create_hybrid_vit, init_weights,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import kernels
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training import (
        trainer as trainer_module,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.losses import (
        LossConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
        Optimizer, parameters,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
        load_model_weights, read_meta,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.config import (
        load_all_configs,
    )

    phase("shipped config: config/ as shipped, remat, linear attention, at full width")
    t_phase = time.perf_counter()
    cfg = STFTConfig()

    # a. the train CLI on the repo's own config/, unmodified
    shipped_cfg = load_all_configs(ROOT / "config")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 120 pairs of 1.5-3.06 s (the 384-frame bucket): the shipped split
        # (train_val_split 0.9) leaves 108 train and 12 val files, and
        # --max-files 48 keeps 48 and 12
        for i, length in enumerate(rng.uniform(1.5 * SR, 3.06 * SR, 120).astype(int)):
            clean = speechlike(int(length), rng)
            save_wav(tmp / "data" / "clean_trainset_28spk_wav" / f"p{i:03d}.wav", clean, SR)
            save_wav(tmp / "data" / "noisy_trainset_28spk_wav" / f"p{i:03d}.wav",
                     np.clip(clean + 0.1 * rng.standard_normal(length), -1, 1), SR)
        walls, audio = [], []
        real_step_fns = trainer_module.make_step_fns

        def timed_step_fns(*args, **kwargs):  # each train step's wall time
            train_step, eval_step = real_step_fns(*args, **kwargs)

            def timed(batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = train_step(batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                audio.append(float(batch["length"].sum()) / SR)
                return out

            return timed, eval_step

        trainer_module.make_step_fns = timed_step_fns
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            rc = train_cli(["--config-dir", str(ROOT / "config"), "--data-root", str(tmp / "data"),
                            "--max-files", "48", "--epochs", "1", "--device", "cuda",
                            "--profile-dir", str(tmp / "prof"), "--checkpoint-dir",
                            str(tmp / "ckpt"), "--log-dir", str(tmp / "logs")])
        finally:
            trainer_module.make_step_fns = real_step_fns
        cli_s = time.perf_counter() - t0
        shipped_launches = kernels.launched()
        exp = tmp / "logs" / shipped_cfg["training"]["experiment_name"]
        log = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
        epoch = next(r for r in log if "epoch/train_total" in r)
        tb = sorted(p.name for p in (exp / "tb").glob("events.out.tfevents.*")) if (
            exp / "tb").exists() else []
        read_back = {}
        for name in ("best_model", "final_model"):
            path = tmp / "ckpt" / name
            m = load_model_weights(path, create_hybrid_vit(read_meta(path)["config"]))
            read_back[name] = all(bool(torch.isfinite(t).all()) for t in m.state_dict().values()
                                  if t.is_floating_point())
        traces = sorted(p.name for p in (tmp / "prof").glob("*.json"))
        audio_files = sorted(p.name for p in (exp / "audio").glob("*.wav")) if (
            exp / "audio").exists() else []
        step_ms = statistics.median(walls) * 1e3
        sink = (f"TensorBoard events {tb}" if tb else
                "no TensorBoard package here: metrics.jsonl only, and no audio samples (the "
                "JAX rule: samples only where a writer is)")
        print(f"shipped config/ through the train CLI (bf16 input rounding, attention dropout "
              f"0.1, batch 16, 48 train + 12 val files): exit {rc} in {cli_s:.1f} s; "
              f"{len(walls)} train steps, median {step_ms:.1f} ms "
              f"({[round(w * 1e3, 1) for w in walls]}) = "
              f"{statistics.mean(audio) / (step_ms / 1e3):.1f} audio-s/s; epoch losses train "
              f"{epoch['epoch/train_total']:.5f} val {epoch.get('epoch/val_total', float('nan')):.5f}; "
              f"launches {shipped_launches}; files: metrics.jsonl ({len(log)} lines), checkpoints "
              f"read back {read_back}, profiler traces {traces}, {sink}, audio WAVs "
              f"{audio_files}; {smi}", flush=True)
        if (rc != 0 or not all(read_back.values()) or not traces or len(walls) != 3
                or not np.isfinite([epoch["epoch/train_total"], epoch["epoch/val_total"]]).all()):
            raise AssertionError("the shipped config's train CLI run failed")
        # K1 in every featurize and the sample enhancer, K2 in validation and
        # the sample enhancer (training's attention dropout 0.1 takes the
        # explicit weights), K3 in the sample enhancer only, no K2 backward
        if (shipped_launches.get("stft_mag", 0) < 2 * len(walls)
                or shipped_launches.get("attention_fwd", 0) < 6
                or "attention_bwd" in shipped_launches or not set(OPT_STEP) <= set(shipped_launches)
                or ("istft_polar" in shipped_launches) != bool(tb)):
            raise AssertionError(f"the shipped config's run missed a kernel: {shipped_launches}")

    # the shipped config's train step, depth 1, dropouts 0, on cuda and on cpu
    check_step(step_cuda_vs_cpu(rng, config=shipped_cfg, loss_cfg=LossConfig.from_config(
        shipped_cfg), compute_dtype=torch.bfloat16), "shipped config, one bf16 step, depth 1")

    # b. remat: the 28M training recipe (phase 9) and the 12L/1024d/16h stress
    # config (benchmarks/bench_train.py --scaled), each step with and without remat
    wav_len = (384 - 1) * cfg.hop_length
    batch = trainer_module.batch_to_device(loader_batch(TRAIN_BATCH, 1.5 * SR, wav_len, rng), dev)
    audio_s = float(batch["length"].sum()) / SR
    remat = {}
    for name, over in (("28M", {}), ("12L/1024d/16h", {"embed_dim": 1024, "num_heads": 16,
                                                      "num_layers": 12})):
        config = {"model": {**RECIPE["model"], "transformer": {**RECIPE["model"]["transformer"],
                                                               **over}}}
        state = init_weights(create_hybrid_vit(config), torch.Generator().manual_seed(0)).state_dict()
        n_params = sum(t.numel() for k, t in state.items() if "running" not in k
                       and "num_batches" not in k)
        runs = {}
        for on in (False, True):
            model = create_hybrid_vit(config, remat=on)
            model.load_state_dict(state)
            model.to(dev)
            opt = Optimizer(parameters(model), "adamw", lr=TRAIN_LR, weight_decay=0.01, max_norm=1.0)
            step = trainer_module.make_step_fns(
                model, opt, LossConfig(log_l1_weight=0.05), cfg, SpecAugmentConfig(),
                augment=False, use_attention_mask=True, output_mode="mask")[0]
            step(batch)  # first call
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            step(batch)
            launches = kernels.launched()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                step(batch)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            runs[on] = {"ms": statistics.median(walls), "peak_gib":
                        torch.cuda.max_memory_allocated() / 2**30, "launches": launches}
            del model, opt, step
            torch.cuda.empty_cache()
        remat[name] = runs
        off, on = runs[False], runs[True]
        print(f"remat, {name} ({n_params / 1e6:.2f}M parameters), train step at batch "
              f"{TRAIN_BATCH} ({audio_s:.2f} audio-s, 384-frame bucket), attention dropout 0: "
              f"without {off['ms']:.1f} ms, peak {off['peak_gib']:.2f} GiB, launches "
              f"{off['launches']}; with {on['ms']:.1f} ms, peak {on['peak_gib']:.2f} GiB, launches "
              f"{on['launches']} (median of 3 steps after a first call; max_memory_allocated over "
              f"them); {smi}", flush=True)
        layers = config["model"]["transformer"].get("num_layers", 6)
        # the stress config is what remat is for: at 28M remat left the step's
        # peak where it was (8.12 GiB both, measured on an H100 at 700 W)
        if (on["launches"]["attention_fwd"] != 2 * layers
                or on["launches"]["attention_bwd"] != layers
                or off["launches"]["attention_fwd"] != layers
                or (over and not on["peak_gib"] < off["peak_gib"])):
            raise AssertionError(f"remat at {name}: launches or peak not as expected")

    # remat's gradients against no remat at 28M, dropout and drop-path 0.1, from
    # one seed; cuDNN deterministic, but the bilinear resize's backward adds with
    # atomics, so two runs without remat give the floor
    config = RECIPE
    state = init_weights(create_hybrid_vit(config), torch.Generator().manual_seed(0)).state_dict()
    grads = {}
    torch.backends.cudnn.deterministic = True
    try:
        for key, on in (("a", False), ("b", False), ("remat", True)):
            model = create_hybrid_vit(config, remat=on)
            model.load_state_dict(state)
            model.to(dev)
            cap = GradCapture(parameters(model))
            step = trainer_module.make_step_fns(
                model, cap, LossConfig(log_l1_weight=0.05), cfg, SpecAugmentConfig(),
                augment=False, use_attention_mask=True, output_mode="mask",
                skip_nonfinite=False)[0]
            torch.manual_seed(11)
            step(batch)
            grads[key] = cap.grads
            del model, cap, step
    finally:
        torch.backends.cudnn.deterministic = False
    floor, err = max_leaf_rel(grads["a"], grads["b"]), max_leaf_rel(grads["a"], grads["remat"])
    print(f"remat vs no remat, 28M, dropout and drop-path 0.1, one seed: gradients' max "
          f"difference relative to each leaf's largest {err:.3g}; two runs without remat "
          f"{floor:.3g} (tolerance max(1e-5, 10 x that)); {smi}", flush=True)
    if err > max(1e-5, 10 * floor):
        raise AssertionError("remat changes the gradients")
    del grads

    # c. linear attention: the 28M serving recipe, one clip, cuda vs cpu
    lin = {"model": {**RECIPE["model"], "transformer": {**RECIPE["model"]["transformer"],
                                                        "attention_type": "linear"}}}
    model = init_weights(create_hybrid_vit(lin), torch.Generator().manual_seed(0))
    clip = speechlike(int(2.2 * SR), rng)
    kernels.reset_launch_counts()
    got = AudioEnhancer(model, lin, device=dev, mask_padding=True).enhance(clip)
    lin_launches = kernels.launched()
    ref = AudioEnhancer(model, lin, device="cpu", mask_padding=True).enhance(clip)
    lin_err = float(np.abs(got - ref).max())
    print(f"linear attention, 28M serving recipe, one 2.2 s clip: cuda vs cpu max abs err "
          f"{lin_err:.3g} (tolerance {TOL_WAVE}); launches {lin_launches} (no K2: its einsums "
          f"are matmuls); {smi}", flush=True)
    if lin_err > TOL_WAVE or not np.isfinite(got).all() or "attention_fwd" in lin_launches:
        raise AssertionError("linear attention on cuda differs from cpu")
    print(f"shipped config phase: {time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return {"launches": shipped_launches, "remat_launches": remat["28M"][True]["launches"]}


# ---------------------------------------------------------------------------
# Phase 11: the mesh
# ---------------------------------------------------------------------------

MESH_TIMEOUT = 600  # seconds for a spawned mesh job, build and all
# TP = 2 vs TP = 1 eval output: tests/test_torch_mesh_train.py's limit at its
# small width; at 12L/1024d/16h the larger of it and TP = 1's own cuda-vs-cpu
# difference (the row-parallel sums over half the inputs, then the all-reduce,
# add in another order; measured 2.78e-5 on an H100 at 700 W)
TOL_TP_FORWARD = 2e-5
SCALED = {"embed_dim": 1024, "num_heads": 16, "num_layers": 12}  # bench_train.py --scaled


def depth1(config: dict) -> dict:
    """``config``'s model at depth 1 with every dropout 0."""
    mc = config["model"]
    return {**config, "model": {**mc, "encoder": {**mc.get("encoder", {}), "dropout": 0.0},
                                "transformer": {**mc.get("transformer", {}), "num_layers": 1,
                                                "drop_path_rate": 0.0, "attention_dropout": 0.0,
                                                "dropout": 0.0}}}


def recipe_step_fns(model, opt, mesh=None, augment: bool = False, generator=None, cfg=None):
    """Phase 9's step functions of the training recipe (mask output, fullres
    head, log-L1 0.05, the patch mask), on ``mesh`` when given, at the STFT
    config ``cfg`` (512/128 by default)."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.augmentation import (
        SpecAugmentConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.losses import (
        LossConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
        make_step_fns,
    )

    return make_step_fns(model, opt, LossConfig(log_l1_weight=0.05), cfg or STFTConfig(),
                         SpecAugmentConfig(), augment=augment, use_attention_mask=True,
                         output_mode="mask", generator=generator, mesh=mesh)


def seeded_model(config: dict, dev: torch.device):
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
        create_hybrid_vit, init_weights,
    )

    return init_weights(create_hybrid_vit(config), torch.Generator().manual_seed(0)).to(dev)


def rank_rows(batch: dict, mesh, dev: torch.device) -> dict:
    """This data rank's contiguous rows of a numpy loader batch, on ``dev``."""
    n = len(batch["valid"]) // mesh.data
    lo = mesh.data_rank * n
    return {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + n])).to(dev)
            for k, v in batch.items()}


def mesh_check_task(mesh, job: dict) -> dict:
    """11b: the depth-1 step (dropouts 0, SpecAugment off) on this rank's 8
    rows of each of ``job["check"]``'s batches: metrics, the gradients the
    optimizer is handed (all-reduced), the new BatchNorm statistics."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
        parallelize,
    )

    out = {}
    for name, batch in job["check"].items():
        model = parallelize(seeded_model(depth1(RECIPE), mesh.device), mesh)
        cap = GradCapture(model.parameters())
        step = recipe_step_fns(model, cap, mesh)[0]
        metrics = step(rank_rows(batch, mesh, mesh.device))
        out[name] = ({k: float(v) for k, v in metrics.items()}, [g.cpu() for g in cap.grads],
                     {k: v.cpu() for k, v in model.state_dict().items() if "running" in k})
    return out


def mesh_train_task(mesh, job: dict) -> dict:
    """11b: the full-width training recipe (dropouts 0.1, SpecAugment on,
    AdamW) on this rank's 8 rows: a first step, then ``TRAIN_MESH_STEPS``
    steps whose losses, launches and walls it returns; and the wall of an
    all-reduce of the gradients' bytes over the data group."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import kernels
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.parallel import rank_seed
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.parallel.collectives import (
        all_reduce_,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
        Optimizer, parameters,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
        parallelize,
    )

    dev = mesh.device
    torch.manual_seed(rank_seed(0, mesh.data_rank))
    aug = torch.Generator(device=dev).manual_seed(rank_seed(1, mesh.data_rank))
    model = parallelize(seeded_model(RECIPE, dev), mesh)
    opt = Optimizer(parameters(model), "adamw", lr=TRAIN_LR, weight_decay=0.01, max_norm=1.0)
    step = recipe_step_fns(model, opt, mesh, augment=True, generator=aug)[0]
    batch = rank_rows(job["train"], mesh, dev)
    step(batch)  # first call
    kernels.reset_launch_counts()
    losses, walls = [], []
    for _ in range(TRAIN_MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch)
        losses.append(float(metrics["total"]))  # waits for the step
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = kernels.launched()
    flat = torch.zeros(sum(p.numel() for p in model.parameters()), device=dev)
    reduce_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_(flat, mesh.data_group)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "walls": walls, "launches": launches, "bytes": flat.numel() * 4,
            "reduce_ms": statistics.median(reduce_ms[1:])}


def mesh_tp_task(mesh, job: dict) -> dict:
    """11c: the 12L/1024d/16h recipe at depth 12, dropouts 0, tensor-parallel
    over the model group: its eval output on ``job["tp_spec"]``, then one
    step on ``job["tp_batch"]`` (gradients gathered, saved by rank 0) and an
    AdamW step (clip 1.0) of this rank's shards by them, with the heads each
    K2 call got and the launches of both."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
        attention as attention_module,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import kernels
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.parallel.sharding import (
        tp_gather,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
        Optimizer,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
        parallelize,
    )

    dev = mesh.device
    heads, plain_attention = [], attention_module.attention

    def recording(q, k, v, **kw):
        heads.append(int(q.shape[1]))
        return plain_attention(q, k, v, **kw)

    attention_module.attention = recording
    model = parallelize(seeded_model(scaled_config(), dev), mesh)
    with torch.no_grad():
        forward = model.eval()(torch.from_numpy(job["tp_spec"]).to(dev)).cpu()
    cap = GradCapture(model.parameters())
    step = recipe_step_fns(model, cap, mesh)[0]
    kernels.reset_launch_counts()
    metrics = {k: float(v) for k, v in step(rank_rows(job["tp_batch"], mesh, dev)).items()}
    opt = Optimizer(cap.params, "adamw", lr=TRAIN_LR, weight_decay=0.01, max_norm=1.0)
    opt.step(cap.grads)
    launches = kernels.launched()
    names = [n for n, _ in model.named_parameters()]
    grads = [tp_gather(n, g, mesh).cpu() for n, g in zip(names, cap.grads)]
    return {"forward": forward, "metrics": metrics, "heads": sorted(set(heads)),
            "launches": launches, "grads": grads if mesh.rank == 0 else None,
            "stats": {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}}


MESH_TASKS = {"check": mesh_check_task, "train": mesh_train_task, "tp": mesh_tp_task}
TRAIN_MESH_STEPS = 3


def scaled_config() -> dict:
    """The 12L/1024d/16h recipe with dropouts 0 (so that TP = 2 and TP = 1
    take the same step)."""
    over = {**RECIPE["model"]["transformer"], **SCALED, "drop_path_rate": 0.0, "dropout": 0.0}
    return {"model": {**RECIPE["model"], "encoder": {"dropout": 0.0}, "transformer": over}}


def mesh_rank(rank: int, data: int, model: int, init_method: str, tmp: str) -> None:
    """One spawned rank of a phase 11 job: joins the group over
    ``job["backend"]`` on card ``rank % job["cards"]`` (gloo on CUDA tensors
    where ranks share a card), runs ``job["tasks"]`` and saves what they
    return to ``<tmp>/rank<r>.pt``."""
    import torch.distributed as dist

    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.parallel import (
        initialize_distributed, make_mesh,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    job = torch.load(Path(tmp) / "job.pt", weights_only=False)
    devices = [torch.device("cuda", r % job["cards"]) for r in range(data * model)]
    mesh = initialize_distributed(make_mesh(data, model, devices), rank, backend=job["backend"],
                                  init_method=init_method, timeout=MESH_TIMEOUT)
    try:
        out = {name: MESH_TASKS[name](mesh, job) for name in job["tasks"]}
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_mesh_job(job: dict, data: int, model: int) -> list:
    """Spawn a ``data x model`` mesh of ranks for ``job`` (``job["cards"]``,
    ``job["backend"]``); returns each rank's results (a failing or late rank
    raises)."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.parallel import launch

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(job, Path(tmp) / "job.pt")
        launch(mesh_rank, (data, model, f"file://{tmp}/store", tmp), nprocs=data * model,
               timeout=MESH_TIMEOUT)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(data * model)]


def grad_errs(got: list, ref: list, names: list) -> tuple[float, float]:
    """Max abs error of each gradient relative to its own largest |ref|: the
    worst in the transformer block and the worst elsewhere."""
    block = other = 0.0
    for n, a, b in zip(names, got, ref):
        e = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if n.startswith("transformer.blocks."):
            block = max(block, e)
        else:
            other = max(other, e)
    return block, other


def check_mesh_step(what: str, got: tuple, ref: tuple, names: list) -> None:
    """A mesh step's (metrics, gradients, statistics) against one device's,
    at phase 9's limits."""
    (gm, gg, gs), (rm, rg, rs) = got, ref
    loss = max(abs(gm[k] - rm[k]) for k in rm if k != "grad_norm")
    stats = max(float((gs[k] - rs[k]).abs().max()) for k in rs)
    block, other = grad_errs(gg, rg, names)
    print(f"{what}: loss components {loss:.2e} (tolerance {TOL_STEP_LOSS}), BatchNorm statistics "
          f"{stats:.2e} (tolerance {TOL_STEP_STATS}); gradients relative to each leaf's largest: "
          f"the transformer block's {block:.2e} (tolerance {TOL_STEP_GRAD_BLOCK}), every other "
          f"{other:.2e} (tolerance {TOL_STEP_GRAD})", flush=True)
    if (loss > TOL_STEP_LOSS or stats > TOL_STEP_STATS or block > TOL_STEP_GRAD_BLOCK
            or other > TOL_STEP_GRAD):
        raise AssertionError(f"{what}: the mesh step differs from one device's")


def one_device_step(config: dict, batch: dict, dev: torch.device) -> tuple:
    """(metrics, gradients, new BatchNorm statistics) of one device's step of
    ``config`` on the numpy ``batch`` (SpecAugment off)."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
        batch_to_device,
    )

    model = seeded_model(config, dev)
    cap = GradCapture(model.parameters())
    metrics = recipe_step_fns(model, cap)[0](batch_to_device(batch, dev))
    return ({k: float(v) for k, v in metrics.items()}, [g.cpu() for g in cap.grads],
            {k: v.cpu() for k, v in model.state_dict().items() if "running" in k})


def nccl_world_one(dev: torch.device, train_batch: dict) -> list:
    """11a: NCCL at world size 1: an all-reduce of a known tensor, and the
    recipe's step through the mesh code against the plain step. Returns the
    walls (ms) of all-reduces of the gradients' bytes."""
    import torch.distributed as dist

    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.parallel import (
        initialize_distributed, make_mesh,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.parallel.collectives import (
        all_reduce_,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
        Optimizer, parameters,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
        batch_to_device, parallelize,
    )

    with tempfile.TemporaryDirectory() as tmp:
        one = initialize_distributed(make_mesh(1, 1, [dev]), 0, backend="nccl",
                                     init_method=f"file://{tmp}/store", timeout=MESH_TIMEOUT)
        try:
            known = torch.arange(1024, dtype=torch.float32, device=dev)
            back = all_reduce_(known.clone(), one.data_group)
            if not torch.equal(back, known):
                raise AssertionError("NCCL all-reduce at world size 1 changed its input")
            runs = {}
            torch.backends.cudnn.deterministic = True
            try:
                for key, m in (("plain", None), ("plain again", None), ("mesh", one)):
                    model = seeded_model(RECIPE, dev)
                    if m is not None:
                        model = parallelize(model, m)
                    opt = Optimizer(parameters(model), "adamw", lr=TRAIN_LR, weight_decay=0.01,
                                    max_norm=1.0)
                    aug = torch.Generator(device=dev).manual_seed(1)
                    step = recipe_step_fns(model, opt, m, augment=True, generator=aug)[0]
                    torch.manual_seed(0)
                    metrics = step(batch_to_device(train_batch, dev))
                    runs[key] = ({k: float(v) for k, v in metrics.items()},
                                 [p.detach().cpu() for p in model.parameters()],
                                 [t.cpu() for n, t in model.state_dict().items() if "running" in n])
                    del model, opt, step
            finally:
                torch.backends.cudnn.deterministic = False
            flat = torch.zeros(sum(p.numel() for p in runs["plain"][1]), device=dev)
            nccl_ms = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                all_reduce_(flat, one.data_group)
                torch.cuda.synchronize()
                nccl_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            dist.destroy_process_group()
    # the forward is deterministic (cuDNN deterministic), so the loss terms
    # and the new BatchNorm statistics must agree bit for bit; the backward is
    # not (F.interpolate's bilinear backward adds with atomics), so grad_norm
    # and the parameters after AdamW are held as phase 10b holds remat: within
    # max(1e-5, 10 x) two plain runs' difference
    (pm, pp, ps), (am, ap, _), (mm, mp_, ms_) = runs["plain"], runs["plain again"], runs["mesh"]
    forward_same = all(mm[k] == pm[k] for k in pm if k != "grad_norm") and all(
        torch.equal(a, b) for a, b in zip(ps, ms_))
    drift = max(float((a - b).abs().max()) for a, b in zip(pp, mp_))
    floor = max(float((a - b).abs().max()) for a, b in zip(pp, ap))
    gn_drift = abs(mm["grad_norm"] - pm["grad_norm"])
    gn_floor = abs(am["grad_norm"] - pm["grad_norm"])
    print(f"NCCL world size 1: all-reduce of a known tensor unchanged; the 28M recipe's step "
          f"(batch {TRAIN_BATCH}, cuDNN deterministic) through the mesh code (at one device the "
          f"one-process path: no collective) vs plain: loss terms and "
          f"BatchNorm statistics {'bit for bit' if forward_same else 'DIFFER'}; grad_norm "
          f"{gn_drift:.3g} apart, parameters after AdamW {drift:.3g} (two plain runs: {gn_floor:.3g}, "
          f"{floor:.3g}; tolerance max(1e-5, 10 x that))", flush=True)
    if not forward_same or drift > max(1e-5, 10 * floor) or gn_drift > max(
            1e-5 * pm["grad_norm"], 10 * gn_floor):
        raise AssertionError("the step through the mesh code at world size 1 is not the plain step")
    del runs
    return nccl_ms


def mesh(dev: torch.device, smi: str, rng: np.random.Generator, enhancer, wavs: list,
         out: list, cards: int = 1) -> dict:
    """Phase 11. ``enhancer``, ``wavs`` and ``out``: phase 5's single-device
    enhancer of the 28M serving recipe, its 32 x 3 s batch and its output.
    On one card (``cards`` 1): 11a-11e as the module docstring says. On
    ``cards`` cards: the same checks and times over NCCL, one rank a card:
    ``cards`` data ranks, TP = 2 x DP = ``cards // 2``, a replica a card (no
    11a). Returns the launches per rank of the data-parallel train steps, of
    the TP step, and per replica of the mesh enhancer's batch."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
        AudioEnhancer,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import kernels
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.parallel import make_mesh
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
        Optimizer, parameters,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
        batch_to_device,
    )

    one_card = cards == 1
    backend = "gloo" if one_card else "nccl"  # NCCL refuses two ranks on one card
    ranks_b, (data_c, model_c) = (2, (1, 2)) if one_card else (cards, (cards // 2, 2))
    where = "on this card" if one_card else f"on {cards} cards"
    phase(f"mesh: NCCL at world size 1, two gloo ranks and TP = 2 on this card, two replicas"
          if one_card else f"mesh over NCCL on {cards} cards: {cards} data ranks, TP = 2 x DP = "
          f"{data_c}, {cards} replicas")
    t_phase = time.perf_counter()
    wav_len = (384 - 1) * 128
    train_batch = loader_batch(TRAIN_BATCH, 1.5 * SR, wav_len, rng)
    nccl_ms = nccl_world_one(dev, train_batch) if one_card else None

    # b. data ranks (two on this card over gloo, CUDA tensors; or one a card
    # over NCCL): the depth-1 check on a full batch and on one whose last
    # rank's rows are a padding batch, then the full-width recipe
    rows = TRAIN_BATCH // ranks_b
    check = {"full": train_batch,
             "padding": {**train_batch, "valid": np.arange(TRAIN_BATCH) < TRAIN_BATCH - rows}}
    job = {"cards": cards, "backend": backend}
    t0 = time.perf_counter()
    ranks = run_mesh_job({**job, "tasks": ["check", "train"], "check": check,
                          "train": train_batch}, ranks_b, 1)
    spawn_s = time.perf_counter() - t0
    names = [n for n, p in seeded_model(depth1(RECIPE), "cpu").named_parameters()]
    for case, batch in check.items():
        # BatchNorm normalizes over every row, valid or not, as the JAX step
        # does over its global batch: so the reference is one device's step
        # on the same 16 rows with the same rows invalid
        ref = one_device_step(depth1(RECIPE), batch, dev)
        for rank, r in enumerate(ranks):
            check_mesh_step(f"depth 1, rank {rank} of {ranks_b} x {rows} rows vs one device x "
                            f"{TRAIN_BATCH} ({case})", r["check"][case], ref, names)
    train = [r["train"] for r in ranks]
    per_step = {k: v // TRAIN_MESH_STEPS for k, v in train[0]["launches"].items()}
    rank_steps = [{k: v // TRAIN_MESH_STEPS for k, v in t["launches"].items()} for t in train]
    print(f"{ranks_b} ranks, full width: losses {[[f'{x:.6f}' for x in t['losses']] for t in train]}; "
          f"launches per rank per step {rank_steps}", flush=True)
    want = {"stft_mag": 2, "attention_fwd": 6, "attention_bwd": 6, **OPT_STEP}
    if (any(t["losses"] != train[0]["losses"] for t in train)
            or not np.isfinite(train[0]["losses"]).all()
            or any(t["launches"] != {k: TRAIN_MESH_STEPS * c for k, c in want.items()}
                   for t in train)):
        raise AssertionError(f"the {ranks_b}-rank full-width steps are not finite, equal and "
                             "through every kernel")

    # the one-device step of the same recipe at batch 16, for the walls
    torch.manual_seed(0)
    model = seeded_model(RECIPE, dev)
    opt = Optimizer(parameters(model), "adamw", lr=TRAIN_LR, weight_decay=0.01, max_norm=1.0)
    step = recipe_step_fns(model, opt, augment=True,
                           generator=torch.Generator(device=dev).manual_seed(1))[0]
    batch = batch_to_device(train_batch, dev)
    step(batch)
    walls = []
    for _ in range(TRAIN_MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(batch)["total"])
        walls.append((time.perf_counter() - t0) * 1e3)
    del model, opt, step
    step_ms = [statistics.median(t["walls"]) for t in train]
    print(f"times ({smi}): gradient all-reduce of {train[0]['bytes'] / 1e6:.1f} MB: {backend}, "
          f"{ranks_b} ranks {where}, {train[0]['reduce_ms']:.2f} ms (median of 3)"
          + (f"; NCCL, world size 1, {statistics.median(nccl_ms[1:]):.2f} ms (median of 5)"
             if one_card else "")
          + f". Train step, 28M recipe: {ranks_b} ranks x {rows} rows {step_ms[0]:.1f} ms (rank 0; "
          f"others {[round(x, 1) for x in step_ms[1:]]}) against one process x {TRAIN_BATCH} rows "
          f"{statistics.median(walls):.1f} ms (medians of {TRAIN_MESH_STEPS})"
          + (". Two ranks sharing one card measure the mesh's overhead (gloo through the host, two "
             "processes on one device), not its scaling: NCCL across cards cannot be measured on "
             "a one-card machine" if one_card else "")
          + f". The job's spawn, build and run took {spawn_s:.1f} s", flush=True)

    # c. tensor parallelism over 2 ranks (of this card; or TP = 2 x DP = cards
    # / 2 over NCCL) at 12L/1024d/16h
    tp_batch = loader_batch(4, 1.5 * SR, wav_len, rng)
    tp_spec = rng.random((2, 257, 384, 1)).astype(np.float32)
    t0 = time.perf_counter()
    tp = [r["tp"] for r in run_mesh_job({**job, "tasks": ["tp"], "tp_batch": tp_batch,
                                         "tp_spec": tp_spec}, data_c, model_c)]
    tp_s = time.perf_counter() - t0
    model = seeded_model(scaled_config(), dev)
    n_params = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        forward = model.eval()(torch.from_numpy(tp_spec).to(dev)).cpu()
        # TP = 1 in float32 on the cpu (the plain versions, other summation
        # orders throughout): how far fp32 arithmetic alone moves this output
        on_cpu = model.cpu()(torch.from_numpy(tp_spec))
    del model
    spread = float((on_cpu - forward).abs().max())
    tol_forward = max(TOL_TP_FORWARD, spread)
    ref = one_device_step(scaled_config(), tp_batch, dev)
    names = [n for n, p in seeded_model(scaled_config(), "cpu").named_parameters()]
    fwd_err = max(float((t["forward"] - forward).abs().max()) for t in tp)
    print(f"TP = 2 x DP = {data_c} {where}, 12L/1024d/16h ({n_params / 1e6:.2f}M), eval output "
          f"(batch 2 x 384 frames) vs "
          f"TP = 1 max abs err {fwd_err:.3g} (tolerance {tol_forward:.3g}: the larger of the CPU "
          f"test's {TOL_TP_FORWARD} and TP = 1 cuda vs cpu, {spread:.3g}); K2 heads per call "
          f"{[t['heads'] for t in tp]}; step (batch 4, 384-frame bucket) launches per rank "
          f"{[t['launches'] for t in tp]}; spawn, build and run {tp_s:.1f} s", flush=True)
    check_mesh_step(f"TP = 2 x DP = {data_c} step vs one device",
                    (tp[0]["metrics"], tp[0]["grads"], tp[0]["stats"]), ref, names)
    # the clip's norm under TP is the shards' squares all-reduced, not global_sq_norm
    want_tp = {"stft_mag": 2, "attention_fwd": 12, "attention_bwd": 12, "adam_update": 1}
    if fwd_err > tol_forward or any(t["heads"] != [SCALED["num_heads"] // 2] for t in tp) or any(
            t["launches"] != want_tp for t in tp):
        raise AssertionError("tensor parallelism: output, heads or launches wrong")
    tp_launches = tp[0]["launches"]
    del ref, tp

    # d. inference on replicas (two of this card, or one a card): the 28M
    # serving recipe, against phase 5's one-device enhancer
    replica_devices = [dev, dev] if one_card else [torch.device("cuda", i) for i in range(cards)]
    many = AudioEnhancer(enhancer.model, enhancer.config, device="cuda", io_dtype="int16",
                         mask_padding=True, mesh=make_mesh(len(replica_devices), 1,
                                                           replica_devices))
    many.enhance_batch(wavs[:len(replica_devices)])  # first call
    kernels.reset_launch_counts()
    got = many.enhance_batch(wavs)
    serve_launches = {k: v // len(replica_devices) for k, v in kernels.launched().items()}
    wave_err = max(float(np.abs(a - b).max()) for a, b in zip(got, out))
    serve_ms = {}
    for name, enh in (("one device", enhancer), ("replicas", many), ("replicas again", many),
                      ("one device again", enhancer)):
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enh.enhance_batch(wavs)
            walls.append((time.perf_counter() - t0) * 1e3)
        serve_ms[name] = statistics.median(walls)
    visible = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import (
            save_wav,
        )

        save_wav(Path(tmp) / "in.wav", wavs[0], SR)
        cli = subprocess.run(
            [sys.executable, "-m",
             "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.enhance",
             "--checkpoint", str(ROOT / "tests" / "fixtures" / "tiny_denoiser_mask"),
             "--input", str(Path(tmp) / "in.wav"), "--output", str(Path(tmp) / "out.wav"),
             "--device", "cuda", "--data-parallel", str(visible + 1)],
            capture_output=True, text=True, timeout=300, cwd=ROOT)
    refused = f"{visible + 1} CUDA devices asked for, but {visible} visible"
    print(f"{len(replica_devices)} replicas {where}, {BATCH} x {SECONDS:g} s PCM16: waveforms vs one "
          f"device max abs err {wave_err:.3g} (tolerance {TOL_WAVE}); launches per replica "
          f"{serve_launches}; enhance_batch wall: one device "
          f"{min(serve_ms['one device'], serve_ms['one device again']):.1f} ms, replicas "
          f"{min(serve_ms['replicas'], serve_ms['replicas again']):.1f} ms (in turns, each one's "
          f"better median of 5; {smi}); enhance CLI --data-parallel {visible + 1}: exit "
          f"{cli.returncode}, {cli.stderr.strip().splitlines()[-1:]}", flush=True)
    if (wave_err > TOL_WAVE or len(got) != len(out)
            or serve_launches != {"stft_mag": 1, "attention_fwd": 6, "istft_polar": 1}):
        raise AssertionError("the mesh enhancer differs from one device or skipped a kernel")
    if cli.returncode == 0 or refused not in cli.stderr:
        raise AssertionError(f"enhance --data-parallel {visible + 1} was not refused: {cli.stderr}")
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return {"train": per_step, "tp": tp_launches, "serve": serve_launches}


def train_cli_across_cards(smi: str, cards: int, rng: np.random.Generator) -> None:
    """``--cards N``: the train CLI itself, the shipped ``config/`` over 108 +
    12 synthetic files (7 train batches of 16 an epoch, the last with 12
    rows, and one validation batch of 12): two epochs at ``--data-parallel
    N`` (spawned ranks over NCCL), the same at ``--data-parallel 1``, then a
    third epoch on N cards resumed from the first run's ``final_model``. Each
    N-card run: every rank's final loss equal, one ``metrics.jsonl`` (rank 0
    alone writes) with an epoch line an epoch, checkpoints that read back.
    Prints the second epoch's wall per train batch (loader, step and the
    validation batch included: the CLI's own clock)."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import save_wav
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
        create_hybrid_vit,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
        load_model_weights, read_meta,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.config import (
        load_all_configs,
    )

    phase(f"the train CLI on {cards} cards and on one: the shipped config/, two epochs, a resume")
    t_phase = time.perf_counter()
    exp_name = load_all_configs(ROOT / "config")["training"]["experiment_name"]
    steps = 7  # ceil(108 / 16)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for i, length in enumerate(rng.uniform(1.5 * SR, 3.06 * SR, 120).astype(int)):
            clean = speechlike(int(length), rng)
            save_wav(tmp / "data" / "clean_trainset_28spk_wav" / f"p{i:03d}.wav", clean, SR)
            save_wav(tmp / "data" / "noisy_trainset_28spk_wav" / f"p{i:03d}.wav",
                     np.clip(clean + 0.1 * rng.standard_normal(length), -1, 1), SR)
        runs = {}
        for name, dp, epochs, resume in ((f"{cards} cards", cards, 2, None), ("one card", 1, 2, None),
                                         ("resumed", cards, 3, f"{cards} cards")):
            out = tmp / name.replace(" ", "_")
            cmd = [sys.executable, "-m",
                   "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.train",
                   "--config-dir", str(ROOT / "config"), "--data-root", str(tmp / "data"),
                   "--device", "cuda", "--data-parallel", str(dp), "--epochs", str(epochs),
                   "--checkpoint-dir", str(out / "ckpt"), "--log-dir", str(out / "logs")]
            if resume:
                cmd += ["--resume", str(runs[resume]["ckpt"] / "final_model")]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=MESH_TIMEOUT,
                                  cwd=ROOT)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"train CLI, {name}: exit {proc.returncode}\n"
                                     f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            done = re.findall(r"^(?:rank (\d+): )?done: best val loss ([0-9.eE+-]+|nan) after "
                              r"(\d+) epochs", proc.stdout, re.M)
            logs = sorted((out / "logs").rglob("metrics.jsonl"))
            epoch_lines = [json.loads(line) for line in logs[0].read_text().splitlines()
                           if "epoch/train_total" in line] if logs else []
            read_back = {}
            # (a resumed epoch that does not beat the restored best writes no best_model)
            for ck in ("final_model",) + (() if resume else ("best_model",)):
                m = load_model_weights(out / "ckpt" / ck,
                                       create_hybrid_vit(read_meta(out / "ckpt" / ck)["config"]))
                read_back[ck] = all(bool(torch.isfinite(t).all()) for t in m.state_dict().values()
                                    if t.is_floating_point())
            runs[name] = {"ckpt": out / "ckpt", "done": done, "epochs": epoch_lines, "wall": wall}
            ran = epochs - (2 if resume else 0)
            print(f"train CLI, {name} (--data-parallel {dp}, --epochs {epochs}"
                  f"{', resumed' if resume else ''}): exit 0 in {wall:.1f} s; ranks' final lines "
                  f"{done}; metrics.jsonl files {[str(p.relative_to(out)) for p in logs]}, epoch "
                  f"lines {len(epoch_lines)}, train losses "
                  f"{[round(e['epoch/train_total'], 5) for e in epoch_lines]}, val losses "
                  f"{[round(e.get('epoch/val_total', float('nan')), 5) for e in epoch_lines]}, "
                  f"epoch walls {[round(e['epoch/epoch_time_s'], 2) for e in epoch_lines]} s; "
                  f"checkpoints read back {read_back}", flush=True)
            if (sorted(int(r or 0) for r, _, _ in done) != list(range(dp))
                    or len({(v, e) for _, v, e in done}) != 1 or int(done[0][2]) != epochs
                    or len(logs) != 1 or len(epoch_lines) != ran or not all(read_back.values())
                    or not np.isfinite([e["epoch/train_total"] for e in epoch_lines]).all()):
                raise AssertionError(f"train CLI, {name}: ranks disagree, a rank other than 0 "
                                     "wrote, or a checkpoint does not read back")
    per_step = {k: runs[k]["epochs"][1]["epoch/epoch_time_s"] / steps * 1e3
                for k in (f"{cards} cards", "one card")}
    print(f"train CLI, the shipped config, epoch 2 wall per train batch of 16 (the CLI's "
          f"epoch_time_s / {steps}: loader, step and the validation batch): {cards} cards x "
          f"{16 // cards} rows {per_step[f'{cards} cards']:.1f} ms, one card x 16 rows "
          f"{per_step['one card']:.1f} ms; the phase {time.perf_counter() - t_phase:.1f} s; {smi}",
          flush=True)


def across_cards(dev: torch.device, smi: str, cards: int) -> int:
    """``--cards N``: phase 11 alone over NCCL on N cards, against phase 5's
    one-device enhancer of the 28M serving recipe (built here), then the
    train CLI on N cards (``train_cli_across_cards``)."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
        AudioEnhancer,
    )

    rng = np.random.default_rng(7)
    config = {"model": {"output_mode": "mask", "head": "fullres_mask",
                        "transformer": {"pos_embed": "factored_2d"}}}
    enhancer = AudioEnhancer(seeded_model(config, dev), config, device=dev, io_dtype="int16",
                             mask_padding=True)
    wavs = [speechlike(int(SECONDS * SR), rng) for _ in range(BATCH)]
    out = enhancer.enhance_batch(wavs)
    launches = mesh(dev, smi, rng, enhancer, wavs, out, cards)
    del enhancer
    torch.cuda.empty_cache()
    train_cli_across_cards(smi, cards, rng)
    scaling(smi, cards)
    print(f"chip_smoke.py --cards {cards}: {time.perf_counter() - STARTED:.1f} s from start to "
          f"result; {smi}", flush=True)
    print(smi)
    print(json.dumps({"mesh_across_cards": cards, **launches}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


GL_ITERS = 32
# Griffin-Lim through K3 and K1 against its plain version on the card, from
# one drawn phase. After 1 round: the composed K1 and K3 limits. K3's output
# is within TOL_ISTFT; K1 of it is within TOL_STFT plus the window's sum
# (256 at n_fft 512) times that; a bin's rescale to ``mag`` carries a
# spectral error on at mag / |X| (taken as 1: |X| near ``mag``); and the
# iSTFT's normalized overlap-add turns a per-bin error into at most
# OLA_GAIN times it a sample (sum w / sum w^2 over a sample's frames, 4/3
# for a Hann window at hop n_fft/4).
OLA_GAIN = 4.0 / 3.0
TOL_GL_ROUND1 = TOL_ISTFT + OLA_GAIN * (TOL_STFT + 256 * TOL_ISTFT)
# after 32 rounds, relative to the output's peak: the two round in another
# order, and a bin whose |X| is small turns that into a phase difference
# that later rounds carry on (measured 1.3e-3 on an H100 80GB HBM3 at 700 W: PERF.md)
TOL_GL_ROUNDS = 1e-2
TOL_FFT = 2e-3  # method="fft" (cuFFT) against the matmul STFT and iSTFT


def dsp(dev: torch.device, smi: str, rng: np.random.Generator, noisy: Path,
        built: tuple[Path, float]) -> dict:
    """Phase 12. ``noisy``: phase 8's PCM16 files; ``built``: the native
    runtime's library and its build time (phase 2). Returns each kernel's
    launches in one full-size Griffin-Lim call."""
    import importlib

    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch import native
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import (
        read_wav_raw,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_stft, kernels,
    )

    S = importlib.import_module(
        "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft")
    phase("DSP: the native WAV runtime, Griffin-Lim through K1 and K3, method=")
    t_phase = time.perf_counter()

    # a. the native runtime, built in phase 2 from the port's own source with
    # the host compiler: on this machine a failed build is a failure, not a
    # fallback
    lib, build_s = built
    if not native.available():
        raise AssertionError("the native audio runtime did not load")
    files = sorted(noisy.glob("*.wav"))
    if len(files) != 65:
        raise AssertionError(f"phase 8 left {len(files)} files, not 65")
    t0 = time.perf_counter()
    ref = [read_wav_raw(f)[0] for f in files]
    numpy_ms = (time.perf_counter() - t0) * 1e3 / len(files)
    t0 = time.perf_counter()
    got = [native.read_wav(f) for f in files]
    read_ms = (time.perf_counter() - t0) * 1e3 / len(files)
    if any(sr != SR or g.shape != r.shape for (g, sr), r in zip(got, ref)):
        raise AssertionError("native.read_wav: a file's rate or length differs from numpy's")
    read_err = max(float(np.abs(g - r).max()) for (g, _), r in zip(got, ref))
    max_len = max(len(r) for r in ref)
    t0 = time.perf_counter()
    batch, lengths, rates = native.decode_batch(files, max_len)
    batch_ms = (time.perf_counter() - t0) * 1e3 / len(files)
    if list(lengths) != [len(r) for r in ref] or set(rates.tolist()) != {SR}:
        raise AssertionError(f"native.decode_batch: lengths or rates wrong: {lengths}, {rates}")
    batch_err = max(float(np.abs(batch[i, : len(r)] - r).max()) for i, r in enumerate(ref))
    pad_ok = all(not batch[i, len(r):].any() for i, r in enumerate(ref))
    print(f"native runtime: {lib.name} built with the host compiler in {build_s:.2f} s "
          f"(phase 2); "
          f"{len(files)} PCM16 files ({sum(map(len, ref)) / SR:.1f} audio-s): read_wav max abs "
          f"err {read_err:.3g} vs numpy (tolerance 1e-7), decode_batch {batch_err:.3g} "
          f"(tolerance 2e-4), padding zero {pad_ok}; host ms a file: numpy codec "
          f"{numpy_ms:.3f}, native read_wav {read_ms:.3f}, native decode_batch {batch_ms:.3f} "
          f"({len(files)} files on a thread pool)", flush=True)
    if read_err > 1e-7 or batch_err > 2e-4 or not pad_ok:
        raise AssertionError("the native decoders disagree with the numpy codec")

    # b. Griffin-Lim at full size: the magnitude of one 32 x 3 s batch from K1
    cfg = S.STFTConfig()
    wav_len = int(SECONDS * SR) + 1024  # 49024: (384 - 1) * 128, the implied length
    x = torch.from_numpy(np.stack([speechlike(wav_len, rng) for _ in range(BATCH)])).to(dev)
    mag = cuda_stft.stft_mag(x, cfg)[2]
    phase0 = S.draw_griffin_lim_phase(mag.shape, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    y = S.griffin_lim(mag, cfg, n_iter=GL_ITERS, phase=phase0)
    gl_launches = kernels.launched()
    print(f"griffin_lim on cuda: mag {tuple(mag.shape)}, {GL_ITERS} rounds, launches "
          f"{gl_launches}", flush=True)
    if gl_launches != {"stft_mag": GL_ITERS, "istft_polar": GL_ITERS + 1}:
        raise AssertionError(f"griffin_lim: expected K1 {GL_ITERS} and K3 {GL_ITERS + 1} "
                             f"launches, got {gl_launches}")
    if tuple(y.shape) != (BATCH, wav_len) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"griffin_lim output malformed: {tuple(y.shape)}")
    y1 = S.griffin_lim(mag, cfg, n_iter=1, phase=phase0)
    p1 = S.griffin_lim_plain(mag, phase0, cfg, n_iter=1)
    plain = S.griffin_lim_plain(mag, phase0, cfg, n_iter=GL_ITERS)
    err1 = float((y1 - p1).abs().max())
    errn = float((y - plain).abs().max()) / float(plain.abs().max())

    def convergence(wave: torch.Tensor) -> float:
        m = cuda_stft.stft_mag(wave.contiguous(), cfg)[2]
        return float(torch.linalg.norm(m - mag) / torch.linalg.norm(mag))

    sc1, scn, scp = convergence(y1), convergence(y), convergence(plain)
    print(f"griffin_lim kernels vs plain on cuda from one phase: after 1 round max abs err "
          f"{err1:.3g} (tolerance {TOL_GL_ROUND1:.3g}, K1 and K3 composed); after "
          f"{GL_ITERS} rounds {errn:.3g} of the output's peak (tolerance {TOL_GL_ROUNDS:g}); "
          f"spectral convergence ||K1(y)| - mag| / |mag| {sc1:.4f} after 1 round, {scn:.4f} "
          f"after {GL_ITERS} (plain {scp:.4f})", flush=True)
    if err1 > TOL_GL_ROUND1 or errn > TOL_GL_ROUNDS or not scn < sc1:
        raise AssertionError("griffin_lim: the kernels disagree with the plain version, or "
                             "the spectral convergence did not fall")
    gl_ms = median_ms(lambda m: S.griffin_lim(m, cfg, n_iter=GL_ITERS, phase=phase0),
                      [(mag,)] * 3)
    gl_plain_ms = median_ms(lambda m: S.griffin_lim_plain(m, phase0, cfg, n_iter=GL_ITERS),
                            [(mag,)] * 3)
    times = device_times(lambda: S.griffin_lim(mag, cfg, n_iter=GL_ITERS, phase=phase0))
    busy = sum(times.values())
    k1_ms, k3_ms = kernel_ms(times, "stft_mag"), kernel_ms(times, "istft_polar")
    print(f"griffin_lim {BATCH} x {wav_len / SR:.3f} s, {GL_ITERS} rounds: {gl_ms:.3f} ms a "
          f"call, {gl_ms / GL_ITERS:.4f} ms a round, {BATCH * wav_len / SR / (gl_ms * 1e-3):.1f} "
          f"audio-s/s; plain version {gl_plain_ms:.3f} ms ({gl_plain_ms / gl_ms:.1f}x) "
          f"(CUDA events, median of 5 over 3 calls on the same magnitude); device busy "
          f"{busy:.3f} ms a call (profiler): K1 {k1_ms:.3f}, K3 {k3_ms:.3f}, the rest (atan2, "
          f"copies) {busy - k1_ms - k3_ms:.3f}; {smi}", flush=True)

    # c. method= on cuda: "auto" launches K1 or K3 and equals "matmul" within
    # their limits, "fft" (cuFFT) within TOL_FFT
    errs, fft_errs = {}, {}
    re_m, im_m = S.stft(x, cfg, method="matmul")
    mag_m, ph_m = S.magphase(re_m, im_m)
    y_m = S.istft(re_m, im_m, cfg, length=wav_len)
    r_m = S.reconstruct(mag_m, ph_m, cfg, length=wav_len)
    for name, run, want, kernel, tol in (
            ("stft", lambda m: S.stft(x, cfg, method=m), (re_m, im_m), "stft_mag", TOL_STFT),
            ("spectrogram", lambda m: S.spectrogram(x, cfg, method=m)[:1], (mag_m,),
             "stft_mag", TOL_STFT),
            ("istft", lambda m: (S.istft(re_m, im_m, cfg, length=wav_len, method=m),), (y_m,),
             "istft_polar", TOL_ISTFT),
            ("reconstruct", lambda m: (S.reconstruct(mag_m, ph_m, cfg, length=wav_len,
                                                     method=m),), (r_m,), "istft_polar",
             TOL_ISTFT)):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = run("auto")
        launched = kernels.launched()
        if launched != {kernel: 1}:
            raise AssertionError(f'{name}(method="auto") launched {launched}, not {kernel} once')
        errs[name] = max_err(got, want)
        fft_errs[name] = max_err(run("fft"), want)
        if errs[name] > tol or fft_errs[name] > TOL_FFT:
            raise AssertionError(f'{name}: method="auto" {errs[name]:.3g} (tolerance {tol}) or '
                                 f'"fft" {fft_errs[name]:.3g} (tolerance {TOL_FFT}) off matmul')
    try:
        S.stft(x.clone().requires_grad_(), cfg, method="auto")
    except RuntimeError as e:
        refusal = str(e)
    else:
        raise AssertionError('stft(method="auto") on a tensor that needs grad did not raise')
    print(f'method= on cuda, max abs err against "matmul": "auto" {errs} (each launched its '
          f'kernel once), "fft" {fft_errs} (tolerance {TOL_FFT}); a tensor that needs grad is '
          f'refused: {refusal!r}', flush=True)

    print(f"DSP phase: {time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return {"launches": gl_launches, "round_ms": gl_ms / GL_ITERS}


# ---------------------------------------------------------------------------
# Phase 13: the kernels as torch.library ops; export on the card
# ---------------------------------------------------------------------------

# the ops that the kernels' plain versions would put into a graph in their
# place (the serving model itself calls none of them: its attention is K2,
# its linear layers aten.linear, its head's resize aten.upsample_bilinear2d)
PLAIN_OPS = ("aten._softmax", "aten.softmax", "aten.matmul", "aten.bmm", "aten.cos",
             "aten.sin.", "aten.logsumexp", "aten.unfold")
# the loaded serving core in a fresh process against the eager core: cuDNN
# may pick another algorithm in another process, so a sample may round to
# the next PCM16 step
TOL_EXPORT_LSB = 1
# the loaded bf16 entry in this process against the eager module: the same
# cuDNN and cuBLAS calls in the same order (expected equal); 1e-5 allows a
# convolution algorithm picked otherwise (another order of up to 2304
# products a sum, over ~20 layers, on outputs of magnitude <= 1)
TOL_EXPORT_ENTRY = 1e-5
DISPATCH_ROUNDS = 15  # rounds of 100 calls a way (impl and op in turns)
# the fresh process: loads the program with only the port imported, runs it
# on the saved batch, counts the launches and times the call
EXPORTED_CHILD = r"""
import json, statistics, sys, time
import numpy as np, torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import kernels
from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
    load_program)
path, inputs, out_path = sys.argv[1:4]
run = load_program(path).module()
data = np.load(inputs)
x, lengths = (torch.from_numpy(data[k]).cuda() for k in ("noisy", "lengths"))
kernels.reset_launch_counts()
with torch.inference_mode():
    y = run(x, lengths)
torch.cuda.synchronize()
launches = kernels.launched()
walls = []
for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        run(x, lengths)
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3)
np.save(out_path, y.cpu().numpy())
print(json.dumps({"launches": launches, "wall_ms": statistics.median(walls),
                  "jax_loaded": any(m.split(".")[0] in ("jax", "flax") for m in sys.modules)}))
"""


def graph_ops(program) -> tuple[dict, list]:
    """``(kernels.op_calls(program), plain-version ops)`` of an exported graph."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import kernels

    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    return kernels.op_calls(program), sorted(t for t in targets if t.startswith(PLAIN_OPS))


def host_us(fn, args, calls: int = 100) -> float:
    """Host microseconds a call of ``fn(*args)`` over ``calls`` calls: the
    enqueue alone (the card runs these tiny launches faster than the host
    issues them)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def dispatcher_cost(dev: torch.device) -> dict:
    """13d: host us a call of each kernel on a tiny input two ways: the op
    (``torch.ops.sevit.*``, through the dispatcher: what the wrappers call)
    and its CUDA impl called directly (the same checks, allocations and
    launch: the path before the ops): medians over ``DISPATCH_ROUNDS``
    rounds, and the dispatcher's cost as the median of each round's op -
    impl."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_attention as A, cuda_stft as C,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import (
        STFTConfig,
    )

    cfg = STFTConfig()
    cfg_args = (cfg.n_fft, cfg.hop_length, cfg.win_length, cfg.window, cfg.center, cfg.pad_mode)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 4096, generator=g).to(dev)
    nf = cfg.num_frames(4096)
    mag = torch.rand(1, cfg.num_bins, nf, generator=g).to(dev)
    ph = (torch.rand(1, cfg.num_bins, nf, generator=g) * 6.28 - 3.14).to(dev)
    q, k, v, dout = (torch.randn(1, 1, 16, 64, generator=g).to(dev) for _ in range(4))
    scale = 64**-0.5
    out, lse = A._forward_kernel(q, k, v, None, scale, True)
    ways = {
        "stft_mag": ((C.stft_mag_op, (x, *cfg_args)), (C._stft_cuda, (x, *cfg_args))),
        "attention_fwd": ((A.attention_fwd_op, (q, k, v, None, scale, False)),
                          (A._forward_kernel, (q, k, v, None, scale, False))),
        "attention_bwd": ((A.attention_bwd_op, (q, k, v, out, lse, dout, None, scale)),
                          (A._backward_kernel, (q, k, v, out, lse, dout, None, scale))),
        "istft_polar": ((C.istft_polar_op, (mag, ph, *cfg_args, None)),
                        (C._istft_cuda, (mag, ph, *cfg_args, None))),
    }
    cost = {}
    for name, ((op, op_args), (impl, impl_args)) in ways.items():
        host_us(op, op_args)  # warm-up
        rounds = [(host_us(impl, impl_args), host_us(op, op_args))
                  for _ in range(DISPATCH_ROUNDS)]
        impl_us, op_us = (statistics.median(r[i] for r in rounds) for i in range(2))
        # the paired difference of each round: the host's drift cancels
        cost[name] = {"op_us": op_us, "impl_us": impl_us,
                      "dispatcher_us": statistics.median(o - i for i, o in rounds)}
    return cost


def exported(dev: torch.device, smi: str, enhancer, wavs: list, slice_ms: float,
             gl_round_ms: float) -> dict:
    """Phase 13. ``enhancer`` and ``wavs``: phase 5's 28M serving enhancer
    (PCM16 I/O, patch mask) and its 32 x 3 s batch; ``slice_ms``: phase 7's
    wall a batch; ``gl_round_ms``: phase 12b's wall a Griffin-Lim round.
    Returns each kernel's launches in one call of the loaded core."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch import graft_entry
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
        EnhancerCore,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import kernels
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
        export_program, load_program,
    )

    phase("export: the serving core and the bf16 entry on cuda, the ops' host cost, the demo")
    t_phase = time.perf_counter()
    serving = {"stft_mag": 1, "attention_fwd": 6, "istft_polar": 1}
    # phase 5's batch as enhance_batch_async pads it: PCM16 [32, 49024] and lengths
    wav_len = enhancer._padded_len(max(len(w) for w in wavs))
    batch = np.zeros((len(wavs), wav_len), np.int16)
    lengths = np.array([len(w) for w in wavs], np.int32)
    for row, w in enumerate(wavs):
        batch[row, :len(w)] = (np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16)
    x, lens = torch.from_numpy(batch).to(dev), torch.from_numpy(lengths).to(dev)
    core = EnhancerCore(enhancer)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # a. export on cuda: one op call a kernel launch, none of the plain versions
        t0 = time.perf_counter()
        path = export_program(tmp / "core.pt2", core, (x, lens))
        export_s = time.perf_counter() - t0
        calls, plain = graph_ops(load_program(path))
        print(f"export_program of the 28M serving core on cuda, PCM16 {tuple(batch.shape)}: "
              f"{export_s:.1f} s, {path.stat().st_size / 1e6:.1f} MB; sevit ops in the graph "
              f"{calls}; plain-version ops {plain}", flush=True)
        if calls != serving or plain:
            raise AssertionError(f"exported core: sevit ops {calls} (expected {serving}), "
                                 f"plain-version ops {plain}")
        torch.cuda.synchronize()
        with torch.inference_mode():
            eager = core(x, lens)
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            with torch.inference_mode():
                core(x, lens)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        eager = eager.cpu().numpy()

        # b. the program loaded in a fresh process that imports only the port
        np.savez(tmp / "batch.npz", noisy=batch, lengths=lengths)
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-c", EXPORTED_CHILD, str(path),
                                str(tmp / "batch.npz"), str(tmp / "out.npy")],
                               cwd=ROOT, capture_output=True, text=True, timeout=300)
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise AssertionError(f"the loaded program failed:\n{child.stdout[-3000:]}"
                                 f"{child.stderr[-3000:]}")
        got = json.loads(child.stdout.strip().splitlines()[-1])
        loaded = np.load(tmp / "out.npy")
        diff = np.abs(loaded.astype(np.int32) - eager.astype(np.int32))
        print(f"loaded in a fresh process ({child_s:.1f} s with its start; jax imported: "
              f"{got['jax_loaded']}): launches {got['launches']}; {loaded.dtype} "
              f"{loaded.shape} against the eager core: max {int(diff.max())} LSB, "
              f"{int((diff > 0).sum())} of {diff.size} samples differ (tolerance "
              f"{TOL_EXPORT_LSB} LSB); wall a batch {got['wall_ms']:.2f} ms loaded, "
              f"{statistics.median(walls):.2f} ms eager (the core alone, device tensors in and "
              f"out, median of 5); {smi}", flush=True)
        if (got["launches"] != serving or got["jax_loaded"] or loaded.shape != eager.shape
                or loaded.dtype != np.int16 or diff.max() > TOL_EXPORT_LSB):
            raise AssertionError("the loaded serving core did not run the kernels or "
                                 "disagrees with the eager core")

        # c. graft_entry.entry(): the flagship bf16 forward, exported on cuda
        module, example = graft_entry.entry(dev)
        t0 = time.perf_counter()
        program = load_program(export_program(tmp / "entry.pt2", module, example))
        entry_s = time.perf_counter() - t0
        calls, plain = graph_ops(program)
        xin = torch.rand(example[0].shape, generator=torch.Generator().manual_seed(5)).to(dev)
        kernels.reset_launch_counts()
        with torch.inference_mode():
            want, got_entry = module(xin), program.module()(xin)
        entry_launches = kernels.launched()
        entry_err = float((want - got_entry).abs().max())
        print(f"graft_entry.entry() (bf16 input rounding, {tuple(example[0].shape)}) exported "
              f"on cuda and read back in {entry_s:.1f} s: sevit ops {calls}, plain-version ops "
              f"{plain}; loaded against eager on a seeded input: max abs err {entry_err:.3g} "
              f"(tolerance {TOL_EXPORT_ENTRY:g}), launches (both) {entry_launches}", flush=True)
        if (calls != {"attention_fwd": 6} or plain or entry_err > TOL_EXPORT_ENTRY
                or entry_launches != {"attention_fwd": 12}):
            raise AssertionError("the exported entry is not the kernels' program")
        del module, program, want, got_entry

    # d. the dispatcher's host cost a call, beside the two walls it could move
    cost = dispatcher_cost(dev)
    per_batch = sum(cost[n]["dispatcher_us"] * c for n, c in serving.items()) / 1e3
    per_round = (cost["stft_mag"]["dispatcher_us"] + cost["istft_polar"]["dispatcher_us"]) / 1e3
    print(f"host us a call on a tiny input, op (dispatcher) / CUDA impl called directly: "
          + "; ".join(f"{n} {c['op_us']:.1f} / {c['impl_us']:.1f} "
                      f"(dispatcher {c['dispatcher_us']:.1f})" for n, c in cost.items())
          + f". The dispatcher's cost: {per_batch:.4f} ms over a serving batch's 8 launches "
          f"(phase 7's wall {slice_ms:.1f} ms), {per_round:.4f} ms over a Griffin-Lim round's "
          f"K3 and K1 (phase 12b's {gl_round_ms:.4f} ms a round); {smi}", flush=True)

    # e. the synthetic dataset, then the demo on cuda for an epoch on it
    with tempfile.TemporaryDirectory() as tmp:
        synth = subprocess.run(
            [sys.executable, "-m",
             "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.synth_dataset",
             str(Path(tmp) / "data"), "--train", "8", "--test", "2", "--max-seconds", "2.0"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        demo = subprocess.run(
            [sys.executable, "-m",
             "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli.demo",
             "--device", "cuda", "--epochs", "1", "--data-root", str(Path(tmp) / "data"),
             "--outdir", str(Path(tmp) / "demo")],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        snr = [s for s in demo.stdout.splitlines() if s.startswith("[demo] SNR improvement")]
        wrote = sorted(p.name for p in (Path(tmp) / "demo").glob("*.wav"))
        print(f"cli.synth_dataset: exit {synth.returncode}, "
              f"{len(list((Path(tmp) / 'data').rglob('*.wav')))} WAV files; cli.demo --device "
              f"cuda, 1 epoch on them: exit {demo.returncode}, {snr}, wrote {wrote}", flush=True)
        if synth.returncode != 0 or demo.returncode != 0 or len(snr) != 1 or len(wrote) != 3:
            raise AssertionError(f"synth_dataset or the demo failed:\n{synth.stderr[-2000:]}"
                                 f"{demo.stdout[-2000:]}{demo.stderr[-2000:]}")
    print(f"export phase: {time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return {"launches": got["launches"], "dispatcher": cost}


# Phase 14, the quality tools on cuda against the same tools on cpu. A
# waveform within TOL_WAVE (2e-4) of cpu's moves an SI-SDR of 5-25 dB by at
# most ~4e-2 dB, were the whole difference to line up with the residual: each
# blend's gain within 5e-2 dB. The model's SNR estimate is a ratio of two
# fp32 sums over 257 x N bins of magnitudes within K1's limit: 1e-2 dB. The
# oracle's estimates take no model, only K1 and K3 (limits 2e-3 and 2e-5 on
# spectra and waveforms of unit scale): each head's mean gain within 1e-2 dB.
TOL_TOOLS_EST_SNR = 1e-2
TOL_TOOLS_GAIN = 5e-2
TOL_TOOLS_ORACLE = 1e-2
TOOLS_FILES, TOOLS_BLEND_FILES = 16, 8
# the committed tests/fixtures/tiny_denoiser's architecture as a config.model
# (its meta.json holds it under config.tiny, which create_hybrid_vit does not read)
TINY_MODEL = {"encoder": {"channels": [16, 32, 64], "dropout": 0.0},
              "transformer": {"embed_dim": 128, "num_heads": 4, "num_layers": 2,
                              "mlp_ratio": 2.0, "pos_embed": "factored_2d",
                              "attention_dropout": 0.0, "drop_path_rate": 0.0},
              "decoder": {"channels": [32, 16, 1]}}


def quality_tools(smi: str) -> dict:
    """Phase 14. Returns each kernel's launches a file in c's run."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.cli import (
        synth_dataset,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
        AudioEnhancer, load_model_for_inference,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
        create_hybrid_vit, init_weights,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import kernels
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools import (
        bench_mask_delta, calibrate_pesq, oracle_heads, tune_blend,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
        read_meta, save_checkpoint,
    )

    phase("quality tools: tune_blend, oracle_heads, bench_mask_delta and calibrate_pesq")
    t_phase = time.perf_counter()

    def run(main, argv: list, device: str | None) -> tuple[dict, float]:
        """One tool's ``main(argv)`` on ``device``: its kernel launches and
        wall seconds; on cpu it must launch nothing."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if main(argv + ["--device", device] if device else argv) != 0:
            raise AssertionError(f"{main.__module__} {argv} failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = kernels.launched()
        if device == "cpu" and launched:
            raise AssertionError(f"{main.__module__} on cpu launched {launched}")
        return launched, wall

    def per_file(launched: dict, n: int, expect: dict, what: str) -> None:
        want = {name: n * c for name, c in expect.items()}
        print(f"{what}: launches {launched} over {n} (expected {expect} a file or clip)",
              flush=True)
        if launched != want:
            raise AssertionError(f"{what}: launches {launched}, expected {want}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # a. data: 12 + 4 held-out-family test pairs of 1-3 s
        data = tmp / "data"
        if synth_dataset.main([str(data), "--train", "0", "--test", str(TOOLS_FILES - 4),
                               "--test-unseen", "4"]) != 0:
            raise AssertionError("synth_dataset failed")
        noisy, clean = data / "noisy_testset_wav", data / "clean_testset_wav"
        if len(list(noisy.glob("*.wav"))) != TOOLS_FILES:
            raise AssertionError("synth_dataset wrote the wrong number of pairs")
        dirs = ["--noisy-dir", str(noisy), "--clean-dir", str(clean)]

        # b. tune_blend on the trained tiny denoiser, cuda against cpu on the
        # same files, then the fit written on cuda and adopted by an enhancer
        runs = {}
        for device in ("cuda", "cpu"):
            ck = tmp / f"tiny_{device}"
            shutil.copytree(ROOT / "tests" / "fixtures" / "tiny_denoiser", ck)
            meta = json.loads((ck / "meta.json").read_text())
            meta["config"]["model"] = TINY_MODEL
            (ck / "meta.json").write_text(json.dumps(meta, indent=1))
            out = tmp / f"blend_{device}.json"
            argv = ["--checkpoint", str(ck), "--config-dir", str(ROOT / "config"), *dirs,
                    "--max-files", str(TOOLS_BLEND_FILES), "--json-out", str(out)]
            if device == "cuda":
                argv.append("--write-checkpoint-meta")
            launched, wall = run(tune_blend.main, argv, device)
            runs[device] = (json.loads(out.read_text()), ck, launched, wall)
        got, ck, launched, wall = runs["cuda"]
        ref = runs["cpu"][0]
        per_file(launched, TOOLS_BLEND_FILES, {"stft_mag": 1, "attention_fwd": 2, "istft_polar": 1},
                 "tune_blend, tiny denoiser")
        errs = {"est_snr": 0.0, "gain": 0.0}
        for row, ref_row in zip(got["rows"], ref["rows"], strict=True):
            if row["file"] != ref_row["file"] or row["input_si_sdr"] != ref_row["input_si_sdr"]:
                raise AssertionError(f"tune_blend rows differ in file or input: {row}, {ref_row}")
            errs["est_snr"] = max(errs["est_snr"], abs(row["est_snr"] - ref_row["est_snr"]))
            errs["gain"] = max(errs["gain"], float(np.abs(
                np.subtract(row["gains"], ref_row["gains"])).max()))
        params = [r["best"] and r["best"]["params"] for r in (got, ref)]
        # the fit is strict (a larger mean wins): the runner-up's distance says
        # how far the gains could move before another point wins
        feasible = sorted((m for m, _, _, ok in tune_blend.grid(ref["rows"]) if ok), reverse=True)
        print(f"tune_blend, tiny denoiser, {TOOLS_BLEND_FILES} files, cuda vs cpu: est_snr max "
              f"err {errs['est_snr']:.3g} dB (tolerance {TOL_TOOLS_EST_SNR}), gains max err "
              f"{errs['gain']:.3g} dB (tolerance {TOL_TOOLS_GAIN}); fit cuda {params[0]} mean "
              f"{got['best'] and got['best']['mean']}, cpu {params[1]} (its runner-up "
              f"{feasible[0] - feasible[1] if len(feasible) > 1 else None} dB below); no blend "
              f"{got['no_blend']['mean']:.4f} dB; cuda {wall:.2f} s, cpu {runs['cpu'][3]:.2f} s; "
              f"{smi}", flush=True)
        if errs["est_snr"] > TOL_TOOLS_EST_SNR or errs["gain"] > TOL_TOOLS_GAIN:
            raise AssertionError(f"tune_blend differs between cuda and cpu: {errs}")
        if params[0] != params[1] or params[0] is None:
            raise AssertionError(f"tune_blend fits differ or found none: {params}")
        model = load_model_for_inference(ck, {}, device="cuda")[0]
        enhancer = AudioEnhancer(model, read_meta(ck)["config"], device="cuda", blend=None)
        adopted = (enhancer.blend, enhancer.blend_min, enhancer.blend_pivot_db,
                   enhancer.blend_width_db)
        print(f"written fit adopted by AudioEnhancer(blend=None) on cuda: {adopted}", flush=True)
        if adopted != ("snr_adaptive", params[0]["min"], params[0]["pivot"], params[0]["width"]):
            raise AssertionError(f"the written fit was not adopted: {adopted}, {params[0]}")

        # c. tune_blend at full width: a 28M magnitude-head checkpoint from
        # seeded weights, every file on cuda
        config = {"model": {"output_mode": "magnitude"}}
        big = save_checkpoint(tmp / "big", init_weights(create_hybrid_vit(config),
                                                        torch.Generator().manual_seed(3)),
                              config=config)
        out = tmp / "blend_28m.json"
        launched, wall = run(tune_blend.main, ["--checkpoint", str(big), "--config-dir",
                                               str(ROOT / "config"), *dirs, "--json-out",
                                               str(out)], "cuda")
        big_rows = json.loads(out.read_text())["rows"]
        seconds = sum(json.loads((data / "manifest.json").read_text())[r["file"]]["seconds"]
                      for r in big_rows)
        print(f"tune_blend at 28M (magnitude head, seeded weights): {len(big_rows)} files "
              f"({seconds:.1f} audio-s) in {wall:.2f} s = {len(big_rows) / wall:.2f} files/s; "
              f"{smi}", flush=True)
        if len(big_rows) != TOOLS_FILES or not all(
                np.isfinite(r["est_snr"]) and np.isfinite(r["gains"]).all() for r in big_rows):
            raise AssertionError("tune_blend at 28M: rows missing or not finite")
        tools_launches = {name: n // TOOLS_FILES for name, n in launched.items()}
        per_file(launched, TOOLS_FILES, {"stft_mag": 1, "attention_fwd": 6, "istft_polar": 1},
                 "tune_blend at 28M")

        # d. oracle_heads, cuda against cpu
        oracle = {}
        for device in ("cuda", "cpu"):
            out = tmp / f"oracle_{device}.json"
            launched, wall = run(oracle_heads.main, [*dirs, "--out", str(out)], device)
            oracle[device] = (json.loads(out.read_text()), launched, wall)
        per_file(oracle["cuda"][1], TOOLS_FILES, {"stft_mag": 1, "istft_polar": 1},
                 "oracle_heads")
        got, ref = oracle["cuda"][0], oracle["cpu"][0]
        means = {h: (got[f"{h}_gain_mean"], abs(got[f"{h}_gain_mean"] - ref[f"{h}_gain_mean"]))
                 for h in oracle_heads.HEADS}
        print(f"oracle_heads over {got['n']} files, gain mean (dB) and its cuda vs cpu err: "
              f"{ {h: (round(m, 4), float(f'{e:.3g}')) for h, (m, e) in means.items()} } "
              f"(tolerance {TOL_TOOLS_ORACLE}); cuda {oracle['cuda'][2]:.2f} s, cpu "
              f"{oracle['cpu'][2]:.2f} s; {smi}", flush=True)
        if got["n"] != TOOLS_FILES or any(not np.isfinite(m) or e > TOL_TOOLS_ORACLE
                                          for m, e in means.values()):
            raise AssertionError(f"oracle_heads differs between cuda and cpu: {means}")

        # e. the bucketing's error budget at full width; the tool prints its report
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            launched, wall = run(bench_mask_delta.main, ["--full-size", "--pos-embed",
                                                         "factored_2d"], "cuda")
        report = json.loads(printed.getvalue())
        n_clips = len(bench_mask_delta.LENGTH_FRAMES)
        rel_rms = [(c["samples"], round(c["unmasked_rel_rms"], 4), round(c["masked_rel_rms"], 4))
                   for c in report["clips"]]
        print(f"bench_mask_delta --full-size --pos-embed factored_2d on cuda: worst max LSB "
              f"{report['worst_max_lsb']} over {n_clips} clips, relative RMS (samples, unmasked, "
              f"masked) {rel_rms}, in {wall:.2f} s; {smi}", flush=True)
        per_file(launched, n_clips, {"stft_mag": 3, "attention_fwd": 18, "istft_polar": 3},
                 "bench_mask_delta")
        if len(report["clips"]) != n_clips or not all(
                np.isfinite(v) for c in report["clips"] for v in c.values()):
            raise AssertionError(f"bench_mask_delta report malformed: {report}")

        # f. the PESQ calibration on this machine, which has no jax
        out = tmp / "pesq_calibration.json"
        _, wall = run(calibrate_pesq.main, ["--clips", "1", "--seconds", "2", "--out", str(out)],
                      None)
        cal = json.loads(out.read_text())
        print(f"calibrate_pesq --clips 1 --seconds 2: {wall:.2f} s; _D_CAL {cal['d_cal']}, "
              f"anchored MAE {cal['mae']:.4f}, max |residual| {cal['max_abs_residual']:.4f}, "
              f"per family {cal['per_family_residuals']}, monotonic {cal['monotonicity']}; {smi}",
              flush=True)
        if not np.isfinite(cal["mae"]):
            raise AssertionError("calibrate_pesq: residuals not finite")
    print(f"quality tools phase: {time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return {"launches": tools_launches}


# Phase 15, the measurement tools. The inference core's launches a step and
# the train step's (the recipe, attention dropout 0), exactly; PyTorch's FLOP
# count of the core step within 2% of the analytic one (the bound
# tests/test_flops.py holds XLA's count to; the resize head's bilinear
# resizes, which the counter counts as 0, are 0.9% of it); a share of the
# peak above 0 and at most 100%; bench_stages' full prefix within 25% of
# tools.bench's device step (the same core, timed apart; the stage
# differences add up to the full prefix by construction); tools.bench's
# device core on cuda against the same core on the cpu at TOL_WAVE.
INFER_LAUNCHES = {"stft_mag": 1, "attention_fwd": 6, "istft_polar": 1}
TRAIN_LAUNCHES = {"stft_mag": 2, "attention_fwd": 6, "attention_bwd": 6, **OPT_STEP}
TOL_FLOP_COUNT = 0.02
TOL_STAGES_VS_BENCH = 0.25
BENCH_CPU_ROWS = 4  # rows of the device batch run again on the cpu (rows are independent)


def scaling(smi: str, cards: int) -> list:
    """``tools.bench_scaling`` over NCCL, one rank a card, at 1, 2, 4, ...
    ranks up to ``cards``: each rank's loss finite, K1 twice a step."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools import (
        bench_scaling,
    )

    runs = bench_scaling.run("cuda", max_ranks=cards)
    base = None
    for ranks in runs:
        ms = max(r["ms"] for r in ranks)
        base = base or ms
        print(f"bench_scaling: {len(ranks)} ranks (NCCL, per-rank batch 4, 128 frames): "
              f"{ms:.2f} ms a step, weak-scaling efficiency {100 * base / ms:.1f}%, launches a "
              f"step {ranks[0]['launches']}; {smi}", flush=True)
        if not all(np.isfinite(r["last_loss"]) and r["launches"]["stft_mag"] == 2
                   for r in ranks):
            raise AssertionError(f"bench_scaling at {len(ranks)} ranks: {ranks}")
    return runs


def measurement_tools(smi: str, noisy: Path) -> dict:
    """Phase 15. Returns each kernel's launches a step of tools.bench's
    device core and of bench_train's step."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.tools import (
        bench, bench_infer, bench_io, bench_stages, bench_train, flops, roofline,
    )

    phase("measurement tools: bench, flops, bench_infer, bench_stages, roofline, bench_train, "
          "bench_io, bench_scaling")
    t_phase = time.perf_counter()

    def captured(main, argv: list) -> str:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if main(argv) != 0:
                raise AssertionError(f"{main.__module__} {argv} failed:\n{out.getvalue()}")
        return out.getvalue()

    def share(what: str, pct) -> None:
        if pct is None or not 0 < pct <= 100:
            raise AssertionError(f"{what}: share of the peak {pct} is not in (0, 100]")

    def launches_are(what: str, got: dict, want: dict) -> None:
        """``got``: a tool's launches a step of every kernel, 0 included."""
        if {k: v for k, v in got.items() if v} != {k: float(v) for k, v in want.items()}:
            raise AssertionError(f"{what}: launches a step {got}, expected {want}")

    # a. tools.bench at its defaults: one JSON line
    t0 = time.perf_counter()
    lines = captured(bench.main, []).splitlines()
    if len(lines) != 1:
        raise AssertionError(f"tools.bench printed {len(lines)} lines")
    line = json.loads(lines[0])
    print(f"tools.bench ({time.perf_counter() - t0:.1f} s): {lines[0]}", flush=True)
    share("tools.bench mfu_pct", line["mfu_pct"])
    launches_are("tools.bench's device core", line["launches_per_step"], INFER_LAUNCHES)
    if not line["value"] or not line["device_audio_s_per_s"] or line["name"] is None:
        raise AssertionError(f"tools.bench: missing rates or card: {line}")
    # its device core on cuda against the same core on the cpu
    cfg = STFTConfig()
    wav_len = int(SECONDS * SR) // cfg.hop_length * cfg.hop_length
    noisy_batch = bench_stages.synthesize(torch.Generator(device="cuda").manual_seed(5), BATCH,
                                          wav_len)
    got = bench_stages.run_prefix("full", bench_stages.build_model(device="cuda"), noisy_batch,
                                  cfg)[:BENCH_CPU_ROWS].cpu()
    ref = bench_stages.run_prefix("full", bench_stages.build_model(device="cpu"),
                                  noisy_batch[:BENCH_CPU_ROWS].cpu(), cfg)
    core_err = max_err([got], [ref])
    print(f"tools.bench's device core, rows 0-{BENCH_CPU_ROWS - 1} of a {BATCH} x {SECONDS:g} s "
          f"batch, cuda vs cpu: max abs err {core_err:.3g} (tolerance {TOL_WAVE}; output peak "
          f"{float(ref.abs().max()):.3g})", flush=True)
    if not torch.isfinite(got).all() or core_err > TOL_WAVE:
        raise AssertionError("tools.bench's core differs between cuda and cpu")

    # b. flops: the 28M forward counted on the card, with the sevit formulas
    print(captured(flops.main, ["--batch", "4", "--frames", "256"]), end="", flush=True)

    # c. bench_infer at 32 x 3 s: ms, FLOPs, share, launches
    model = bench_stages.build_model(fp32=True, device="cuda")
    infer = bench_infer.measure(model, "cuda", BATCH, wav_len, 30, cfg)
    del model
    print("bench_infer --batch 32 --seconds 3 --fp32:", flush=True)
    bench_infer.report(infer, flops.describe_device("cuda"))
    count_err = abs(infer["torch_flops"] / infer["analytic_flops"] - 1)
    print(f"bench_infer: torch's count against the analytic one: {count_err:.4%} (tolerance "
          f"{TOL_FLOP_COUNT:.0%})", flush=True)
    share("bench_infer", infer["mfu_pct"])
    launches_are("bench_infer", infer["launches_per_step"], INFER_LAUNCHES)
    if count_err > TOL_FLOP_COUNT:
        raise AssertionError("the FLOP count on the card disagrees with the analytic one")

    with tempfile.TemporaryDirectory() as tmp:
        # d. bench_stages at 32 x 3 s, then the roofline on its JSON
        stages_json = Path(tmp) / "stages.json"
        print(captured(bench_stages.main, ["--fp32", "--iters", "10", "--json-out",
                                           str(stages_json)]), end="", flush=True)
        stages = json.loads(stages_json.read_text())
        full, stage_sum = stages["full_step_ms"], sum(stages["stage_ms"].values())
        print(f"bench_stages: full prefix {full:.3f} ms, stage sum {stage_sum:.3f} ms, "
              f"tools.bench's device step {line['device_step_ms']:.3f} ms "
              f"(tolerance {TOL_STAGES_VS_BENCH:.0%})", flush=True)
        if abs(full / line["device_step_ms"] - 1) > TOL_STAGES_VS_BENCH:
            raise AssertionError("bench_stages' full prefix and tools.bench's device step differ")
        roof = json.loads(captured(roofline.main, ["--stages-json", str(stages_json)]))
        for r in roof["stages"]:
            print(f"roofline {r['stage']}: {r['GF']} GF, {r['MB_moved']} MB, bound "
                  f"{r['t_roofline_ms']} ms by {r['bound']}, measured {r.get('measured_ms')} ms "
                  f"({r.get('share_of_bound_pct')}% of it)", flush=True)
        print(f"roofline: step bound {roof['roofline_step_ms']} ms, ceiling "
              f"{roof['roofline_mfu_pct']}% at {roof['peak_tflops']} TFLOP/s {roof['math']} and "
              f"{roof['hbm_TBps']} TB/s ({roof['peaks_from']}); {smi}", flush=True)

    # e. bench_train at the 28M recipe: batch 16, 384 frames, attention dropout 0
    args = bench_train.parser().parse_args([
        "--head", "fullres_mask", "--output-mode", "mask", "--attention", "pallas", "--fp32",
        "--batch", str(TRAIN_BATCH), "--frames", "384", "--iters", "10"])
    train = bench_train.measure(args)
    print(f"bench_train (fullres_mask, mask, attention pallas, batch {TRAIN_BATCH}, 384 frames, "
          f"fp32): {train['step_ms']:.2f} ms a step, {train['audio_s_per_s']:.1f} audio-s/s, "
          f"analytic {train['analytic']['train_total'] / 1e9:.1f} GF, torch "
          f"{train['torch_flops'] / 1e9:.1f} GF; MFU "
          f"{flops.mfu_report(train['analytic']['train_total'], train['step_ms'] * 1e-3)}; "
          f"launches a step {train['launches_per_step']}; {smi}", flush=True)
    share("bench_train", train["mfu_pct"])
    launches_are("bench_train", train["launches_per_step"], TRAIN_LAUNCHES)

    # f. bench_io on phase 8's PCM16 files, g. bench_scaling on the visible cards
    print(captured(bench_io.main, ["--dir", str(noisy)]), end="", flush=True)
    scaling(smi, torch.cuda.device_count())
    print(f"measurement tools phase: {time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return {"launches": line["launches_per_step"], "train": train["launches_per_step"],
            "mfu_pct": line["mfu_pct"], "train_mfu_pct": train["mfu_pct"]}


# phase 16: head dims that are no K2 instance, 192 and 256 on its sliced
# instance (its STFT geometries are cuda_stft.GEOMETRIES)
PADDED_HEAD_DIMS = (24, 48, 80, 96, 112, 192, 256)
AUDIO_400 = {"n_fft": 400, "hop_length": 100, "win_length": 400}  # CMGAN's 16 kHz front end
AUDIO_DCCRN = {"n_fft": 512, "hop_length": 100, "win_length": 400}
# the CUDA functions of K1g and K3g, as kernel_ms names them
DFT_FUNCS = {"stft_dft": ("stft_dft",), "istft_dft": ("istft_dft_frames", "istft_dft_ola")}
# K1g's and K3g's timed geometries: the largest the JAX package tests (both),
# and two whose hop does not divide n_fft (K3g)
DFT_TIMED = {"stft_dft": ((4096, 1024, 4096),),
             "istft_dft": ((4096, 1024, 4096), (400, 160, 400), (512, 100, 400))}
GL_ITERS_4096 = 4  # Griffin-Lim rounds at 4096/1024: K1g and K3g through an entry point
# phase 16's times, in a fresh process: late in this script the profiler loses
# the first work of profiled regions, never in a short process
TIMES_CHILD = r"""
import json, sys
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
print(json.dumps(chip_smoke.geometry_times(json.loads(sys.argv[1]), sys.argv[2])))
"""


def dft_ms(times: dict[str, float], name: str, calls: int) -> float | None:
    """Device ms a call of K1g's or K3g's CUDA functions (``DFT_FUNCS``) in
    a ``device_times`` result of ``calls`` calls; None ("not measured")
    where the trace lacks a record of one."""
    parts = [kernel_ms(times, fn) for fn in DFT_FUNCS[name]]
    return sum(parts) / calls if all(parts) else None


def ms_or_not(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def time_stft_kernel(dev, g, name: str, cfg, smi: str, wav_len: int = 51100) -> dict:
    """Phase 16's times of the STFT kernel ``name`` (K1, K1g, K3 or K3g) at
    ``cfg`` on the serving batch's 32 rows of ``wav_len`` samples (or their
    spectra), beside its plain version, ``torch.stft`` + ``abs`` or
    ``torch.istft`` of ``torch.polar``, and its bound: the function's, an
    FFT's operations or the bytes (``stft_work``), whichever kernel computes
    it. Each timed output is held against the plain version's."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import cuda_stft

    inverse = name.startswith("istft")
    if cuda_stft.route(cfg, inverse=inverse)[0] != name:
        raise AssertionError(f"{name} is not the route of {cfg}")
    n_frames, f_bins, n_fresh = cfg.num_frames(wav_len), cfg.num_bins, 8
    win = torch.from_numpy(cfg.padded_window()).to(dev)
    if inverse:
        inputs = [(torch.rand(BATCH, f_bins, n_frames, generator=g).to(dev),
                   (torch.rand(BATCH, f_bins, n_frames, generator=g) * 6.28 - 3.14).to(dev))
                  for _ in range(n_fresh)]
        kern = lambda m, p: cuda_stft.istft_polar(m, p, cfg, length=wav_len)  # noqa: E731
        plain = lambda m, p: cuda_stft.istft_polar_plain(m, p, cfg, length=wav_len)  # noqa: E731
        lib_call = lambda m, p: torch.istft(  # noqa: E731
            torch.polar(m, p), cfg.n_fft, cfg.hop_length, win_length=cfg.n_fft, window=win,
            center=True, length=wav_len)
    else:
        inputs = [(torch.randn(BATCH, wav_len, generator=g).to(dev),) for _ in range(n_fresh)]
        kern = lambda x: cuda_stft.stft_mag(x, cfg)  # noqa: E731
        plain = lambda x: cuda_stft.stft_mag_plain(x, cfg)  # noqa: E731
        lib_call = lambda x: torch.stft(  # noqa: E731
            x, cfg.n_fft, cfg.hop_length, win_length=cfg.n_fft, window=win, center=True,
            pad_mode="reflect", return_complex=True).abs()
    tol = TOL_ISTFT if inverse else TOL_STFT
    timed_err = max(max_err(kern(*args), plain(*args)) for args in inputs)
    if timed_err > tol:
        raise AssertionError(f"{name} at {cfg} on the timed inputs disagrees with its plain "
                             f"version: {timed_err} > {tol}")
    p1, k1, l1, l2, k2, p2 = (median_ms(f, inputs)
                              for f in (plain, kern, lib_call, lib_call, kern, plain))
    flops, nbytes = stft_work(cfg, BATCH, wav_len)["istft" if inverse else "stft"]
    b_ms, b_by = bound(flops, nbytes, FP32_PEAK)
    for args in inputs:  # warm-up
        kern(*args)
    times = device_times(lambda: [kern(*args) for args in inputs],
                         need=DFT_FUNCS.get(name, (name,)))
    dev_ms = (dft_ms(times, name, len(inputs)) if name in DFT_FUNCS
              else (kernel_ms(times, name) / len(inputs) or None))
    m = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": min(l1, l2),
         "bound_ms": b_ms, "bound_by": b_by, "device_ms": dev_ms, "max_abs_err": timed_err}
    lib_dev = device_ms(lib_call, inputs)
    share = "not measured" if dev_ms is None else f"{b_ms / dev_ms:.1%}"
    print(f"{name} at {cfg.n_fft}/{cfg.hop_length}/{cfg.win_length}, "
          f"{'mag/phase' if inverse else 'x'} of {BATCH} rows of {wav_len} samples: per call "
          f"{m['ms']:.4f} ms (device {ms_or_not(dev_ms)}), plain {m['plain_ms']:.4f} ms (device "
          f"{device_ms(plain, inputs):.4f}), library {m['library_ms']:.4f} ms (device "
          f"{lib_dev:.4f}); bound {b_ms:.4f} ms by {b_by} ({flops / 1e9:.3f} GFLOP of an FFT at "
          f"{FP32_PEAK / 1e12:g} TFLOP/s, {nbytes / 1e6:.2f} MB at {HBM_RATE / 1e12:g} TB/s); "
          f"share of bound {b_ms / m['ms']:.1%} per call, {share} on the device; outputs "
          f"against the plain version's max abs err {timed_err:.3g} (tolerance {tol}) (per "
          f"call: median of 5 runs over {n_fresh} fresh inputs; device: mean over them; {smi})",
          flush=True)
    m["library_device_ms"] = lib_dev
    return m


def geometry(dev: torch.device, smi: str, rng: np.random.Generator, g: torch.Generator) -> dict:
    """Phase 16. Returns the STFT kernels' errors (``errs``) and K1g's and
    K3g's times at the geometries they still serve (``ms``), K1's and K3's
    at 400/100 (``fft_ms``), K2's errors at the padded head dims
    (``attention``), and the launches of a 400/100 serving batch
    (``serve``), a DCCRN batch (``dccrn``), a 400/100 train step (``train``)
    and a Griffin-Lim call at 4096/1024 (``gl``)."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
        AudioEnhancer,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
        create_hybrid_vit, init_weights,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models.components import (
        patch_validity_mask,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_attention, cuda_stft, kernels,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import (
        STFTConfig, frame_signal, griffin_lim, implied_length, window_dft,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.cuda_stft import (
        GEOMETRIES,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.losses import (
        LossConfig,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.optimizer import (
        Optimizer, parameters,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.training.trainer import (
        batch_to_device,
    )

    phase("geometry: every STFT geometry (K1 and K3 on the mixed radices, K1g and K3g for the "
          "rest) and head dim (K2 padded, sliced above 128)")
    t_phase = time.perf_counter()

    def ran(what: str, want: dict) -> dict:
        """The launches since the last reset; raise unless exactly ``want``."""
        got = kernels.launched()
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")
        return got

    def seeded(config: dict):
        return init_weights(create_hybrid_vit(config), torch.Generator().manual_seed(0))

    # 1. each geometry's kernels against their plain versions, on the serving
    # batch's 32 rows of 51100 samples (bucket 512 at hop 100), on the
    # shortest row one reflection pads, and on rows of n_fft/2 and of 100
    # samples, which the wrapper pads first as jnp.pad does
    errs = {name: [] for name in ("stft_mag", "stft_dft", "istft_polar", "istft_dft")}
    for n_fft, hop, win, pad_mode in GEOMETRIES:
        cfg = STFTConfig(n_fft=n_fft, hop_length=hop, win_length=win, pad_mode=pad_mode)
        fwd, inv = (cuda_stft.route(cfg, inverse=i)[0] for i in (False, True))
        got_errs = []
        for shape in ((BATCH, 51100), (2, n_fft // 2 + 1), (2, n_fft // 2), (2, 100)):
            x = torch.randn(shape, generator=g).to(dev)
            kernels.reset_launch_counts()
            out = cuda_stft.stft_mag(x, cfg)
            ran(f"stft_mag at {n_fft}/{hop}/{win} {pad_mode}, {shape[1]} samples", {fwd: 1})
            plain = cuda_stft.stft_mag_plain(x, cfg)
            if any(o.shape != p.shape for o, p in zip(out, plain)):
                raise AssertionError(f"stft_mag at {n_fft}/{hop}: shapes {out[0].shape}, plain "
                                     f"{plain[0].shape}")
            got_errs.append(max_err(out, plain))
            if n_fft == 4096 and shape[0] == BATCH:  # the longest sums, against float64
                spec = frame_signal(x[:1].double().cpu(), cfg) @ torch.from_numpy(
                    window_dft(cfg).astype(np.float64))
                re64 = spec[0, :, :cfg.num_bins].T
                print(f"4096/1024 re of row 0 against a float64 product: {fwd} "
                      f"{float((out[0][0].cpu().double() - re64).abs().max()):.3g}, the plain "
                      f"version {float((plain[0][0].cpu().double() - re64).abs().max()):.3g}",
                      flush=True)
        errs[fwd] += got_errs
        n = cfg.num_frames(51100)
        mag = torch.rand(BATCH, cfg.num_bins, n, generator=g).to(dev)
        ph = (torch.rand(BATCH, cfg.num_bins, n, generator=g) * 2 * np.pi - np.pi).to(dev)
        length = implied_length(cfg, n)
        kernels.reset_launch_counts()
        y = cuda_stft.istft_polar(mag, ph, cfg, length=length)
        ran(f"istft_polar at {n_fft}/{hop}/{win} {pad_mode}", {inv: 1})
        errs[inv].append(max_err([y], [cuda_stft.istft_polar_plain(mag, ph, cfg, length=length)]))
        print(f"{n_fft}/{hop}/{win} {pad_mode}: {fwd} max abs err {got_errs} at 51100, "
              f"{n_fft // 2 + 1}, {n_fft // 2} and 100 samples (tolerance {TOL_STFT}); {inv} "
              f"{errs[inv][-1]:.3g} (tolerance {TOL_ISTFT})", flush=True)
    for name, e in errs.items():
        if e and max(e) > (TOL_ISTFT if name.startswith("istft") else TOL_STFT):
            raise AssertionError(f"{name} disagrees with its plain version: {e}")

    # 2. K2 at head dims between its instances and above 128 (the sliced
    # instance), under the train batch's mask
    heads, n_tok = 8, 16 * 24
    lengths = np.linspace(1.5 * SR, 383 * 128, BATCH).astype(np.int64)
    train_mask = patch_validity_mask(torch.from_numpy(lengths), 257, 384, 128).to(dev)
    attn = {"attention_fwd": [], "attention_bwd": []}  # max abs errors
    bwd_rel = []  # the backward's, relative to each gradient's largest
    for d in PADDED_HEAD_DIMS:
        q, k, v, dout = (torch.randn(BATCH, heads, n_tok, d, generator=g).to(dev)
                         for _ in range(4))
        kernels.reset_launch_counts()
        out = cuda_attention.attention(q, k, v, scale=d**-0.5, mask=train_mask)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        grads = torch.autograd.grad(
            cuda_attention.attention(*leaves, scale=d**-0.5, mask=train_mask), leaves, dout)
        ran(f"attention at D = {d}", {"attention_fwd": 2, "attention_bwd": 1})
        ref = cuda_attention.attention_bwd_plain(q, k, v, dout, scale=d**-0.5, mask=train_mask)
        attn["attention_fwd"].append(max_err(
            [out], [cuda_attention.attention_plain(q, k, v, scale=d**-0.5, mask=train_mask)]))
        attn["attention_bwd"].append(max_err(grads, ref))
        bwd_rel.append(max(float((a - r).abs().max() / r.abs().max())
                           for a, r in zip(grads, ref)))
        dp = cuda_attention.kernel_head_dim(d)
        inst = f"the {dp} instance" if dp <= 128 else f"the sliced instance, {dp // 128} slices"
        print(f"attention at D = {d} ({inst}, zero-padded to {dp}), q/k/v [{BATCH}, {heads}, "
              f"{n_tok}, {d}] under the train mask: forward max abs err "
              f"{attn['attention_fwd'][-1]:.3g} (tolerance {TOL_ATTN}), backward "
              f"{bwd_rel[-1]:.3g} of the largest |grad| (tolerance {TOL_BWD}), "
              f"{attn['attention_bwd'][-1]:.3g} abs", flush=True)
    if max(attn["attention_fwd"]) > TOL_ATTN or max(bwd_rel) > TOL_BWD:
        raise AssertionError(f"K2 at a padded head dim disagrees with its plain version: {attn}")
    for d in (256,):  # the sliced instance's time beside the D = 64 instance's phase 7 time
        qkv = [tuple(torch.randn(BATCH, heads, n_tok, d, generator=g).to(dev) for _ in range(3))
               for _ in range(4)]
        fwd_ms = device_ms(lambda q, k, v: cuda_attention.attention(q, k, v, scale=d**-0.5,
                                                                    mask=train_mask), qkv)
        print(f"attention at D = {d} (sliced), [{BATCH}, {heads}, {n_tok}, {d}] under the train "
              f"mask: {fwd_ms:.4f} ms on the device a call; registers and spills "
              f"{cuda_attention.kernel_info(d, n_tok)}, backward "
              f"{cuda_attention.bwd_kernel_info(d)}; {smi}", flush=True)

    # 3. the 28M serving recipe at 400/100/400, 32 x 3 s PCM16 (bucket 512)
    serve_cfg = {"audio": AUDIO_400, "model": {"output_mode": "mask", "head": "fullres_mask",
                                               "transformer": {"pos_embed": "factored_2d"}}}
    short = speechlike(SR, rng)
    enhancers = {}
    for name, config in (("400/100/400", serve_cfg), ("512/100/400", {**serve_cfg,
                                                                      "audio": AUDIO_DCCRN})):
        ref_short = AudioEnhancer(seeded(config), config, device="cpu", io_dtype="int16",
                                  mask_padding=True).enhance(short)
        enh = AudioEnhancer(seeded(config), config, device=dev, io_dtype="int16",
                            mask_padding=True)
        enhancers[name] = enh
        err = float(np.abs(enh.enhance(short) - ref_short).max())
        print(f"28M serving recipe at {name}: a 1 s clip cuda vs cpu max abs err {err:.3g} "
              f"(tolerance {TOL_WAVE})", flush=True)
        if err > TOL_WAVE:
            raise AssertionError(f"the 28M enhancer at {name} differs between cuda and cpu")
    wavs = [speechlike(int(SECONDS * SR), rng) for _ in range(BATCH)]
    launched, outs = {}, {}
    # 4. the DCCRN geometry through the same enhancer: K1 and K3g
    for name, want in (("400/100/400", {"stft_mag": 1, "attention_fwd": 6, "istft_polar": 1}),
                       ("512/100/400", {"stft_mag": 1, "attention_fwd": 6, "istft_dft": 1})):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        outs[name] = out = enhancers[name].enhance_batch(wavs)
        launched[name] = ran(f"the 28M serving batch at {name}", want)
        if any(o.shape != w.shape or not np.isfinite(o).all() for o, w in zip(out, wavs)):
            raise AssertionError(f"the 28M serving batch at {name}: output malformed")
    enhancer = enhancers["400/100/400"]
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enhancer.enhance_batch(wavs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"28M serving recipe at 400/100/400: enhance_batch of {BATCH} x {SECONDS:g} s PCM16 "
          f"in {wall * 1e3:.1f} ms (median of 5) = {BATCH * SECONDS / wall:.1f} audio-s/s; "
          f"launches {launched['400/100/400']}; DCCRN 512/100/400 launches "
          f"{launched['512/100/400']}; {smi}", flush=True)

    # 5. the recipe's train step at 400/100/400: cuda vs cpu at depth 1, and
    # one full-width step at batch 16 in the 384-frame bucket
    train_cfg = {"audio": AUDIO_400, "model": RECIPE["model"], "training": {"mask_padding": True}}
    check_step(step_cuda_vs_cpu(rng, config=train_cfg, loss_cfg=LossConfig(log_l1_weight=0.05)),
               "one recipe step at 400/100/400, depth 1")
    cfg = audio_config(train_cfg)
    model = seeded(train_cfg).to(dev)
    opt = Optimizer(parameters(model), "adamw", lr=TRAIN_LR, weight_decay=0.01, max_norm=1.0)
    step, _ = recipe_step_fns(model, opt, cfg=cfg)
    batch = batch_to_device(loader_batch(TRAIN_BATCH, 1.5 * SR, 383 * cfg.hop_length, rng, cfg),
                            dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    loss = float(step(batch)["total"])
    train = ran("the recipe's train step at 400/100/400",
                {"stft_mag": 2, "attention_fwd": 6, "attention_bwd": 6, **OPT_STEP})
    if not np.isfinite(loss):
        raise AssertionError(f"the train step at 400/100/400: loss {loss}")
    print(f"recipe train step at 400/100/400, batch {TRAIN_BATCH} x "
          f"{batch['noisy_audio'].shape[1]} samples: loss {loss:.4f}, launches {train}",
          flush=True)

    # 6. a model with head dim 48: embed 384, 8 heads, depth 2
    d48 = {"model": {"output_mode": "mask", "head": "fullres_mask",
                     "transformer": {"pos_embed": "factored_2d", "embed_dim": 384,
                                     "num_heads": 8, "num_layers": 2}}}
    x = torch.rand(4, 257, 384, 1, generator=g)
    mask = patch_validity_mask(torch.from_numpy(lengths[:4]), 257, 384, 128)
    outs = {}
    for device in ("cpu", "cuda"):
        m = seeded(d48).to(device)
        kernels.reset_launch_counts()
        with torch.inference_mode():
            outs[device] = m(x.to(device), mask=mask.to(device)).cpu()
        if device == "cuda":
            ran("the D = 48 model's forward", {"attention_fwd": 2})
    d48_err = max_err([outs["cuda"]], [outs["cpu"]])
    print(f"model with embed 384 and 8 heads (D = 48), depth 2, [4, 257, 384] under a patch "
          f"mask: cuda vs cpu max abs err {d48_err:.3g} (tolerance {TOL_WAVE})", flush=True)
    if d48_err > TOL_WAVE:
        raise AssertionError("the D = 48 model differs between cuda and cpu")

    # 7. Griffin-Lim at 4096/1024 through its entry point: K1g and K3g, the
    # spectral convergence falling from round 1 to the last
    gl_cfg = STFTConfig(n_fft=4096, hop_length=1024, win_length=4096)
    target = cuda_stft.stft_mag(torch.randn(4, 51100, generator=g).to(dev), gl_cfg)[2]
    phase0 = torch.rand(target.shape, generator=g).to(dev) * 2 * np.pi

    def convergence(y):
        spec = cuda_stft.stft_mag(y, gl_cfg)[2]
        return float((spec - target).norm() / target.norm())

    one = griffin_lim(target, gl_cfg, n_iter=1, phase=phase0)
    kernels.reset_launch_counts()
    last = griffin_lim(target, gl_cfg, n_iter=GL_ITERS_4096, phase=phase0)
    gl = ran(f"griffin_lim at 4096/1024, {GL_ITERS_4096} rounds",
             {"stft_dft": GL_ITERS_4096, "istft_dft": GL_ITERS_4096 + 1})
    sc1, sc_last = convergence(one), convergence(last)
    print(f"griffin_lim at 4096/1024 on [4, 2049, 50], {GL_ITERS_4096} rounds: launches {gl}, "
          f"output {tuple(last.shape)}, spectral convergence {sc1:.4f} after 1 round, "
          f"{sc_last:.4f} after {GL_ITERS_4096}", flush=True)
    if not torch.isfinite(last).all() or not sc_last < sc1:
        raise AssertionError("griffin_lim at 4096/1024: output not finite, or the spectral "
                             "convergence did not fall")

    # 8. times, in a fresh process (TIMES_CHILD): the 400/100 batch's busy time
    # and K1's and K3's share of it; K1 and K3 at 400/100 and 320/160, K1g and
    # K3g at the geometries they still serve
    child = subprocess.run([sys.executable, "-c", TIMES_CHILD, json.dumps(serve_cfg), smi],
                           cwd=ROOT, capture_output=True, text=True, timeout=900)
    lines = child.stdout.strip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    if child.returncode != 0:
        raise AssertionError(f"phase 16's times in a fresh process failed:\n"
                             f"{child.stdout[-3000:]}{child.stderr[-3000:]}")
    timed = json.loads(lines[-1])
    for name, e in timed["errs"].items():
        errs[name] += e
    print(f"geometry phase: {time.perf_counter() - t_phase:.1f} s; {smi}", flush=True)
    return {"errs": errs, "ms": timed["ms"], "dft_others": timed["dft_others"],
            "fft_ms": timed["fft_ms"], "attention": attn, "serve": launched["400/100/400"],
            "dccrn": launched["512/100/400"], "train": train, "gl": gl}


def geometry_times(serve_cfg: dict, smi: str) -> dict:
    """Phase 16's times, run in a fresh process (``TIMES_CHILD``). The 28M
    serving recipe at 400/100 on a 32 x 3 s PCM16 batch of seeded weights:
    busy ms on the device and K1's and K3's device ms in it (``path``); K1
    and K3 at 400/100 and 320/160 (``fft_ms``), K1g and K3g at the geometries
    they still serve (``ms`` at the first, ``dft_others``), each timed output's
    error against the plain version's (``errs``)."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
        AudioEnhancer,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
        create_hybrid_vit, init_weights,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import kernels
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import (
        STFTConfig,
    )

    kernels.build()
    dev, g, rng = torch.device("cuda"), torch.Generator().manual_seed(16), np.random.default_rng(16)
    model = init_weights(create_hybrid_vit(serve_cfg), torch.Generator().manual_seed(0))
    enhancer = AudioEnhancer(model, serve_cfg, device=dev, io_dtype="int16", mask_padding=True)
    wavs = [speechlike(int(SECONDS * SR), rng) for _ in range(BATCH)]
    enhancer.enhance_batch(wavs)
    times = device_times(lambda: enhancer.enhance_batch(wavs), need=("stft_mag", "istft_polar"))
    path = {name: kernel_ms(times, name) for name in ("stft_mag", "istft_polar")}
    if not all(path.values()):
        raise AssertionError(f"the 400/100 batch's profile lacks K1 or K3: {path}")
    print(f"28M serving recipe at 400/100/400, {BATCH} x {SECONDS:g} s PCM16, in a fresh "
          f"process: busy {sum(times.values()):.2f} ms on the device (profiler, one batch), K1 "
          f"{path['stft_mag']:.4f} ms, K3 {path['istft_polar']:.4f} ms, K2 "
          f"{kernel_ms(times, 'attention_fwd'):.4f} ms; {smi}", flush=True)
    fft_ms, ms, dft_others = {}, {}, {}
    errs = {name: [] for name in ("stft_mag", "istft_polar", "stft_dft", "istft_dft")}
    for n_fft, hop, win in ((400, 100, 400), (320, 160, 320)):
        cfg = STFTConfig(n_fft=n_fft, hop_length=hop, win_length=win)
        fft_ms[f"{n_fft}/{hop}/{win}"] = {name: time_stft_kernel(dev, g, name, cfg, smi)
                                          for name in ("stft_mag", "istft_polar")}
    for name in ("stft_mag", "istft_polar"):
        fft_ms["400/100/400"][name]["path_device_ms"] = path[name]
    for name, geoms in DFT_TIMED.items():
        for i, (n_fft, hop, win) in enumerate(geoms):
            m = time_stft_kernel(dev, g, name, STFTConfig(n_fft=n_fft, hop_length=hop,
                                                          win_length=win), smi)
            if i == 0:
                ms[name] = m
            else:
                dft_others.setdefault(name, {})[f"{n_fft}/{hop}/{win}"] = m
    for name, m in ms.items():
        errs[name].append(m.pop("max_abs_err"))
    for name, by_geom in dft_others.items():
        for m in by_geom.values():
            errs[name].append(m.pop("max_abs_err"))
    return {"fft_ms": fft_ms, "ms": ms, "dft_others": dft_others, "errs": errs}


TOL_RELPOS = 5e-5  # K2r vs float64 einsums at logits of O(10) (tests/test_torch_cuda.py)
# add_layer_norm's output vs its plain version in fp32 and float64: a
# LayerNorm of 64 values of O(1) summed in another order (tests/test_torch_cuda.py)
TOL_ADD_NORM = 1e-5
# instance_norm's output vs its plain version in fp32 and float64: a plane's
# mean and variance over up to 331k floats summed in another order, outputs
# of O(1)-O(5) (tests/test_torch_cuda.py)
TOL_INSTANCE_NORM = 1e-5


def profiled_ms(fn, inputs, times: int = 1) -> float | None:
    """``times`` x ``device_ms``, or None where the profiler hands back only
    empty traces, as it now and then does late in this script (the caller
    then has the CUDA events' time)."""
    try:
        return times * device_ms(fn, inputs)
    except RuntimeError as e:
        print(f"device time not measured: {e}", flush=True)
        return None
CMGAN_ROWS, CMGAN_FRAMES = 32, 819  # a batch of 32 clips in the 5.11-s bucket at hop 100


def cmgan(dev: torch.device, smi: str, rng: np.random.Generator) -> dict:
    """Phase 17: CMGAN's relative-position attention (K2r). a. K2r at head
    dim 16 against its plain version (the published einsums) in float64, at
    N = 101, 401 and 1001 with and without prefix masks. b. Per call and
    device time at a 32-clip batch in the 819-frame bucket (clips of 4.0-5.1
    s): the time attention over 32 x 101 rows of 819 frames under the
    batch's mask and the frequency attention over 32 x 819 rows of 101 bins;
    its yardstick, the plain einsums, on 4 of the 32 clips' rows (their
    logits at 32 would take ~170 GB) times 8. c. A CMGAN batch of 32 x 4 s
    clips through ``AudioEnhancer`` at the published widths: K1 1, K2r
    8, ``add_layer_norm`` 40, ``instance_norm`` 16, K3 1, K2 0 launches (the
    benchmark's seeded weights, float32 I/O); two of its clips cuda against
    cpu within ``TOL_WAVE``. ``add_norm_kernel`` and ``instance_norm_kernel``
    check and time those two kernels. Returns the errors, times and the
    batch's launches."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
        AudioEnhancer,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_attention as ca, kernels,
    )

    phase("cmgan: K2r against the published einsums and timed, add_layer_norm and instance_norm "
          "against ATen and timed; a CMGAN batch on the path")
    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(17)
    errs = []
    for n in (101, 401, 1001):
        q, k, v = (torch.randn(3, 4, n, 16, generator=g, device=dev) for _ in range(3))
        e = torch.randn(1025, 16, generator=g, device=dev)
        prefix = torch.arange(n, device=dev)[None, :] < torch.tensor([[0], [n // 3], [n]],
                                                                      device=dev)
        for mask in (None, prefix):
            with torch.no_grad():
                o = ca.attention_relpos(q, k, v, e, 512, scale=0.25, mask=mask)
            r = ca.attention_relpos_plain(q.double(), k.double(), v.double(), e.double(), 512,
                                          scale=0.25, mask=mask)
            errs.append(float((o.double() - r).abs().max()))
    print(f"K2r vs the einsums in float64, N 101/401/1001, no mask and prefix masks: max abs "
          f"err {max(errs):.3g} (tolerance {TOL_RELPOS}); resources at 1024 keys, masked: "
          f"{ca.relpos_kernel_info(16, 1024)}", flush=True)
    if max(errs) > TOL_RELPOS:
        raise AssertionError("K2r differs from its plain version")

    lens = np.sort(rng.integers(int(0.78 * (CMGAN_FRAMES - 1) * 100), (CMGAN_FRAMES - 1) * 100,
                                CMGAN_ROWS))
    kept = 1 + lens // 100
    frames_mask = (torch.arange(CMGAN_FRAMES)[None, :]
                   < torch.from_numpy(kept)[:, None]).to(dev)
    ms = {}
    for what, rows, n, mask in (
            ("time", CMGAN_ROWS * 101, CMGAN_FRAMES,
             frames_mask[:, None, :].expand(CMGAN_ROWS, 101, CMGAN_FRAMES).reshape(-1, CMGAN_FRAMES)),
            ("freq", CMGAN_ROWS * CMGAN_FRAMES, 101, None)):
        inputs = [tuple(torch.randn(rows, 4, n, 16, generator=g, device=dev) for _ in range(3))
                  + (torch.randn(1025, 16, generator=g, device=dev),) for _ in range(2)]
        keys = int(mask.sum()) if mask is not None else rows * n

        def call(q, k, v, e, mask=mask, keys=keys):
            with torch.no_grad():
                return ca.attention_relpos(q, k, v, e, 512, scale=0.25, mask=mask, kept_keys=keys)

        eighth = rows // 8

        def plain(q, k, v, e, mask=mask):
            return ca.attention_relpos_plain(q[:eighth], k[:eighth], v[:eighth], e, 512,
                                             scale=0.25,
                                             mask=None if mask is None else mask[:eighth])

        ops = 6.0 * 4 * n * keys * 16
        nbytes = 4.0 * 4 * rows * 4 * n * 16 + 4.0 * 1025 * 16
        b_ms, by = bound(ops, nbytes, TF32X3_PEAK)
        per, dev_ms = median_ms(call, inputs), profiled_ms(call, inputs)
        p_ms, p_dev = 8 * median_ms(plain, inputs[:1], reps=3), profiled_ms(plain, inputs[:1], 8)
        timed = dev_ms or per  # CUDA events where the profiler recorded nothing
        ms[what] = {"ms_per_call": per, "device_ms": dev_ms, "plain_ms": p_ms,
                    "plain_device_ms": p_dev, "bound_ms": b_ms, "bound_by": by,
                    "bound_share_device": b_ms / timed}
        print(f"K2r {what} attention [{rows}, 4, {n}, 16], {keys} kept keys: per call "
              f"{per:.4f} ms (device {ms_or_not(dev_ms)}); the einsums (x8 from 4 clips' rows) "
              f"{p_ms:.4f} ms (device {ms_or_not(p_dev)}); bound {b_ms:.4f} ms by {by}, "
              f"{100 * b_ms / timed:.1f}% of it in {'device' if dev_ms else 'per-call'} time; "
              f"{smi}", flush=True)
        del inputs
        torch.cuda.empty_cache()
    norm_errs, norm_ms = add_norm_kernel(dev, smi, g)
    in_errs, in_ms = instance_norm_kernel(dev, smi, g, kept)

    from portbench.traffic.offline_cmgan import build_model

    config = json.loads((ROOT / "portbench" / "configs" / "cmgan.json").read_text())
    port = {"model": config["model"], "audio": config["audio"]}
    wavs = [speechlike(int(4.0 * SR), rng) for _ in range(CMGAN_ROWS)]
    cpu_model, _ = build_model(config, 5, "cpu")  # the benchmark's seeded weights, one draw
    outs = {}
    for device in (dev, torch.device("cpu")):
        model = copy.deepcopy(cpu_model)
        enh = AudioEnhancer(model, port, device=device, mask_padding=True)
        kernels.reset_launch_counts()
        batch = wavs if device.type == "cuda" else wavs[:2]
        outs[device.type] = enh.enhance_batch(batch)
        if device.type == "cuda":
            launches = kernels.launched()
            times = device_times(lambda: enh.enhance_batch(batch))
    norm_ms["rows"]["path_device_ms"] = kernel_ms(times, "add_layer_norm") / 40
    in_ms["path_device_ms"] = kernel_ms(times, "instance_norm") / 16
    top = sorted(times.items(), key=lambda kv: -kv[1])[:10]
    busy = sum(times.values())
    print(f"CMGAN batch device time (profiler): busy {busy:.2f} ms; add_layer_norm "
          f"{kernel_ms(times, 'add_layer_norm'):.3f} ms, {norm_ms['rows']['path_device_ms']:.4f} "
          f"ms a launch; instance_norm {kernel_ms(times, 'instance_norm'):.3f} ms, "
          f"{in_ms['path_device_ms']:.4f} ms a launch; largest: "
          f"{[(k[:70], round(v, 3), f'{100 * v / busy:.1f}%') for k, v in top]}", flush=True)
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs["cuda"], outs["cpu"]))
    peak = max(float(np.abs(o).max()) for o in outs["cpu"])
    print(f"CMGAN batch of {CMGAN_ROWS} x 4 s at the published widths (the benchmark's weights): "
          f"launches {launches}; two clips cuda vs cpu max abs "
          f"err {err:.3g} (tolerance {TOL_WAVE}; outputs' peak {peak:.3g}); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if launches != {"stft_mag": 1, "attention_relpos": 8, "add_layer_norm": 40,
                    "instance_norm": 16, "istft_polar": 1} or err > TOL_WAVE:
        raise AssertionError("the CMGAN batch launched other kernels or differs from the cpu")
    return {"errs": errs, "ms": ms, "launches": launches, "norm_errs": norm_errs,
            "norm_ms": norm_ms, "in_errs": in_errs, "in_ms": in_ms}


def add_norm_kernel(dev: torch.device, smi: str, g: torch.Generator) -> tuple[list, dict]:
    """Phase 17, ``add_layer_norm``: against its plain version in fp32 (the
    stored sum equal, the output within ``TOL_ADD_NORM``) and float64 (the
    output) at 33, 303 and 9,409 rows at each boundary's arguments; then
    per-call and device times at [32 x 101 x 819, 64], the attention's
    boundary (delta as rows) and the convolution's (channel-first), beside
    ATen's add and ``layer_norm`` on the same tensors (the plain version,
    two launches) and the bound: x and delta read, the sum and the output
    written, at 3.35 TB/s. Returns the errors and the times."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_layer_norm as ln,
    )

    def draw(groups, n):
        x, d, r = (torch.randn(groups, n, 64, generator=g, device=dev) for _ in range(3))
        w = 1 + 0.1 * torch.randn(64, generator=g, device=dev)
        return x, d, r, w, 0.1 * torch.randn(64, generator=g, device=dev)

    errs = []
    for groups, n in ((1, 33), (3, 101), (97, 97)):
        x, d, r, w, b = draw(groups, n)
        for cf, res, scale in ((False, None, 0.5), (False, None, 1.0), (True, None, 1.0),
                               (False, r, 0.5)):
            dd = d.transpose(1, 2).contiguous() if cf else d
            with torch.no_grad():
                s, h = ln.add_layer_norm(x, dd, w, b, 1e-5, scale=scale, channels_first=cf,
                                         residual=res, keep_sum=True)
            want_s, want_h = ln.add_layer_norm_plain(x, dd, w, b, 1e-5, scale=scale,
                                                     channels_first=cf, residual=res)
            _, h64 = ln.add_layer_norm_plain(
                x.double(), dd.double(), w.double(), b.double(), 1e-5, scale=scale,
                channels_first=cf, residual=None if res is None else res.double())
            if not torch.equal(s, want_s):
                raise AssertionError(f"add_layer_norm's sum differs from the plain version's "
                                     f"at {groups}x{n}, channels_first={cf}, scale={scale}")
            errs.append(max(float((h - want_h).abs().max()),
                            float((h.double() - h64).abs().max())))
    print(f"add_layer_norm vs its plain version, fp32 and float64: max abs err {max(errs):.3g} "
          f"(tolerance {TOL_ADD_NORM}); sums equal", flush=True)
    if max(errs) > TOL_ADD_NORM:
        raise AssertionError("add_layer_norm differs from its plain version")

    groups, n = CMGAN_ROWS * 101, CMGAN_FRAMES
    nbytes = 4 * (4.0 * groups * n * 64)  # x, delta in; the sum, the output out
    b_ms, by = bound(0.0, nbytes, FP32_PEAK)
    ms = {}
    for what, cf in (("rows", False), ("channels_first", True)):
        inputs = []
        for _ in range(2):
            x, d, _, w, b = draw(groups, n)
            inputs.append((x, d.transpose(1, 2).contiguous() if cf else d, w, b))
            del x, d

        def kern(x, d, w, b, cf=cf):
            with torch.no_grad():
                return ln.add_layer_norm(x, d, w, b, 1e-5, channels_first=cf, keep_sum=True)

        def aten(x, d, w, b, cf=cf):
            s = (d.transpose(1, 2) if cf else d) + x
            return s, F.layer_norm(s, (64,), w, b, 1e-5)

        k1, a1, a2, k2 = (median_ms(f, inputs) for f in (kern, aten, aten, kern))
        per, lib = min(k1, k2), min(a1, a2)
        dev_ms, lib_dev = profiled_ms(kern, inputs), profiled_ms(aten, inputs)
        timed = dev_ms or per
        ms[what] = {"ms_per_call": per, "device_ms": dev_ms, "library_ms": lib,
                    "library_device_ms": lib_dev, "bound_ms": b_ms, "bound_by": by,
                    "bound_share_device": b_ms / timed}
        print(f"add_layer_norm at [{groups * n}, 64], delta {what}: per call {per:.4f} ms "
              f"(device {ms_or_not(dev_ms)}); ATen's add + layer_norm {lib:.4f} ms (device "
              f"{ms_or_not(lib_dev)}); bound {b_ms:.4f} ms by {by} ({nbytes / 1e9:.3f} GB), "
              f"{100 * b_ms / timed:.1f}% of it in {'device' if dev_ms else 'per-call'} time; "
              f"{smi}", flush=True)
        del inputs
        torch.cuda.empty_cache()
    return errs, ms


def instance_norm_kernel(dev: torch.device, smi: str, g: torch.Generator,
                         kept: np.ndarray) -> tuple[list, dict]:
    """Phase 17, ``instance_norm``: against its plain version in fp32 and
    float64 (the output within ``TOL_INSTANCE_NORM``) with ragged counts (a
    full row, a one-frame row) and with none, at odd T x F (planes 4-byte
    aligned only), one channel (a plane cut into chunks), 202 bins and
    channels-last, and a second call the same bits; then per-call and device
    times at the cell's four shapes (101 bins in both layouts: the encoder's
    contiguous, the decoders' channels-last) with the batch's counts
    ``kept``, each output first held against ATen's unfused chain (the
    plain version: the masked sums, the affine step, ``F.prelu``) and the
    float64 plain version within ``TOL_INSTANCE_NORM``, beside that chain's
    time and two bytes bounds at 3.35 TB/s: the design's (the valid frames
    read, then every frame read and written) and the function's (every
    frame read once and written once). Returns the errors and the times."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_instance_norm as cin,
    )

    def draw(b, c, t, f):
        x = 0.5 + 1.5 * torch.randn(b, c, t, f, generator=g, device=dev)
        w = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
        bias = 0.1 * torch.randn(c, generator=g, device=dev)
        return x, w, bias, 0.25 + 0.1 * torch.randn(c, generator=g, device=dev)

    errs = []
    for (b, c, t, f), counts, cl in (((3, 64, 17, 201), [17, 1, 9], False),
                                     ((2, 64, 21, 101), None, False),
                                     ((4, 1, 819, 201), [819, 1, 400, 700], False),
                                     ((2, 64, 33, 202), [33, 40], False),
                                     ((3, 64, 17, 101), [17, 1, 9], True),
                                     ((2, 64, 819, 101), None, True)):
        x, w, bias, slope = draw(b, c, t, f)
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
        n_valid = None if counts is None else torch.tensor(counts, dtype=torch.int32, device=dev)
        with torch.no_grad():
            y = cin.instance_norm_prelu(x, n_valid, w, bias, slope, 1e-5)
            again = cin.instance_norm_prelu(x, n_valid, w, bias, slope, 1e-5)
        want = cin.instance_norm_prelu_plain(x, n_valid, w, bias, slope, 1e-5)
        want64 = cin.instance_norm_prelu_plain(x.double(), n_valid, w.double(), bias.double(),
                                               slope.double(), 1e-5)
        if not torch.equal(y, again):
            raise AssertionError(f"instance_norm gave other bits on a second call at {x.shape}")
        errs.append(max(float((y - want).abs().max()), float((y.double() - want64).abs().max())))
    print(f"instance_norm vs its plain version, fp32 and float64: max abs err {max(errs):.3g} "
          f"(tolerance {TOL_INSTANCE_NORM}); a second call the same bits", flush=True)
    if max(errs) > TOL_INSTANCE_NORM:
        raise AssertionError("instance_norm differs from its plain version")

    n_valid = torch.from_numpy(kept.astype(np.int32)).to(dev)
    ms = {}
    for c, f, cl in ((64, 201, False), (64, 101, False), (64, 101, True), (64, 202, False),
                     (1, 201, False)):
        shape = (CMGAN_ROWS, c, CMGAN_FRAMES, f)
        inputs = []
        for _ in range(2):
            x, w, bias, slope = draw(*shape)
            if cl:
                x = x.contiguous(memory_format=torch.channels_last)
            inputs.append((x, w, bias, slope, n_valid))
            del x
        nbytes = 4.0 * c * f * (int(kept.sum()) + 2 * CMGAN_ROWS * CMGAN_FRAMES)
        b_ms, by = bound(0.0, nbytes, FP32_PEAK)
        two_pass_ms = 4.0 * c * f * 2 * CMGAN_ROWS * CMGAN_FRAMES / HBM_RATE * 1e3

        def kern(x, w, bias, slope, nv):
            with torch.no_grad():
                return cin.instance_norm_prelu(x, nv, w, bias, slope, 1e-5)

        def aten(x, w, bias, slope, nv):
            return cin.instance_norm_prelu_plain(x, nv, w, bias, slope, 1e-5)

        x, w, bias, slope, nv = inputs[0]
        y = kern(*inputs[0])
        err = float((y - aten(*inputs[0])).abs().max())
        want64 = cin.instance_norm_prelu_plain(x.double(), nv, w.double(), bias.double(),
                                               slope.double(), 1e-5)
        err = max(err, float((y.double() - want64).abs().max()))
        del x, y, want64
        errs.append(err)
        what = "x".join(map(str, shape)) + ("_channels_last" if cl else "")
        if err > TOL_INSTANCE_NORM:
            raise AssertionError(f"instance_norm at [{what}] differs from its plain version by "
                                 f"{err:.3g}")
        k1, a1, a2, k2 = (median_ms(fn, inputs) for fn in (kern, aten, aten, kern))
        per, lib = min(k1, k2), min(a1, a2)
        dev_ms, lib_dev = profiled_ms(kern, inputs), profiled_ms(aten, inputs)
        timed = dev_ms or per
        ms[what] = {"ms_per_call": per, "device_ms": dev_ms, "library_ms": lib,
                    "library_device_ms": lib_dev, "bound_ms": b_ms, "bound_by": by,
                    "bound_share_device": b_ms / timed, "two_pass_bound_ms": two_pass_ms,
                    "two_pass_share_device": two_pass_ms / timed, "max_abs_err": err}
        print(f"instance_norm at [{what}], ragged counts: max abs err {err:.3g} against ATen's "
              f"chain and float64; per call {per:.4f} ms (device {ms_or_not(dev_ms)}); ATen's "
              f"unfused chain {lib:.4f} ms (device {ms_or_not(lib_dev)}); bound {b_ms:.4f} ms by "
              f"{by} ({nbytes / 1e9:.3f} GB), {100 * b_ms / timed:.1f}% of it in "
              f"{'device' if dev_ms else 'per-call'} time; the function's two-pass bound "
              f"{two_pass_ms:.4f} ms, {100 * two_pass_ms / timed:.1f}% of it; {smi}", flush=True)
        del inputs
        torch.cuda.empty_cache()
    return errs, ms


SEM_ROWS, SEM_FRAMES, SEM_BINS = 32, 819, 100  # a SEMamba batch in the 819-frame bucket
# the selective scan against its plain version (fp32 or float64), relative to
# the output's largest magnitude: fp32 through up to 819 steps of a recurrence
# whose slowest decays keep ~1,000 steps, exp2f against exp and the sums in
# another order
TOL_SCAN = 1e-4


def scan_inputs(g: torch.Generator, seqs: int, steps: int, dev, d: int = 256, n: int = 16):
    """The scan's arguments as SEMamba hands them over (z, B and C strided
    views of the in_proj and x_proj rows) at Mamba's published A_log, D and
    Delta bias."""
    u = torch.randn(seqs, steps, d, generator=g, device=dev)
    delta = 0.5 * torch.randn(seqs, steps, d, generator=g, device=dev)
    xz = torch.randn(seqs, steps, 2 * d, generator=g, device=dev)
    x_dbl = torch.randn(seqs, steps, 4 + 2 * n, generator=g, device=dev)
    a_log = torch.log(torch.arange(1, n + 1, device=dev, dtype=torch.float32)).repeat(d, 1)
    dt = torch.exp(torch.rand(d, generator=g, device=dev) * np.log(100.0) + np.log(1e-3))
    bias = dt + torch.log(-torch.expm1(-dt))
    return (u, delta, xz[..., d:], x_dbl[..., 4:4 + n], x_dbl[..., 4 + n:], a_log,
            torch.ones(d, device=dev), bias)


# the depthwise conv with its SiLU against its plain version in float64,
# relative to the output's largest magnitude: four fp32 products summed into
# the bias and a SiLU
TOL_CONV = 1e-6


def conv_kernel(dev: torch.device, smi: str, g: torch.Generator) -> tuple[list, dict]:
    """Phase 18, ``conv1d_silu``: against its plain version in float64
    within ``TOL_CONV`` at small shapes (x a view of the in_proj rows or
    contiguous, 256 channels in float4 lanes or 40 a float each, fewer steps
    than taps, both directions), then at the cell's two shapes, the time
    mixers [3,200, 819, 256] and the frequency mixers [26,208, 100, 256], x a
    view of rows of 512 floats, both directions: the error against float64,
    per-call and device time, ATen's chain (the plain version: the padded
    transposed copy, the depthwise conv, the transpose back and the SiLU)
    and the bytes bound, x read once and u written once at 3.35 TB/s.
    Returns the errors and the times."""
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_scan as cs,
    )

    def draw(seqs, steps, d=256, strided=True):
        xz = torch.randn(seqs, steps, 2 * d, generator=g, device=dev)
        x = xz[..., :d] if strided else xz[..., :d].contiguous()
        w = 0.28 * torch.randn(d, 1, 4, generator=g, device=dev)
        return x, w, 0.28 * torch.randn(d, generator=g, device=dev)

    def err64(x, w, b, reverse):
        with torch.no_grad():
            u = cs.conv1d_silu(x, w, b, reverse)
        want = cs.conv1d_silu_plain(x.double(), w.double(), b.double(), reverse)
        return float((u.double() - want).abs().max() / want.abs().max())

    errs = [err64(*draw(seqs, steps, d, strided), reverse)
            for seqs, steps, d, strided in ((5, 70, 256, True), (5, 70, 256, False),
                                            (3, 67, 40, True), (4, 3, 256, True),
                                            (4, 1, 40, False))
            for reverse in (False, True)]
    print(f"conv1d_silu vs its plain version in float64, 256 and 40 channels, x strided and "
          f"contiguous, 1-70 steps, both directions: max error {max(errs):.3g} of the "
          f"output's largest (tolerance {TOL_CONV})", flush=True)
    if max(errs) > TOL_CONV:
        raise AssertionError("conv1d_silu differs from its plain version")

    ms = {}
    for what, seqs, steps in (("time", SEM_ROWS * SEM_BINS, SEM_FRAMES),
                              ("freq", SEM_ROWS * SEM_FRAMES, SEM_BINS)):
        for reverse in (False, True):
            inputs = [draw(seqs, steps) for _ in range(2)]

            def kern(x, w, b, reverse=reverse):
                with torch.no_grad():
                    return cs.conv1d_silu(x, w, b, reverse)

            def aten(x, w, b, reverse=reverse):
                return cs.conv1d_silu_plain(x, w, b, reverse)

            err = err64(*inputs[0], reverse)
            errs.append(err)
            k1, a1, a2, k2 = (median_ms(f, inputs) for f in (kern, aten, aten, kern))
            per, lib = min(k1, k2), min(a1, a2)
            dev_ms, lib_dev = profiled_ms(kern, inputs), profiled_ms(aten, inputs)
            nbytes = 4.0 * 256 * 2 * seqs * steps
            b_ms, by = bound(0.0, nbytes, FP32_PEAK)
            timed = dev_ms or per
            key = what + ("_reverse" if reverse else "")
            ms[key] = {"ms_per_call": per, "device_ms": dev_ms, "library_ms": lib,
                       "library_device_ms": lib_dev, "bound_ms": b_ms, "bound_by": by,
                       "bound_share_device": b_ms / timed, "max_rel_err": err}
            print(f"conv1d_silu {key} [{seqs}, {steps}, 256], x strided 512: per call {per:.4f} "
                  f"ms (device {ms_or_not(dev_ms)}); ATen's pad + conv + transpose + SiLU "
                  f"{lib:.4f} ms (device {ms_or_not(lib_dev)}); bound {b_ms:.4f} ms by {by} "
                  f"({nbytes / 1e9:.3f} GB), {100 * b_ms / timed:.1f}% of it in "
                  f"{'device' if dev_ms else 'per-call'} time; vs float64 {err:.3g}; {smi}",
                  flush=True)
            del inputs
            torch.cuda.empty_cache()
    if max(errs) > TOL_CONV:
        raise AssertionError("conv1d_silu differs from its plain version at the cell's shapes")
    return errs, ms


def semamba(dev: torch.device, smi: str, rng: np.random.Generator) -> dict:
    """Phase 18: SEMamba's selective scan (``selective_scan``). a. Against
    its plain version in float64 at small shapes (32, 64 and 256 channels;
    every step, ragged and empty rows; both directions; B and C as views and
    as rows a float4 does not align), within ``TOL_SCAN``. b. At the cell's two
    shapes, a 32-clip batch in the 819-frame bucket: the time scans [3,200,
    819, 256] under the batch's lengths, forward and backward, and the
    frequency scans [26,208, 100, 256] over its valid frames: against the
    plain version in fp32, per call and device time, the plain version's
    (one call), and the bound (``portbench/semamba_work.py``'s: the SFU's
    exponentials as 16 fp32 operations each, or u, delta, z, B, C read and
    y written once, over the valid steps); ``conv_kernel`` checks and times
    ``conv1d_silu``. c. A SEMamba batch of 32 x 4 s clips at the published
    widths (the benchmark's seeded weights) through ``AudioEnhancer``: K1 1,
    ``instance_norm`` 16, ``selective_scan`` 16, ``conv1d_silu`` 16 and K3 1
    launches; two of its clips cuda against cpu within ``TOL_WAVE``; its ten
    largest device functions. Returns the errors, times and the batch's
    launches."""
    from portbench import semamba_work
    from portbench.traffic import offline_semamba
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
        AudioEnhancer,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_scan as cs, kernels,
    )

    phase("semamba: the selective scan against its plain version and timed; a SEMamba batch "
          "on the path")
    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(18)
    errs = []
    for d, steps, nv in ((32, 37, None), (64, 70, [70, 1, 0, 33]),
                         (256, 200, [200, 150, 1, 0, 77])):
        args = scan_inputs(g, 4 if nv is None else len(nv), steps, dev, d)
        n_valid = None if nv is None else torch.tensor(nv, dtype=torch.int32, device=dev)
        for reverse in (False, True):
            for packed in (False, True):
                a = list(args)
                if packed:  # B and C rows of 33 floats: the wrapper packs them
                    bc = torch.cat([a[3], a[4], a[4][..., :1]], dim=-1)
                    a[3], a[4] = bc[..., :16], bc[..., 16:32]
                with torch.no_grad():
                    y = cs.selective_scan(*a, n_valid=n_valid, reverse=reverse)
                want = cs.selective_scan_plain(*(t.double() for t in a), n_valid, reverse)
                errs.append(float((y.double() - want).abs().max() / want.abs().max()))
    print(f"selective_scan vs its plain version in float64, 32/64/256 channels, both "
          f"directions, ragged and empty rows: max error {max(errs):.3g} of the output's largest "
          f"(tolerance {TOL_SCAN})", flush=True)
    if max(errs) > TOL_SCAN:
        raise AssertionError("selective_scan differs from its plain version")

    lens = np.sort(rng.integers(int(0.78 * (SEM_FRAMES - 1) * 100), (SEM_FRAMES - 1) * 100,
                                SEM_ROWS))
    kept = torch.from_numpy((1 + lens // 100).astype(np.int32)).to(dev)
    frames = torch.arange(SEM_FRAMES, device=dev)[None, :] < kept[:, None]
    config = json.loads((ROOT / "portbench" / "configs" / "semamba.json").read_text())
    work = semamba_work.scan_work(config, SEM_ROWS, (SEM_FRAMES - 1) * 100, lens.tolist())[0]
    ms, big_errs = {}, []
    for what, seqs, steps, n_valid, reverse in (
            ("time", SEM_ROWS * SEM_BINS, SEM_FRAMES, kept.repeat_interleave(SEM_BINS), False),
            ("time_reverse", SEM_ROWS * SEM_BINS, SEM_FRAMES, kept.repeat_interleave(SEM_BINS),
             True),
            ("freq", SEM_ROWS * SEM_FRAMES, SEM_BINS,
             (frames.to(torch.int32) * SEM_BINS).view(-1), False)):
        inputs = [scan_inputs(g, seqs, steps, dev) for _ in range(2)]

        def call(*a, n_valid=n_valid, reverse=reverse):
            with torch.no_grad():
                return cs.selective_scan(*a, n_valid=n_valid, reverse=reverse)

        def plain(*a, n_valid=n_valid, reverse=reverse):
            return cs.selective_scan_plain(*a, n_valid, reverse)

        want = plain(*inputs[0])
        err = float((call(*inputs[0]) - want).abs().max() / want.abs().max())
        big_errs.append(err)
        del want
        per, dev_ms = median_ms(call, inputs), profiled_ms(call, inputs)
        p_ms = median_ms(plain, inputs[:1], reps=1)
        b_ms, by = bound(work[0], work[1], FP32_PEAK)
        timed = dev_ms or per
        ms[what] = {"ms_per_call": per, "device_ms": dev_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": "exponentials" if by == "operations" else by,
                    "bound_share_device": b_ms / timed, "max_rel_err_fp32": err}
        print(f"selective_scan {what} [{seqs}, {steps}, 256], {int(n_valid.sum())} valid steps: "
              f"per call {per:.4f} ms (device {ms_or_not(dev_ms)}); plain {p_ms:.1f} ms; bound "
              f"{b_ms:.4f} ms by {ms[what]['bound_by']}, {100 * b_ms / timed:.1f}% of it in "
              f"{'device' if dev_ms else 'per-call'} time; vs plain fp32 {err:.3g}; {smi}",
              flush=True)
        del inputs
        torch.cuda.empty_cache()
    if max(big_errs) > TOL_SCAN:
        raise AssertionError("selective_scan differs from its plain version at the cell's shapes")
    conv_errs, conv_ms = conv_kernel(dev, smi, g)

    port = {"model": config["model"], "audio": config["audio"]}
    wavs = [speechlike(int(4.0 * SR), rng) for _ in range(SEM_ROWS)]
    cpu_model, _ = offline_semamba.build_model(config, 5, "cpu")  # the benchmark's weights
    outs = {}
    for device in (dev, torch.device("cpu")):
        model = copy.deepcopy(cpu_model)
        enh = AudioEnhancer(model, port, device=device, mask_padding=True)
        kernels.reset_launch_counts()
        batch = wavs if device.type == "cuda" else wavs[:2]
        outs[device.type] = enh.enhance_batch(batch)
        if device.type == "cuda":
            launches = kernels.launched()
            times = device_times(lambda: enh.enhance_batch(batch))
            batch_ms = median_ms(lambda: enh.enhance_batch(batch), [()], reps=3)
    scan_dev = kernel_ms(times, "selective_scan")
    conv_dev = kernel_ms(times, "conv1d_silu")
    top = sorted(times.items(), key=lambda kv: -kv[1])[:10]
    busy = sum(times.values())
    print(f"SEMamba batch of {SEM_ROWS} x 4 s: wall {batch_ms:.1f} ms, device busy {busy:.2f} "
          f"ms; selective_scan {scan_dev:.3f} ms ({100 * scan_dev / busy:.1f}%), "
          f"{scan_dev / 16:.4f} ms a launch; conv1d_silu {conv_dev:.3f} ms "
          f"({100 * conv_dev / busy:.1f}%), {conv_dev / 16:.4f} ms a launch; largest: "
          f"{[(k[:70], round(v, 3), f'{100 * v / busy:.1f}%') for k, v in top]}", flush=True)
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs["cuda"], outs["cpu"]))
    peak = max(float(np.abs(o).max()) for o in outs["cpu"])
    print(f"SEMamba batch at the published widths: launches {launches}; two clips cuda vs cpu "
          f"max abs err {err:.3g} (tolerance {TOL_WAVE}; outputs' peak {peak:.3g}); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if launches != {"stft_mag": 1, "instance_norm": 16, "selective_scan": 16,
                    "conv1d_silu": 16, "istft_polar": 1} or err > TOL_WAVE:
        raise AssertionError("the SEMamba batch launched other kernels or differs from the cpu")
    ms["path_device_ms"] = scan_dev / 16
    conv_ms["path_device_ms"] = conv_dev / 16
    return {"errs": errs + big_errs, "ms": ms, "conv_errs": conv_errs, "conv_ms": conv_ms,
            "launches": launches}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="N > 1: run phase 11 alone, over NCCL across N cards")
    args = ap.parse_args()
    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs one CUDA card")
    if args.cards > torch.cuda.device_count():
        raise RuntimeError(f"--cards {args.cards}: {torch.cuda.device_count()} CUDA devices visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, card: {smi}", flush=True)
    # float32 end to end: cuDNN convolutions would otherwise run in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.data.wavio import (
        read_wav_bytes, wav_bytes,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.inference import (
        AudioEnhancer, make_server,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models import (
        HybridViT, create_hybrid_vit, init_weights,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.models.components import (
        patch_validity_mask,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops import (
        cuda_attention, cuda_stft, kernels,
    )
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.ops.stft import STFTConfig
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch.utils.checkpoint import (
        load_model_weights, read_meta,
    )

    phase("build")
    t0 = time.perf_counter()
    libs = kernels.build()
    print(f"built {sorted({p.name for p in libs.values()})} from csrc/*.cu (one nvcc each, "
          f"in parallel) in {time.perf_counter() - t0:.1f} s", flush=True)
    # every instance runs: 64 at the repo's configs, 16, 32 and 128 for the
    # head dims between them (zero-padded; phase 16), the sliced one above
    # 128 (256: two slices; phase 16)
    for d in cuda_attention._HEAD_DIMS + (256,):
        print(f"attention_fwd at head dim {d}, 384 keys, masked: "
              f"{cuda_attention.kernel_info(d, 384)}; attention_bwd, registers and local "
              f"(spill) bytes a thread of each pass: {cuda_attention.bwd_kernel_info(d)}",
              flush=True)
    cuobjdump = shutil.which("cuobjdump") or str(Path(kernels._nvcc()).parent / "cuobjdump")
    for name, passes in (("attention_fwd", ("attention_fwd_kernel",)),
                         ("attention_bwd", ("attention_bwd_dq_kernel", "attention_bwd_dkdv_kernel")),
                         ("stft_dft", ("stft_dft_kernel",)),
                         ("istft_dft", ("istft_dft_frames_kernel",)),
                         ("attention_relpos", ("attention_relpos_fwd_kernel",))):
        hmma = tf32_hmma(cuobjdump, libs[name])
        for fn in passes:
            found = [i for f, instrs in hmma.items() if fn in f for i in instrs]
            if not found:
                raise AssertionError(f"{fn}'s SASS holds no TF32 tensor-core instruction")
            print(f"{fn} SASS: {len(found)} TF32 tensor-core instructions over its head-dim "
                  f"instances ({sorted(set(i.split()[0] for i in found))}, e.g. {found[0]!r})",
                  flush=True)
    if args.cards > 1:
        return across_cards(dev, smi, args.cards)
    # the native WAV runtime, with the host compiler, before anything decodes
    # a file through it (phase 12 checks it)
    from speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch import native

    t0 = time.perf_counter()
    native_lib = native.build()
    native_build_s = time.perf_counter() - t0
    print(f"built {native_lib.name} from native/sevit_audio.cpp with the host compiler in "
          f"{native_build_s:.2f} s", flush=True)

    phase("kernels vs plain")
    cfg = STFTConfig()
    g = torch.Generator().manual_seed(0)
    wav_len = int(SECONDS * SR) + 1024  # 49024 = (384-1)*128: the 3 s bucket
    n_frames, heads, n_tok, dh = 384, 8, 16 * 24, 64
    errs = {}
    # the main path's shape, a ragged length, and one shorter than a frame
    # whose reflect padding reaches both ends
    for shape in ((BATCH, wav_len), (1, 5123), (2, 300)):
        x = torch.randn(shape, generator=g).to(dev)
        errs.setdefault("stft_mag", []).append(
            max_err(cuda_stft.stft_mag(x, cfg), cuda_stft.stft_mag_plain(x, cfg)))
    # the serving batch's mask (32 clips of 3 s keep every key), and one of
    # clip lengths spread evenly from 1 to 3.06 s (a third of the keys masked)
    serve_mask = patch_validity_mask(torch.full((BATCH,), int(SECONDS * SR)), 257, n_frames,
                                     cfg.hop_length).to(dev)
    lengths = torch.from_numpy(np.linspace(SR, wav_len, BATCH).astype(np.int64))
    mix_mask = patch_validity_mask(lengths, 257, n_frames, cfg.hop_length).to(dev)
    ragged_mask = torch.rand(4, 200, generator=g) > 0.3
    ragged_mask[0] = False  # a row with every key masked
    single_mask = torch.rand(3, 37, generator=g) > 0.3
    single_mask[1] = False
    single_mask[1, 20] = True  # a row keeping a single key
    for (b, n, mask) in ((BATCH, n_tok, serve_mask), (BATCH, n_tok, mix_mask),
                         (4, 200, ragged_mask.to(dev)), (3, 37, single_mask.to(dev))):
        q, k, v = (torch.randn(b, heads, n, dh, generator=g).to(dev) for _ in range(3))
        errs.setdefault("attention_fwd", []).append(max_err(
            [cuda_attention.attention(q, k, v, scale=dh**-0.5, mask=mask)],
            [cuda_attention.attention_plain(q, k, v, scale=dh**-0.5, mask=mask)]))
    for (b, nf, length) in ((BATCH, n_frames, wav_len), (2, 376, 48000)):
        mag = torch.rand(b, 257, nf, generator=g).to(dev)
        ph = (torch.rand(b, 257, nf, generator=g) * 2 * np.pi - np.pi).to(dev)
        errs.setdefault("istft_polar", []).append(max_err(
            [cuda_stft.istft_polar(mag, ph, cfg, length=length)],
            [cuda_stft.istft_polar_plain(mag, ph, cfg, length=length)]))
    torch.cuda.synchronize()
    tols = {"stft_mag": TOL_STFT, "attention_fwd": TOL_ATTN, "istft_polar": TOL_ISTFT}
    for name, e in errs.items():
        print(f"{name}: max abs err {e} (tolerance {tols[name]})", flush=True)
        if max(e) > tols[name]:
            raise AssertionError(f"{name} disagrees with its plain version: {e}")

    phase("trained weights: fixture on cuda vs cpu")
    fixture = ROOT / "tests" / "fixtures" / "tiny_denoiser_mask"
    fx_cfg = read_meta(fixture)["config"]
    rng = np.random.default_rng(7)
    clips = [speechlike(int(1.3 * SR), rng), speechlike(int(2.2 * SR), rng)]
    outs = {}
    for device in ("cuda", "cpu"):
        model = load_model_weights(fixture, HybridViT(**fx_cfg["tiny"]))
        enh = AudioEnhancer(model, fx_cfg, device=device, mask_padding=True)
        outs[device] = enh.enhance_batch(clips)
    for a, b in zip(outs["cuda"], outs["cpu"]):
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError("fixture output malformed")
    fx_err = max(float(np.abs(a - b).max()) for a, b in zip(outs["cuda"], outs["cpu"]))
    print(f"fixture waveforms cuda vs cpu: max abs err {fx_err:.3g} (tolerance {TOL_WAVE})", flush=True)
    if fx_err > TOL_WAVE:
        raise AssertionError("fixture enhancement differs between cuda and cpu")

    phase("full width: 28M serving recipe, 32 x 3 s PCM16 on cuda")
    config = {"model": {"output_mode": "mask", "head": "fullres_mask",
                        "transformer": {"pos_embed": "factored_2d"}}}
    model = init_weights(create_hybrid_vit(config), torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    short = speechlike(SR, rng)
    ref_short = AudioEnhancer(model, config, device="cpu", io_dtype="int16",
                              mask_padding=True).enhance(short)
    enhancer = AudioEnhancer(model, config, device=dev, io_dtype="int16", mask_padding=True)
    wavs = [speechlike(int(SECONDS * SR), rng) for _ in range(BATCH)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = enhancer.enhance_batch(wavs)
    launches = kernels.launched()
    print(f"{n_params / 1e6:.2f}M parameters; launches in the batch: {launches}", flush=True)
    if len(out) != BATCH or any(o.shape != w.shape or not np.isfinite(o).all()
                                for o, w in zip(out, wavs)):
        raise AssertionError("full-width output malformed")
    if set(launches) != set(SERVING):
        raise AssertionError(f"a kernel of the path did not run, or another kernel did: "
                             f"{launches}")
    short_err = float(np.abs(enhancer.enhance(short) - ref_short).max())
    print(f"full width 1 s clip cuda vs cpu: max abs err {short_err:.3g} "
          f"(tolerance {TOL_WAVE})", flush=True)
    if short_err > TOL_WAVE:
        raise AssertionError("full-width enhancement differs between cuda and cpu")

    phase("serving: 6 concurrent HTTP requests")
    server = make_server(enhancer, port=0, max_batch=BATCH, max_wait_ms=50.0)
    serve_thread = threading.Thread(target=server.serve_forever, daemon=True)
    serve_thread.start()
    try:
        url = "http://%s:%d" % server.server_address[:2]
        reqs = [speechlike(int(s * SR), rng) for s in (1.0, 1.4, 1.8, 2.2, 2.6, 3.0)]
        results = [None] * len(reqs)
        kernels.reset_launch_counts()

        def post(i):
            r = urllib.request.urlopen(urllib.request.Request(
                f"{url}/enhance", data=wav_bytes(reqs[i], SR, subtype="float32")), timeout=300)
            results[i] = (r.status, read_wav_bytes(r.read(), SR)[0])

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads) or any(r is None or r[0] != 200 for r in results):
            raise AssertionError(f"HTTP requests failed: {[r and r[0] for r in results]}")
        served = kernels.launched()
        stats = json.loads(urllib.request.urlopen(f"{url}/stats", timeout=30).read())
        http_err = max(float(np.abs(r[1] - enhancer.enhance(w)).max())
                       for r, w in zip(results, reqs))
        print(f"served 6 requests in {stats['batches']} batches; max abs err vs direct "
              f"enhance {http_err:.3g}; launches {served}", flush=True)
        if stats["requests"] != 6 or http_err > TOL_WAVE or set(served) != set(SERVING):
            raise AssertionError(f"serving check failed: {stats}, err {http_err}, {served}")
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
        serve_thread.join(timeout=10)

    phase("times")
    n_fresh = 8
    xs = [(torch.randn(BATCH, wav_len, generator=g).to(dev), cfg) for _ in range(n_fresh)]
    qkv = [tuple(torch.randn(BATCH, heads, n_tok, dh, generator=g).to(dev) for _ in range(3))
           for _ in range(n_fresh)]
    mp = [(torch.rand(BATCH, 257, n_frames, generator=g).to(dev),
           (torch.rand(BATCH, 257, n_frames, generator=g) * 6.28 - 3.14).to(dev))
          for _ in range(n_fresh)]
    win = torch.from_numpy(cfg.padded_window()).to(dev)
    key_mask = serve_mask[:, None, None, :]
    timed = {  # name: (kernel, plain version, one-call library yardstick, inputs)
        "stft_mag": (
            cuda_stft.stft_mag, cuda_stft.stft_mag_plain,
            lambda x, c: torch.stft(x, c.n_fft, c.hop_length, window=win, center=True,
                                    pad_mode="reflect", return_complex=True).abs(),
            xs),
        "attention_fwd": (
            lambda q, k, v: cuda_attention.attention(q, k, v, scale=dh**-0.5, mask=serve_mask),
            lambda q, k, v: cuda_attention.attention_plain(q, k, v, scale=dh**-0.5, mask=serve_mask),
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask,
                                                           scale=dh**-0.5),
            qkv),
        "istft_polar": (
            lambda m, p: cuda_stft.istft_polar(m, p, cfg, length=wav_len),
            lambda m, p: cuda_stft.istft_polar_plain(m, p, cfg, length=wav_len),
            lambda m, p: torch.istft(torch.polar(m, p), cfg.n_fft, cfg.hop_length, window=win,
                                     center=True, length=wav_len),
            mp),
    }
    # operations and bytes each function must do and move on these inputs:
    # every input read once, every output written once; attention counts the
    # keys the mask keeps, since a masked key adds nothing to the output
    kept_keys = int(serve_mask.sum())
    fft_work = stft_work(cfg, BATCH, wav_len)
    work = {
        "stft_mag": fft_work["stft"],
        "attention_fwd": (4 * heads * n_tok * dh * kept_keys,
                          4 * 4 * BATCH * heads * n_tok * dh + BATCH * n_tok),
        "istft_polar": fft_work["istft"],
    }
    peaks = {"stft_mag": FP32_PEAK, "attention_fwd": TF32X3_PEAK, "istft_polar": FP32_PEAK}
    ms = {}
    for name, (kern, plain, lib_call, inputs) in timed.items():
        # plain, kernel, library, library, kernel, plain: each one's better median
        p1, k1, l1, l2, k2, p2 = (median_ms(f, inputs)
                                  for f in (plain, kern, lib_call, lib_call, kern, plain))
        flops, nbytes = work[name]
        b_ms, b_by = bound(flops, nbytes, peaks[name])
        ms[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": min(l1, l2),
                    "bound_ms": b_ms, "bound_by": b_by, "device_ms": device_ms(kern, inputs)}
        m = ms[name]
        print(f"{name}: per call {m['ms']:.4f} ms (device {m['device_ms']:.4f}), plain "
              f"{m['plain_ms']:.4f} ms (device {device_ms(plain, inputs):.4f}), library "
              f"{m['library_ms']:.4f} ms (device {device_ms(lib_call, inputs):.4f}); bound "
              f"{b_ms:.4f} ms by {b_by} ({flops / 1e9:.3f} GFLOP at {peaks[name] / 1e12:g} "
              f"TFLOP/s, {nbytes / 1e6:.2f} MB at {HBM_RATE / 1e12:g} TB/s); share of "
              f"bound {b_ms / m['ms']:.1%} per call, {b_ms / m['device_ms']:.1%} on the device; "
              f"device rates {flops / (m['device_ms'] * 1e-3) / 1e12:.2f} TFLOP/s, "
              f"{nbytes / (m['device_ms'] * 1e-3) / 1e12:.2f} TB/s (per call: median of 5 runs "
              f"over {n_fresh} fresh inputs; device: mean over them; {smi})", flush=True)
    # K2 under the length mix's mask (it walks only the kept keys) and with
    # no mask (every key): in turns, each one's better median and device time
    mixed, unmasked = (
        lambda q, k, v, m=m: cuda_attention.attention(q, k, v, scale=dh**-0.5, mask=m)
        for m in (mix_mask, None))
    m1, u1, u2, m2 = (median_ms(f, qkv) for f in (mixed, unmasked, unmasked, mixed))
    print(f"attention_fwd under the length mix's mask ({int(mix_mask.sum())} of "
          f"{BATCH * n_tok} keys kept): per call {min(m1, m2):.4f} ms (device "
          f"{device_ms(mixed, qkv):.4f}); no mask: per call {min(u1, u2):.4f} ms (device "
          f"{device_ms(unmasked, qkv):.4f}); {smi}", flush=True)
    walls = []
    for _ in range(5):
        batch = [speechlike(int(SECONDS * SR), rng) for _ in range(BATCH)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enhancer.enhance_batch(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"slice: enhance_batch of {BATCH} x {SECONDS:g} s PCM16 in {wall * 1e3:.1f} ms "
          f"(median of 5) = {BATCH * SECONDS / wall:.1f} audio-s/s; {smi}", flush=True)
    times = device_times(lambda: enhancer.enhance_batch(batch))
    in_kernels = {name: kernel_ms(times, name) for name in SERVING}
    for name, t in in_kernels.items():
        ms[name]["path_device_ms"] = t / launches[name]
    print(f"slice device time (profiler, one batch): busy {sum(times.values()):.2f} ms; "
          f"hand-written kernels {({n: round(t, 4) for n, t in in_kernels.items()})} ms, per "
          f"launch {({n: round(ms[n]['path_device_ms'], 4) for n in SERVING})} ms; {smi}",
          flush=True)

    opt_run = optimizer_kernels(dev, smi)
    with tempfile.TemporaryDirectory() as kept:
        noisy = Path(kept) / "noisy"
        offline_run = offline(dev, smi, rng, noisy)
        train = training(dev, smi, rng, g)
        shipped_run = shipped(dev, smi, rng)
        mesh_run = mesh(dev, smi, rng, enhancer, wavs, out)
        dsp_run = dsp(dev, smi, rng, noisy, (native_lib, native_build_s))
        export_run = exported(dev, smi, enhancer, wavs, wall * 1e3, dsp_run["round_ms"])
        tools_run = quality_tools(smi)
        bench_run = measurement_tools(smi, noisy)
    geometry_run = geometry(dev, smi, rng, g)
    cmgan_run = cmgan(dev, smi, rng)
    errs["attention_relpos"] = cmgan_run["errs"]
    ms["attention_relpos"] = cmgan_run["ms"]
    errs["add_layer_norm"] = cmgan_run["norm_errs"]
    ms["add_layer_norm"] = cmgan_run["norm_ms"]
    errs["instance_norm"] = cmgan_run["in_errs"]
    ms["instance_norm"] = cmgan_run["in_ms"]
    semamba_run = semamba(dev, smi, rng)
    errs["selective_scan"] = semamba_run["errs"]
    ms["selective_scan"] = semamba_run["ms"]
    errs["conv1d_silu"] = semamba_run["conv_errs"]
    ms["conv1d_silu"] = semamba_run["conv_ms"]
    errs.update(opt_run["errs"])
    ms.update(opt_run["ms"])
    errs["attention_bwd"] = train["errs"]
    ms["attention_bwd"] = train["ms"]
    launches["attention_bwd"] = train["launches"]["attention_bwd"]
    for name, e in geometry_run["errs"].items():
        errs[name] = errs.get(name, []) + e
    for name, e in geometry_run["attention"].items():
        errs[name] = errs[name] + e
    ms.update(geometry_run["ms"])
    # K1's and K3's times at the mixed-radix geometries, K3g's at its other ones
    for geom, by_kernel in geometry_run["fft_ms"].items():
        for name, m in by_kernel.items():
            errs[name].append(m.pop("max_abs_err"))
            ms[name][f"at_{geom}"] = m
    for name, by_geom in geometry_run["dft_others"].items():
        for geom, m in by_geom.items():
            ms[name][f"at_{geom}"] = m

    print(f"chip_smoke.py: {time.perf_counter() - STARTED:.1f} s from start to result (the "
          f"kernels' build included); {smi}", flush=True)
    print(smi)
    # each kernel's launches on each path, 0 where the path did not launch it
    paths = {"launches": launches, "offline_launches": offline_run["launches"],
             "train_launches": train["launches"], "shipped_launches": shipped_run["launches"],
             "remat_train_launches": shipped_run["remat_launches"],
             "mesh_train_launches": mesh_run["train"], "tp_train_launches": mesh_run["tp"],
             "mesh_serve_launches": mesh_run["serve"], "griffin_lim_launches": dsp_run["launches"],
             "exported_launches": export_run["launches"], "tools_launches": tools_run["launches"],
             "bench_launches": bench_run["launches"], "bench_train_launches": bench_run["train"],
             "geometry_serve_launches": geometry_run["serve"],
             "dccrn_serve_launches": geometry_run["dccrn"],
             "geometry_train_launches": geometry_run["train"],
             "geometry_gl_launches": geometry_run["gl"],
             "cmgan_serve_launches": cmgan_run["launches"],
             "semamba_serve_launches": semamba_run["launches"]}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": str(Path(
            "speech_enhancement_via_hybrid_vision_transformer_project_tpu_torch") / k.source),
         "replaces": k.replaces, **{key: run.get(name, 0) for key, run in paths.items()},
         "max_abs_err": max(errs[name]),
         **ms[name]}
        for name, k in kernels.KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
