// K3g istft_dft: polar recombine + windowed inverse real DFT + overlap-add +
// window-sum divide + center crop / length trim for any n_fft and hop, fp32,
// the inverse DFT as a product on the tensor cores.
//
// Replaces the TPU kernel _istft_kernel in
// speech_enhancement_via_hybrid_vision_transformer_project_tpu/ops/pallas_stft.py
// (launched by pallas_istft with polar=True) for the geometries that the
// FFT kernel K3 (istft.cu) does not take: an n_fft that is not a power of
// two in [128, 2048], a hop that does not divide n_fft or is not a multiple
// of 4. Like the TPU kernel it computes each frame as re @ Wa + im @ Wb
// against the window-folded inverse DFT matrices (ops/stft.py:
// inv_window_dft), in 3xTF32 mma.sync (tf32_mma.cuh) to fp32 accuracy.
//
// What bounds it on an H100. The function needs only its bytes: at the
// serving batch at 400/100 (32 x 512 frames, F = 201) it reads mag and
// phase (26 MB) and writes the output (6.5 MB), 10 us at 3.35 TB/s. This
// design does the dense product, 2 * 16384 * 402 * 400 = 5.27 GFLOP, 32 us
// at the 165 TFLOP/s of 3xTF32, so its own floor is the operations. The frames pass through a scratch in
// device memory (26 MB written, read back mostly from L2).
//
// Design, two kernels on one stream:
// 1. istft_dft_frames_kernel: one block per (64 frames, 64 frame samples,
//    batch row), 128 threads as 2 x 2 warps of 32 x 32. Each step takes 16
//    bins: a thread loads 8 (mag, phase) pairs of the bins-first inputs (a
//    warp reads runs of consecutive frames of one bin) before the product of
//    the previous step, then forms re and im with IEEE sincosf into the next
//    shared-memory stage, stored [bin][frame]. B tiles come from the
//    wrapper's copy of Wa and Wb cut into column tiles of 64 samples, each
//    [k_pad, 128] (Wa's 64 columns, then Wb's; zero past F and past n_fft),
//    by 16-byte cp.async. The frames go to the scratch [B, N, n_fft].
// 2. istft_dft_ola_kernel: overlap-add by gather, one thread per output
//    sample: sample s sums the frames t with t*hop <= s < t*hop + n_fft
//    (at most ceil(n_fft / hop) of them), for any hop, so the output is
//    deterministic and needs no atomics; then the window-sum divide, and the
//    crop and trim: y[j] is overlap-added sample offset + j, zero past the
//    overlap-added signal.
// The wrapper (ops/cuda_stft.py) builds the B layout and passes its tile
// width and depth; the entry refuses a launch where they are not BN and BK.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BM = 64;          // frames a block
constexpr int BN = 64;          // frame samples a block
constexpr int BK = 16;          // bins a step: a re row and an im row each
constexpr int AS = BM + 8;      // A stored [bin][frame]: conflict-free fragment reads
constexpr int BS = 2 * BN + 8;  // B row stride: the same
constexpr int LOADS = BK * BM / THREADS;  // (mag, phase) pairs a thread a step
constexpr int OLA_THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    istft_dft_frames_kernel(const float* __restrict__ mag,    // [B, F, N]
                            const float* __restrict__ phase,  // [B, F, N]
                            const float* __restrict__ w,      // [n_ct][k_pad][2 * BN]
                            float* __restrict__ frames,       // [B, N, n_fft]
                            int n_frames, int n_fft, int n_bins, int k_pad) {
  __shared__ __align__(16) float as[2][2][BK * AS];  // [stage][re, im][bin][frame]
  __shared__ __align__(16) float bs[2][BK * BS];     // [stage][bin][Wa | Wb]

  const int t0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const long plane = static_cast<long>(n_bins) * n_frames;
  const float* magb = mag + b * plane;
  const float* phb = phase + b * plane;
  const float* wt = w + static_cast<long>(blockIdx.y) * k_pad * (2 * BN);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;

  float mv[LOADS], pv[LOADS];
  auto load_a = [&](int k0) {  // global -> registers, all loads in flight
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int k = k0 + i / BM, f = t0 + i % BM;
      const bool in = k < n_bins && f < n_frames;
      const long at = static_cast<long>(k) * n_frames + f;
      mv[u] = in ? __ldg(magb + at) : 0.f;
      pv[u] = in ? __ldg(phb + at) : 0.f;
    }
  };
  auto store_a = [&](int stage) {  // polar recombine into shared memory
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      float s, c;
      sincosf(pv[u], &s, &c);
      as[stage][0][(i / BM) * AS + i % BM] = mv[u] * c;
      as[stage][1][(i / BM) * AS + i % BM] = mv[u] * s;
    }
  };
  auto load_b = [&](int stage, int k0) {
    const float* src = wt + static_cast<long>(k0) * (2 * BN);
    for (int i = threadIdx.x; i < BK * (2 * BN / 4); i += THREADS) {
      const int r = i / (2 * BN / 4), c = (i % (2 * BN / 4)) * 4;
      cp_async16(&bs[stage][r * BS + c], src + r * (2 * BN) + c, true);
    }
    cp_async_commit();
  };

  float acc[2][4][4] = {};  // [m tile][n tile][fragment]
  const int steps = k_pad / BK;
  load_a(0);
  store_a(0);
  load_b(0, 0);
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    cp_async_wait<0>();
    __syncthreads();  // stage cur is complete; every warp is done with the other
    const bool more = s + 1 < steps;
    if (more) {
      load_b(cur ^ 1, (s + 1) * BK);
      load_a((s + 1) * BK);
    }
#pragma unroll
    for (int part = 0; part < 2; ++part) {  // re rows against Wa, im rows against Wb
      const float* a = as[cur][part];
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* ar = a + (kk + t) * AS + wm * 32 + mt * 16 + g;
          split(ar[0], ah[mt][0], al[mt][0]);           // (frame g, bin t)
          split(ar[8], ah[mt][1], al[mt][1]);           // (g + 8, t)
          split(ar[4 * AS], ah[mt][2], al[mt][2]);      // (g, t + 4)
          split(ar[4 * AS + 8], ah[mt][3], al[mt][3]);  // (g + 8, t + 4)
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* br = &bs[cur][(kk + t) * BS + part * BN + wn * 32 + nt * 8 + g];
          uint32_t bh0, bl0, bh1, bl1;
          split(br[0], bh0, bl0);
          split(br[4 * BS], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma(acc[mt][nt], al[mt], bh0, bh1);
            mma(acc[mt][nt], ah[mt], bl0, bl1);
            mma(acc[mt][nt], ah[mt], bh0, bh1);
          }
        }
      }
    }
    if (more) store_a(cur ^ 1);
  }

  float* fb = frames + static_cast<long>(b) * n_frames * n_fft;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = t0 + wm * 32 + mt * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn * 32 + nt * 8 + 2 * t + (e & 1);
        if (f < n_frames && n < n_fft) fb[static_cast<long>(f) * n_fft + n] = acc[mt][nt][e];
      }
    }
  }
}

__global__ void __launch_bounds__(OLA_THREADS)
    istft_dft_ola_kernel(const float* __restrict__ frames,  // [B, N, n_fft]
                         const float* __restrict__ denom,   // [ola_len]
                         float* __restrict__ y,             // [B, out_samples]
                         int n_frames, int n_fft, int hop, int offset, int out_samples) {
  const long j = static_cast<long>(blockIdx.x) * OLA_THREADS + threadIdx.x;
  if (j >= out_samples) return;
  const int b = blockIdx.y;
  const long s = j + offset;  // overlap-added sample
  const long ola_len = static_cast<long>(n_fft) + static_cast<long>(n_frames - 1) * hop;
  float v = 0.f;
  if (s < ola_len) {
    const float* fb = frames + static_cast<long>(b) * n_frames * n_fft;
    const long hi = s / hop < n_frames ? s / hop : n_frames - 1;
    const long lo = s >= n_fft ? (s - n_fft) / hop + 1 : 0;
    for (long f = hi; f >= lo; --f) v += fb[f * n_fft + (s - f * hop)];
    v = v / denom[s];
  }
  y[static_cast<long>(b) * out_samples + j] = v;
}

}  // namespace

// mag/phase: [batch, F, n_frames], F = n_fft/2 + 1; w: Wa and Wb cut into
// ceil(n_fft / 64) column tiles of [k_pad, 128] (ops/cuda_stft.py:
// idft_tiles), k_pad = F rounded up to 16; denom: [n_fft + (n_frames-1)*hop]
// window sums (tiny -> 1); frames: [batch, n_frames, n_fft] scratch; y:
// [batch, out_samples] = overlap-added samples [offset, offset +
// out_samples) divided by denom, zeros past the end. tile_samples and
// tile_depth: the layout of w, which must be BN and BK (else
// cudaErrorInvalidValue, before a launch). batch <= 65535; the wrapper checks.
extern "C" int sevit_istft_dft(const float* mag, const float* phase, const float* w,
                               const float* denom, float* frames, float* y, int batch,
                               int n_frames, int n_fft, int hop, int offset, int out_samples,
                               int tile_samples, int tile_depth, void* stream) {
  if (tile_samples != BN || tile_depth != BK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_bins = n_fft / 2 + 1;
  const int k_pad = (n_bins + BK - 1) / BK * BK;
  const dim3 grid((n_frames + BM - 1) / BM, (n_fft + BN - 1) / BN, batch);
  istft_dft_frames_kernel<<<grid, THREADS, 0, s>>>(mag, phase, w, frames, n_frames, n_fft,
                                                   n_bins, k_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 ola((out_samples + OLA_THREADS - 1) / OLA_THREADS, batch);
  istft_dft_ola_kernel<<<ola, OLA_THREADS, 0, s>>>(frames, denom, y, n_frames, n_fft, hop,
                                                   offset, out_samples);
  return static_cast<int>(cudaGetLastError());
}
