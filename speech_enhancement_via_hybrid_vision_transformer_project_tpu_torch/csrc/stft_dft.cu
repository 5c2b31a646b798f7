// K1g stft_dft: reflect or zero padding + framing + window + real DFT +
// magnitude for any n_fft and hop, fp32, as a product on the tensor cores.
//
// Replaces the TPU kernel _stft_kernel in
// speech_enhancement_via_hybrid_vision_transformer_project_tpu/ops/pallas_stft.py
// (launched by pallas_stft) for the geometries that the FFT kernel K1
// (stft.cu) does not take: an n_fft that is not a power of two in
// [128, 2048] (400, 320, 4096), a hop that is not a multiple of 4, or
// pad_mode "constant". Like the TPU kernel it computes each frame's
// spectrum as a product against the window-folded DFT matrix
// [n_fft, 2F] (ops/stft.py:window_dft), in 3xTF32 mma.sync
// (tf32_mma.cuh) to fp32 accuracy, as Pallas' Precision.HIGHEST.
//
// What bounds it on an H100. The function needs only its bytes: at the
// 16 kHz serving batch at n_fft 400 / hop 100 (32 rows x 51100 samples, 512
// frames, F = 201) it reads 6.5 MB and writes 39.5 MB, 14 us at 3.35 TB/s;
// an FFT's operations take a fraction of that. This design does the dense
// product instead, 2 * 16384 * 400 * 402 = 5.27 GFLOP, 32 us at the
// 165 TFLOP/s of 3xTF32, so its own floor is the operations. It keeps the
// tensor cores fed from shared memory and never writes the frame matrix.
//
// Design: one block per (tile of BM = 64 frames, tile of BN = 32 bins, batch
// row), 128 threads as 2 x 2 warps, each warp 32 frames x 16 bins of both
// the re and the im columns, so that one thread holds re and im of the same
// (frame, bin) and forms the magnitude in the epilogue.
// - A (frames x samples) tiles of BK = 32 samples are gathered straight
//   from x [B, L] by cp.async, one float at a time: sample t*hop + n - pad
//   of row b, reflected at both ends (reflect) or zero outside the signal
//   (constant). Frame and sample tails are zero-filled. A tile whose
//   frames lie inside the signal (all but the first and last of a row) is
//   copied 16 bytes at a time where hop, pad and n_fft are multiples of 4.
// - B tiles come from the wrapper's copy of window_dft cut into column
//   tiles of 32 bins, each [k_pad, 64] (the tile's 32 re columns, then its
//   32 im columns, zero past F and past n_fft): contiguous 16-byte
//   cp.async copies. The matrix is streamed (67 MB at n_fft 4096).
// - Two shared-memory stages: the next tile loads while the tensor cores
//   work on this one.
// - The epilogue stages re, im and mag [bins][frames] in shared memory and
//   stores them bins-first, [B, F, N], in runs of 64 frames.
// The wrapper (ops/cuda_stft.py) builds the B layout and passes its tile
// width and depth; the entry refuses a launch where they are not BN and BK.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BM = 64;          // frames a block
constexpr int BN = 32;          // bins a block: 2 * BN columns of B
constexpr int BK = 32;          // samples a step
constexpr int AS = BK + 4;      // A row stride: conflict-free fragment reads
constexpr int BS = 2 * BN + 8;  // B row stride: the same
constexpr int OS = BM + 4;      // epilogue row stride ([bin][frame])
constexpr int SMEM = 2 * BM * AS + 2 * BK * BS;
static_assert(3 * BN * OS <= SMEM, "the epilogue reuses the stages");

__global__ void __launch_bounds__(THREADS)
    stft_dft_kernel(const float* __restrict__ x,  // [B, length]
                    const float* __restrict__ w,  // [n_bt][k_pad][2 * BN]
                    float* __restrict__ re,       // [B, F, N]
                    float* __restrict__ im, float* __restrict__ mag, int length, int pad,
                    int reflect, int n_frames, int n_fft, int hop, int n_bins, int k_pad) {
  __shared__ __align__(16) float smem[SMEM];
  float* as = smem;               // [2][BM][AS]
  float* bs = smem + 2 * BM * AS;  // [2][BK][BS]

  const int t0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const float* xb = x + static_cast<long>(b) * length;
  const float* wt = w + static_cast<long>(blockIdx.y) * k_pad * (2 * BN);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;

  // a tile whose frames lie inside the signal, at 16-byte aligned samples,
  // is copied 4 samples at a time; the others one sample at a time, with
  // the padding's reflection or zeros
  const int f_last = min(t0 + BM, n_frames) - 1;
  const bool inside = ((hop | pad | n_fft) & 3) == 0 &&
                      (reinterpret_cast<uintptr_t>(xb) & 15) == 0 &&
                      static_cast<long>(t0) * hop >= pad &&
                      static_cast<long>(f_last) * hop + n_fft - pad <= length;

  auto load = [&](int stage, int k0) {
    float* a = as + stage * BM * AS;
    if (inside) {
      for (int i = threadIdx.x; i < BM * BK / 4; i += THREADS) {
        const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
        const int f = t0 + r, n = k0 + c;
        const bool in = f <= f_last && n < n_fft;
        cp_async16(a + r * AS + c, in ? xb + static_cast<long>(f) * hop + n - pad : xb, in);
      }
    }
    for (int i = threadIdx.x; i < (inside ? 0 : BM * BK); i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int f = t0 + r, n = k0 + c;
      long j = static_cast<long>(f) * hop + n - pad;  // sample of the unpadded signal
      bool in = f < n_frames && n < n_fft;
      if (j < 0) {
        in = in && reflect;
        j = -j;
      } else if (j >= length) {
        in = in && reflect;
        j = 2L * (length - 1) - j;
      }
      cp_async4(a + r * AS + c, in ? xb + j : xb, in);
    }
    float* bt = bs + stage * BK * BS;
    const float* src = wt + static_cast<long>(k0) * (2 * BN);
    for (int i = threadIdx.x; i < BK * (2 * BN / 4); i += THREADS) {
      const int r = i / (2 * BN / 4), c = (i % (2 * BN / 4)) * 4;
      cp_async16(bt + r * BS + c, src + r * (2 * BN) + c, true);
    }
    cp_async_commit();
  };

  // [m tile][re, im][n tile][fragment]. The tensor cores' fp32 adds do not
  // round to nearest, so their error grows with the sum's length and size
  // (one accumulator over n_fft 4096 missed K1's limit against the plain
  // version): each step's BK products are summed on the tensor cores from
  // zero and added to acc in IEEE arithmetic. chip_smoke.py phase 16 holds
  // K1g and the plain version against a float64 product at n_fft 4096.
  float acc[2][2][2][4] = {};
  const int steps = k_pad / BK;
  load(0, 0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // stage s & 1 has landed; every warp is done with the other
    if (s + 1 < steps) load((s + 1) & 1, (s + 1) * BK);
    const float* a = as + (s & 1) * BM * AS;
    const float* bt = bs + (s & 1) * BK * BS;
    float step[2][2][2][4] = {};
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ar = a + (wm * 32 + mt * 16 + g) * AS + kk + t;
        split(ar[0], ah[mt][0], al[mt][0]);
        split(ar[8 * AS], ah[mt][1], al[mt][1]);
        split(ar[4], ah[mt][2], al[mt][2]);
        split(ar[8 * AS + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int part = 0; part < 2; ++part) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* br = bt + (kk + t) * BS + part * BN + wn * 16 + nt * 8 + g;
          uint32_t bh0, bl0, bh1, bl1;
          split(br[0], bh0, bl0);
          split(br[4 * BS], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma(step[mt][part][nt], al[mt], bh0, bh1);
            mma(step[mt][part][nt], ah[mt], bl0, bl1);
            mma(step[mt][part][nt], ah[mt], bh0, bh1);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) (&acc[0][0][0][0])[i] += (&step[0][0][0][0])[i];
  }
  __syncthreads();  // the stages become the epilogue's [3][BN][OS]

  float* o = smem;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wm * 32 + mt * 16 + g + (e >> 1) * 8;  // frame
        const int col = wn * 16 + nt * 8 + 2 * t + (e & 1);    // bin
        const float xr = acc[mt][0][nt][e], xi = acc[mt][1][nt][e];
        o[col * OS + row] = xr;
        o[(BN + col) * OS + row] = xi;
        o[(2 * BN + col) * OS + row] = sqrtf(xr * xr + xi * xi);
      }
    }
  }
  __syncthreads();
  const long plane = static_cast<long>(n_bins) * n_frames;
  for (int i = threadIdx.x; i < 3 * BN * BM; i += THREADS) {
    const int which = i / (BN * BM);
    const int col = (i / BM) % BN, row = i % BM;
    if (f0 + col >= n_bins || t0 + row >= n_frames) continue;
    float* out = which == 0 ? re : which == 1 ? im : mag;
    out[b * plane + static_cast<long>(f0 + col) * n_frames + t0 + row] =
        o[(which * BN + col) * OS + row];
  }
}

}  // namespace

// x: signal [batch, length] (not padded); w: window_dft cut into
// ceil(F / 32) column tiles of [k_pad, 64] (ops/cuda_stft.py:dft_tiles),
// k_pad = n_fft rounded up to 32; re/im/mag: [batch, F, n_frames] with
// F = n_fft/2 + 1. pad: center padding per side (0 or n_fft/2); reflect: 1
// to reflect at the ends (needs pad < length), 0 for zeros. tile_bins and
// tile_depth: the layout of w, which must be BN and BK (else
// cudaErrorInvalidValue, before a launch). batch <= 65535; the wrapper checks.
extern "C" int sevit_stft_dft(const float* x, const float* w, float* re, float* im,
                              float* mag, int batch, int length, int pad, int reflect,
                              int n_frames, int n_fft, int hop, int tile_bins, int tile_depth,
                              void* stream) {
  if (tile_bins != BN || tile_depth != BK) return static_cast<int>(cudaErrorInvalidValue);
  const int n_bins = n_fft / 2 + 1;
  const int k_pad = (n_fft + BK - 1) / BK * BK;
  const dim3 grid((n_frames + BM - 1) / BM, (n_bins + BN - 1) / BN, batch);
  stft_dft_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, re, im, mag, length, pad, reflect, n_frames, n_fft, hop, n_bins, k_pad);
  return static_cast<int>(cudaGetLastError());
}
