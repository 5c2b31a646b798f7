// K1 stft_mag: center padding (reflect or zeros) + framing + window + real FFT +
// magnitude, fp32, in one pass.
//
// Replaces the TPU kernel _stft_kernel in
// speech_enhancement_via_hybrid_vision_transformer_project_tpu/ops/pallas_stft.py
// (launched by pallas_stft). That kernel computes each frame's spectrum as
// a DFT matmul against a window-folded [n_fft, 2F] matrix, which suits the
// TPU's matrix unit: ~260K FMAs a frame at n_fft 512. The function is the
// same here; the algorithm is not.
//
// What bounds it on an H100: bytes. At batch 32 x 49024 samples it reads
// 6.3 MB and writes re, im and mag, 3 x 12.6 MB bins-first ([B, F, N]);
// 44 MB at 3.35 TB/s is 13 us. An FFT needs ~0.16 GFLOP, 2.4 us at the
// 67 TFLOP/s fp32 peak; the DFT matmul needed 6.5 GFLOP, 97 us. So the
// design does an FFT and spends its care on the loads and stores. PERF.md
// has its measured share of the bound.
//
// Design: one block per (batch row, tile of `tile` frames), 256 threads.
// - Loads: the tile's signal span, (tile-1)*hop + n_fft samples, goes to
//   shared memory in 16-byte loads when it lies inside the signal (its
//   last span_len % 4 samples one by one). The center padding is fused:
//   near the ends the kernel reads the unpadded
//   signal at reflected indices (or reads zeros, under zero padding), so
//   the padded copy is never written. The wrapper pads rows that one
//   reflection cannot, and numpy's other pad modes, itself and launches
//   with pad 0. Overlapping frames are only addresses.
// - Transform: each frame's 512 windowed samples are read as 256 complex
//   points z[m] = x[2m] + i x[2m+1] straight from the span by the first
//   FFT stage (window applied as they are read), and the 256-point complex
//   FFT runs as two radix-16 Stockham stages in shared memory
//   (fft_stages.cuh; at n_fft 400 the 200 points take radix 8, 5 and 5).
//   An untangle step gives bins 0..256, two per thread:
//   with Fe = (Z[k] + conj Z[M-k]) / 2 and Fo = (Z[k] - conj Z[M-k]) / 2i,
//   X[k] = Fe + W_N^k Fo and X[M-k] = conj(Fe - W_N^k Fo). Twiddles,
//   untangle factors and window come from one small table built in float64
//   on the host and rounded to fp32 (no __sinf, no fast-math).
// - Stores: thread i takes bins k and M-k (k = i / tile) of frame i % tile,
//   so a warp writes runs of `tile` consecutive frames of each bin for re,
//   im and sqrtf(re^2 + im^2) (IEEE): the shared-memory buffer is read
//   transposed, conflict-free thanks to its odd row stride.
// Any even n_fft in [128, 2048] whose n_fft/2 = 2^a 3^b 5^c has a radix
// plan (fft_stages.cuh), with hop % 4 == 0 and hop <= n_fft; the wrapper
// (ops/cuda_stft.py) checks, makes the plan and picks `tile`, a power of
// two (16 at n_fft 512 and 400: at most 4096 points per buffer and 32
// frames).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fft_stages.cuh"

namespace {

constexpr int THREADS = 256;

template <bool POW2>  // n_fft / 2 a power of two
__global__ void __launch_bounds__(THREADS)
    stft_mag_kernel(const float* __restrict__ x,     // [B, length]
                    const float* __restrict__ plan,  // twiddles, untangle, window
                    float* __restrict__ re,          // [B, F, N]
                    float* __restrict__ im, float* __restrict__ mag, int length,
                    int pad, int reflect, int n_frames, int n_fft, int hop, int tile,
                    int radices) {
  extern __shared__ float4 smem4[];
  const int m_pts = n_fft >> 1;
  const int rs = fft_row_stride(m_pts);
  const int span_len = (tile - 1) * hop + n_fft;  // even; 2 mod 4 where M is odd
  float2* buf = reinterpret_cast<float2*>(smem4);  // [tile][rs], the FFT
  float* span = reinterpret_cast<float*>(buf + ((tile * rs + 1) & ~1));  // 16-byte aligned
  float2* tw = reinterpret_cast<float2*>(span + span_len);  // [M]  exp(-2 pi i k / M)
  float2* ut = tw + m_pts;         // [M + 1]  exp(-2 pi i k / n_fft)
  float* win = reinterpret_cast<float*>(ut + m_pts + 1);  // [n_fft]

  for (int i = threadIdx.x; i < 3 * n_fft + 2; i += blockDim.x) {
    reinterpret_cast<float*>(tw)[i] = __ldg(plan + i);
  }

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile;
  const long j0 = static_cast<long>(t0) * hop - pad;  // signal index of span[0]
  const float* xb = x + static_cast<long>(b) * length;
  if (j0 >= 0 && j0 + span_len <= length &&
      (reinterpret_cast<uintptr_t>(xb + j0) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(xb + j0);
    float4* dst = reinterpret_cast<float4*>(span);
    for (int i = threadIdx.x; i < span_len / 4; i += blockDim.x) dst[i] = __ldg(src + i);
    // the last span_len % 4 samples (two where n_fft % 4 == 2), one by one
    const int tail = span_len & ~3;
    if (tail + static_cast<int>(threadIdx.x) < span_len) {
      span[tail + threadIdx.x] = __ldg(xb + j0 + tail + threadIdx.x);
    }
  } else {
    for (int i = threadIdx.x; i < span_len; i += blockDim.x) {
      long j = j0 + i;
      if (j >= static_cast<long>(length) + pad) {
        j = -1;  // past the padded signal: frames that are not stored
      } else if (j < 0) {
        j = reflect ? -j : -1;
      } else if (j >= length) {
        j = reflect ? 2L * (length - 1) - j : -1;
      }
      span[i] = j >= 0 ? __ldg(xb + j) : 0.f;
    }
  }
  __syncthreads();

  // the first stage reads the windowed frames packed as complex points:
  // z[t][m] = (x[2m] w[2m], x[2m+1] w[2m+1])
  stockham_fft<false, false, POW2>(
      [span, win, hop](int t, int m) {
        const float2 s = *reinterpret_cast<const float2*>(span + t * hop + 2 * m);
        const float2 w = *reinterpret_cast<const float2*>(win + 2 * m);
        return make_float2(s.x * w.x, s.y * w.y);
      },
      buf, tw, tile, m_pts, radices, rs);
  const float2* z = buf;

  // untangle into bins 0..M, two at a time: with Fe, Fo the even and odd
  // parts of bin k, X[k] = Fe + W^k Fo and X[M-k] = conj(Fe - W^k Fo).
  // Magnitude, and bins-first stores in runs of frames.
  const int log2t = __ffs(tile) - 1;
  const int n_bins = m_pts + 1;
  const int nt = min(tile, n_frames - t0);
  const long row = static_cast<long>(b) * n_bins * n_frames + t0;
  for (int i = threadIdx.x; i < ((m_pts / 2 + 1) << log2t); i += blockDim.x) {
    const int k = i >> log2t;
    const int t = i & (tile - 1);
    if (t >= nt) continue;
    const float2 zk = z[t * rs + pad16(k)];
    const float2 zm = z[t * rs + pad16(k ? m_pts - k : 0)];
    const float er = 0.5f * (zk.x + zm.x), ei = 0.5f * (zk.y - zm.y);  // even part
    const float orr = 0.5f * (zk.y + zm.y), oi = -0.5f * (zk.x - zm.x);  // odd part
    const float2 w = ut[k];
    const float wr = w.x * orr - w.y * oi, wi = w.x * oi + w.y * orr;  // W^k Fo
    const float xr = er + wr, xi = ei + wi;
    long at = row + static_cast<long>(k) * n_frames + t;
    re[at] = xr;
    im[at] = xi;
    mag[at] = sqrtf(xr * xr + xi * xi);
    if (2 * k != m_pts) {
      const float yr = er - wr, yi = wi - ei;
      at = row + static_cast<long>(m_pts - k) * n_frames + t;
      re[at] = yr;
      im[at] = yi;
      mag[at] = sqrtf(yr * yr + yi * yi);
    }
  }
}

}  // namespace

// x: signal [batch, length] (not padded); plan: 3 * n_fft + 2 floats
// (ops/cuda_stft.py:fft_plan); re/im/mag: [batch, n_fft/2 + 1, n_frames].
// pad: center padding per side (0 or n_fft/2), reflect (needs pad < length)
// or zeros; radices: the FFT's radix plan (fft_stages.cuh), checked here.
// Needs an even n_fft in [128, 2048], hop % 4 == 0, hop <= n_fft and a
// power-of-two tile; the wrapper checks.
extern "C" int sevit_stft_mag(const float* x, const float* plan, float* re,
                              float* im, float* mag, int batch, int length,
                              int pad, int reflect, int n_frames, int n_fft, int hop,
                              int tile, int radices, void* stream) {
  const int m = n_fft / 2;
  if (!fft_plan_ok(m, radices, THREADS)) return static_cast<int>(cudaErrorInvalidValue);
  const bool pow2 = (m & (m - 1)) == 0;
  const size_t buf = (static_cast<size_t>(tile) * fft_row_stride(n_fft / 2) + 1) & ~size_t{1};
  const size_t span = static_cast<size_t>(tile - 1) * hop + n_fft;
  const size_t smem = sizeof(float2) * buf + sizeof(float) * (span + 3 * n_fft + 2);
  auto kernel = pow2 ? stft_mag_kernel<true> : stft_mag_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n_frames + tile - 1) / tile, batch);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, plan, re, im, mag, length, pad, reflect, n_frames, n_fft, hop, tile, radices);
  return static_cast<int>(cudaGetLastError());
}
