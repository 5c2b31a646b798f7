// K3 istft_polar: polar recombine + inverse real FFT + synthesis window +
// overlap-add + window-sum divide + center crop / length trim, fp32.
//
// Replaces the TPU kernel _istft_kernel in
// speech_enhancement_via_hybrid_vision_transformer_project_tpu/ops/pallas_stft.py
// (launched by pallas_istft with polar=True). That kernel does each frame's
// inverse as a DFT matmul on the TPU's matrix unit, walks 128-frame blocks
// in order and carries the (r-1)-hop overlap into the next block in scratch
// memory (r = n_fft / hop).
//
// What bounds it on an H100: bytes. At batch 32 x 384 frames it reads mag
// and phase, 2 x 12.6 MB, and writes 6.3 MB: 9 us at 3.35 TB/s. The
// inverse FFTs need ~0.16 GFLOP (2.4 us at the fp32 peak); the DFT matmul
// needed ~7 GFLOP. So the design does an FFT and keeps the loads coalesced.
// On the card the FFT kernel still issues more instructions per byte than
// the memory needs (sincosf per bin, the recomputed halo, the FFT passes):
// PERF.md has its measured share of the bound.
//
// Design: one block per (batch row, tile of `tile` frames), 256 threads,
// four blocks per SM. Blocks run in no order, so each recomputes the r-1
// frames of its left halo instead of carrying them: the block owns
// tile - (r-1) output hops, nothing is accumulated across blocks, no
// atomics, deterministic output.
// - Loads: thread i takes bin i / tile of frame i % tile, so a warp reads
//   runs of consecutive frames of one bin of the bins-first [B, F, N] mag
//   and phase, 8 pairs in flight per thread before any arithmetic, and
//   forms X = mag (cos, sin)(phase) with IEEE sincosf. The imaginary parts
//   of bins 0 and n_fft/2 are dropped, as irfft does.
// - Transform: a Hermitian pack turns the 257 bins into 256 complex points
//   Z[k] = Fe[k] + i Fo[k], Fe = (X[k] + conj X[M-k]) / 2,
//   Fo = (X[k] - conj X[M-k]) / 2 * W_N^-k, computed as the first FFT stage
//   reads its inputs; the 256-point inverse FFT runs as two radix-16
//   Stockham stages in shared memory (fft_stages.cuh; at n_fft 400 radix 8,
//   5 and 5), and z[m] holds samples 2m and 2m+1 of the frame (the unpack
//   is free). The table and the radix plan are K1's.
// - Overlap-add: a gather, not a scatter. Output sample i of the tile sums
//   the r frames that cover it, each times the synthesis window, in shared
//   memory; then the divide by M times the window sum, the center crop and
//   the length trim (zeros past the signal) are fused into one coalesced
//   store. M times the window sum is exact where M is a power of two, so
//   there the divide rounds once, as a scale by 1/M and a divide did.
// Any n_fft that K1 takes, with hop % 4 == 0 and hop | n_fft; the wrapper
// (ops/cuda_stft.py) checks, makes the plan and picks `tile`, a power of
// two >= 2r (16 at n_fft 512, hop 128: 13 output hops per block).

#include <cuda_runtime.h>
#include <math.h>

#include "fft_stages.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LOADS = 8;  // mag/phase pairs in flight per thread
// 64 registers a thread, so that four blocks fit on an SM: their shared
// memory would allow five, and without the cap the compiler takes 75
constexpr int BLOCKS_PER_SM = 4;

template <bool POW2>  // n_fft / 2, and so the hop, a power of two
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    istft_polar_kernel(const float* __restrict__ mag,    // [B, F, N]
                       const float* __restrict__ phase,  // [B, F, N]
                       const float* __restrict__ plan,   // twiddles, untangle, window
                       const float* __restrict__ denom,  // [ola_len]
                       float* __restrict__ y,            // [B, out_samples]
                       int n_frames, int n_fft, int hop, int offset,
                       int out_samples, int tile, int radices) {
  extern __shared__ float4 smem4[];
  const int m_pts = n_fft >> 1;
  const int rs = fft_row_stride(m_pts);
  const int n_bins = m_pts + 1;
  float2* buf = reinterpret_cast<float2*>(smem4);  // [tile][rs]: bins, then the FFT
  float2* tw = buf + ((tile * rs + 1) & ~1);  // [M]      exp(-2 pi i k / M)
  float2* ut = tw + m_pts;                    // [M + 1]  exp(-2 pi i k / n_fft)
  const float* win = reinterpret_cast<const float*>(ut + m_pts + 1);  // [n_fft]

  for (int i = threadIdx.x; i < 3 * n_fft + 2; i += blockDim.x) {
    reinterpret_cast<float*>(tw)[i] = __ldg(plan + i);
  }

  const int r = n_fft / hop;
  const int tm = tile - (r - 1);   // output hops owned by the block
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * tm;  // first output hop of the tile
  const int f0 = m0 - (r - 1);     // first frame (the halo may start < 0)

  // polar recombine, frames of one bin along a warp; LOADS elements a
  // thread at a time, all loads issued before the first sincosf
  const long plane = static_cast<long>(n_bins) * n_frames;
  const float* magb = mag + b * plane;
  const float* phb = phase + b * plane;
  const int log2t = __ffs(tile) - 1;
  const int n_in = n_bins << log2t;
  for (int i0 = threadIdx.x; i0 < n_in; i0 += LOADS * THREADS) {
    float mv[LOADS], pv[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * THREADS;
      const int f = f0 + (i & (tile - 1));
      mv[u] = 0.f;  // frames outside the signal, and the tail: zeros
      pv[u] = 0.f;
      if (i < n_in && f >= 0 && f < n_frames) {
        const long at = static_cast<long>(i >> log2t) * n_frames + f;
        mv[u] = __ldg(magb + at);
        pv[u] = __ldg(phb + at);
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= n_in) break;
      const int k = i >> log2t;
      float s, c;
      sincosf(pv[u], &s, &c);
      buf[(i & (tile - 1)) * rs + k] =
          make_float2(mv[u] * c, (k == 0 || k == m_pts) ? 0.f : mv[u] * s);
    }
  }
  __syncthreads();

  // the first stage reads the Hermitian pack Z[k] = Fe[k] + i Fo[k] of
  // the bins X (plain rows of buf) and writes the same buffer
  stockham_fft<true, true, POW2>(
      [buf, ut, rs, m_pts](int t, int k) {
        const float2 xk = buf[t * rs + k];
        const float2 xm = buf[t * rs + m_pts - k];
        const float er = 0.5f * (xk.x + xm.x), ei = 0.5f * (xk.y - xm.y);
        const float dr = 0.5f * (xk.x - xm.x), di = 0.5f * (xk.y + xm.y);
        const float2 w = ut[k];  // used conjugated: W_N^-k
        const float orr = dr * w.x + di * w.y, oi = di * w.x - dr * w.y;
        return make_float2(er - oi, ei + orr);
      },
      buf, tw, tile, m_pts, radices, rs);
  const float2* z = buf;

  // overlap-add by gather, window-sum divide, crop, trim
  const float fm = static_cast<float>(m_pts);
  const long ola_len = static_cast<long>(n_fft) + static_cast<long>(n_frames - 1) * hop;
  float* yb = y + static_cast<long>(b) * out_samples;
  const Divisor<POW2> hd(hop);
  for (int i = threadIdx.x; i < tm * hop; i += blockDim.x) {
    const int mm = hd.div(i);
    const int col = hd.mod(i);
    const long s = static_cast<long>(m0 + mm) * hop + col;  // overlap-added sample
    const long j = s - offset;                                // output sample
    if (j < 0 || j >= out_samples) continue;
    float v = 0.f;
    if (s < ola_len) {
      for (int p = 0; p < r; ++p) {
        const int n = p * hop + col;
        const float2 zz = z[(mm + r - 1 - p) * rs + pad16(n >> 1)];  // samples n & ~1, n | 1
        v = fmaf((n & 1) ? zz.y : zz.x, win[n], v);
      }
      v = v / (fm * denom[s]);
    }
    yb[j] = v;
  }
}

}  // namespace

// mag/phase: [batch, n_fft/2 + 1, n_frames]; plan: 3 * n_fft + 2 floats
// (ops/cuda_stft.py:fft_plan); denom: [n_fft + (n_frames-1)*hop] window
// sums (tiny -> 1); y: [batch, out_samples] = overlap-added samples
// [offset, offset + out_samples) divided by denom, zeros past the end.
// radices: the FFT's radix plan (fft_stages.cuh), checked here. Needs an
// even n_fft in [128, 2048], hop | n_fft and n_fft / hop <= tile, a power
// of two; the wrapper checks.
extern "C" int sevit_istft_polar(const float* mag, const float* phase,
                                 const float* plan, const float* denom, float* y,
                                 int batch, int n_frames, int n_fft, int hop,
                                 int offset, int out_samples, int tile, int radices,
                                 void* stream) {
  const int m = n_fft / 2;
  if (!fft_plan_ok(m, radices, THREADS)) return static_cast<int>(cudaErrorInvalidValue);
  const bool pow2 = (m & (m - 1)) == 0;
  const size_t buf = (static_cast<size_t>(tile) * fft_row_stride(n_fft / 2) + 1) & ~size_t{1};
  const size_t smem = sizeof(float2) * buf + sizeof(float) * (3 * n_fft + 2);
  auto kernel = pow2 ? istft_polar_kernel<true> : istft_polar_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int r = n_fft / hop;
  const long tile_samples = static_cast<long>(tile - (r - 1)) * hop;
  const long ola_len = static_cast<long>(n_fft) + static_cast<long>(n_frames - 1) * hop;
  const long need = ola_len > static_cast<long>(offset) + out_samples
                        ? ola_len
                        : static_cast<long>(offset) + out_samples;
  const dim3 grid(static_cast<unsigned>((need + tile_samples - 1) / tile_samples), batch);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      mag, phase, plan, denom, y, n_frames, n_fft, hop, offset, out_samples, tile, radices);
  return static_cast<int>(cudaGetLastError());
}
