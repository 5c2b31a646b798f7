// add_layer_norm: s = x + scale * delta, h = LayerNorm(s; gamma, beta, eps),
// then h += r where a residual is given, over [rows, 64] fp32 rows in one
// pass: the sublayer boundaries of the conformer blocks in CMGAN's
// generator (conformer.py's ConformerBlock: a half-step feed-forward, the
// attention or the convolution module added back, and the next PreNorm's or
// the block's post LayerNorm; TSCB's outer residual as the epilogue).
//
// Ports no TPU kernel: the JAX package has no CMGAN. It was added because
// ATen runs each of those adds, scales and LayerNorms as its own pass over
// device memory, and on an H100 its LayerNorm kernel ran at ~10% of its
// bytes bound on the conformers' 64-float rows; this kernel runs at 82-86%
// of its own at [32 x 101 x 819, 64].
//
// What bounds it on an H100: bytes. A launch reads x, delta and the
// residual (each where given) and writes s (where kept) and h, 256 B a row
// each; no arithmetic comes near the card's rate.
//
// Design:
// - A row is 16 lanes, a float4 each, so a warp takes two rows and a block
//   of 256 threads 16; each thread takes two rows of a 32-row tile and
//   issues the loads of both before either reduction. gamma and beta stay
//   in registers.
// - The mean, then the biased variance of (s - mean), as nn.LayerNorm
//   defines them, each summed by shuffles within the row's 16 lanes; the
//   lanes of a row outside the tensor take zeros, so every lane of a warp
//   reaches every shuffle. 1 / sqrtf, IEEE (no fast math).
// - s is rounded as the plain version rounds it, the product delta * scale
//   and then the sum (__fmul_rn, __fadd_rn: no contraction into an FMA), so
//   the stored sum equals the plain version's bit for bit.
// - delta is read as rows [G, N, 64] or channel-first [G, 64, N] (the
//   convolution module's last 1x1 convolution leaves it so). Channel-first,
//   a tile of 32 positions of one group is read along N, a warp a channel
//   (coalesced), into shared memory [64][33] and each row takes its four
//   channels from there. Rows are tiled by group only in that layout; rows
//   in [G, N, 64] are one group of G * N.
// - A grid-stride loop over the tiles, the grid the card's SMs times the
//   blocks resident on each, so no block is launched for a few rows.
// - 64-bit offsets: the cell's largest activation is 339M floats.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int C = 64;                // channels a row
constexpr int LANES = C / 4;         // lanes a row, a float4 each
constexpr int THREADS = 256;
constexpr int SLOTS = THREADS / LANES;  // rows a block takes at once: 16
constexpr int TILE = 2 * SLOTS;      // rows (positions) a tile: 32
constexpr int LDT = TILE + 1;        // floats a row of the shared tile
constexpr int MAX_DEVICES = 64;      // devices whose grid size is cached

__device__ __forceinline__ float row_sum(float v) {
  // a row's 16 lanes are one half of a warp: xor by 8, 4, 2, 1 stays in it
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float add_scaled(float x, float d, float scale) {
  return __fadd_rn(__fmul_rn(d, scale), x);
}

template <bool CF>
__global__ void __launch_bounds__(THREADS)
add_layer_norm_kernel(const float* __restrict__ x,         // [G, N, 64]
                      const float* __restrict__ delta,     // [G, N, 64], [G, 64, N] or null
                      const float* __restrict__ residual,  // [G, N, 64] or null
                      const float* __restrict__ gamma,     // [64]
                      const float* __restrict__ beta,      // [64]
                      float* __restrict__ sum_out,         // [G, N, 64] or null
                      float* __restrict__ out,             // [G, N, 64]
                      int groups, int n, float scale, float eps) {
  __shared__ float tile[CF ? C * LDT : 1];
  const int lane = threadIdx.x % LANES;
  const int slot = threadIdx.x / LANES;
  const float4 g = reinterpret_cast<const float4*>(gamma)[lane];
  const float4 b = reinterpret_cast<const float4*>(beta)[lane];
  const long per_group = (static_cast<long>(n) + TILE - 1) / TILE;
  const long tiles = per_group * groups;
  for (long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long grp = t / per_group;
    const int n0 = static_cast<int>(t - grp * per_group) * TILE;
    const int count = n - n0 < TILE ? n - n0 : TILE;
    if (CF) {
      __syncthreads();  // every row of the last tile has read its channels
      const float* src = delta + grp * C * n + n0;
      const int j = threadIdx.x % TILE;
      if (j < count)
        for (int c = threadIdx.x / TILE; c < C; c += THREADS / TILE)
          tile[c * LDT + j] = src[static_cast<long>(c) * n + j];
      __syncthreads();
    }
    float4 v[2], r[2];
    bool ok[2];
    long at[2];  // the row's first float
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int j = slot + p * SLOTS;
      ok[p] = j < count;
      at[p] = ((grp * n + n0 + j) * C) + 4 * lane;
      v[p] = r[p] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!ok[p]) continue;
      v[p] = *reinterpret_cast<const float4*>(x + at[p]);
      if (delta != nullptr) {
        float4 d;
        if (CF) {
          const float* col = tile + 4 * lane * LDT + j;
          d = make_float4(col[0], col[LDT], col[2 * LDT], col[3 * LDT]);
        } else {
          d = *reinterpret_cast<const float4*>(delta + at[p]);
        }
        v[p] = make_float4(add_scaled(v[p].x, d.x, scale), add_scaled(v[p].y, d.y, scale),
                           add_scaled(v[p].z, d.z, scale), add_scaled(v[p].w, d.w, scale));
      }
      if (residual != nullptr) r[p] = *reinterpret_cast<const float4*>(residual + at[p]);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float4 s = v[p];
      const float mean = row_sum((s.x + s.y) + (s.z + s.w)) * (1.f / C);
      const float4 e = make_float4(s.x - mean, s.y - mean, s.z - mean, s.w - mean);
      const float var = row_sum((e.x * e.x + e.y * e.y) + (e.z * e.z + e.w * e.w)) * (1.f / C);
      const float rstd = 1.f / sqrtf(var + eps);
      if (!ok[p]) continue;
      if (sum_out != nullptr) *reinterpret_cast<float4*>(sum_out + at[p]) = s;
      float4 h = make_float4(e.x * rstd * g.x + b.x, e.y * rstd * g.y + b.y,
                             e.z * rstd * g.z + b.z, e.w * rstd * g.w + b.w);
      if (residual != nullptr)
        h = make_float4(h.x + r[p].x, h.y + r[p].y, h.z + r[p].z, h.w + r[p].w);
      *reinterpret_cast<float4*>(out + at[p]) = h;
    }
  }
}

// The card's SMs times the blocks of the instance resident on each, read
// once a device (always the same values, so threads racing here do no harm).
template <bool CF>
cudaError_t grid_size(int* blocks) {
  static std::atomic<int> cached[MAX_DEVICES];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && (*blocks = cached[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms, per_sm;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, add_layer_norm_kernel<CF>,
                                                      THREADS, 0);
  if (e != cudaSuccess) return e;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < MAX_DEVICES) cached[dev].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

template <bool CF>
cudaError_t launch(const float* x, const float* delta, const float* residual,
                   const float* gamma, const float* beta, float* sum_out, float* out,
                   int groups, int n, float scale, float eps, cudaStream_t stream) {
  int blocks;
  cudaError_t e = grid_size<CF>(&blocks);
  if (e != cudaSuccess) return e;
  const long tiles = static_cast<long>(groups) * ((static_cast<long>(n) + TILE - 1) / TILE);
  if (tiles < blocks) blocks = static_cast<int>(tiles);
  add_layer_norm_kernel<CF><<<blocks, THREADS, 0, stream>>>(
      x, delta, residual, gamma, beta, sum_out, out, groups, n, scale, eps);
  return cudaGetLastError();
}

}  // namespace

// x, residual, sum_out, out: [groups, n, 64] contiguous; delta: the same, or
// [groups, 64, n] where channels_first; gamma, beta: [64]. Every pointer
// 16-byte aligned but a channel-first delta (4). delta, residual and sum_out
// may be null: no add, no epilogue, the sum not stored. groups * n rows,
// each at most 2^31 - 1.
extern "C" int sevit_add_layer_norm(const float* x, const float* delta, const float* residual,
                                    const float* gamma, const float* beta, float* sum_out,
                                    float* out, int groups, int n, float scale, float eps,
                                    int channels_first, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups < 0 || n < 0) return cudaErrorInvalidValue;
  if (static_cast<long>(groups) * n == 0) return cudaSuccess;
  if (channels_first) {
    if (delta == nullptr) return cudaErrorInvalidValue;
    return launch<true>(x, delta, residual, gamma, beta, sum_out, out, groups, n, scale, eps, s);
  }
  // rows need no tiling by group: one group of every row
  const long rows = static_cast<long>(groups) * n;
  if (rows > 0x7fffffffL) return cudaErrorInvalidValue;
  return launch<false>(x, delta, residual, gamma, beta, sum_out, out, 1,
                       static_cast<int>(rows), scale, eps, s);
}
