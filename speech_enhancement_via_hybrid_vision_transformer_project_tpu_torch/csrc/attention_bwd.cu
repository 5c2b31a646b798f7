// K2 attention_bwd: the gradient of softmax(Q K^T * scale, key mask) V with
// respect to Q, K and V, fp32 on the CUDA cores.
//
// Replaces the backward of the TPU kernel's custom VJP, _fused_bwd in
// speech_enhancement_via_hybrid_vision_transformer_project_tpu/ops/pallas_attention.py
// (XLA einsums that recompute the softmax weights rather than keep them
// between forward and backward). This kernel keeps that property: the
// [G, N, N] weights never reach device memory. The forward (attention.cu)
// writes each row's log-sum-exp in log2 units (`lse`), and the weights are
// recomputed tile by tile as P = exp2(Q K^T * scale * log2(e) - lse).
//
// Semantics: sdpa_reference's (models/attention.py), which the port's
// forward follows. A masked key's logit is -1e30 through a `where`, so its
// dS is 0: it gets dk = 0 and, when its row keeps any key, P = 0 and dv = 0.
// A row that keeps no key averages V over all N keys (P = 1/N): each key's
// dv is the mean of dO over the queries, and dq = dk = 0.
//
//   Delta_i = rowsum(dO_i * O_i),  dP = dO V^T,  dS = P * (dP - Delta)
//   dq = scale * dS K,  dk = scale * dS^T Q,  dv = P^T dO
//
// What bounds it on an H100: its operations, 10 N^2 D per (batch, head) on
// kept keys at the least (S, dP, dq, dk, dv), at the card's fastest rate for
// fp32-accurate matrix products (3xTF32 on the tensor cores, 165 TFLOP/s).
// This kernel does 14 (the key pass recomputes S and dP rather than read
// them back from device memory) in fp32 FMAs on the CUDA cores (67
// TFLOP/s), so it reaches at most 10/14 x 67/165 = 29% of that bound. Why
// the CUDA cores and not the forward's 3xTF32 mma.sync: the backward
// multiplies by P^T and dS^T, whose tensor-core fragments the forward's
// column-order trick does not give, and a first kernel that is right comes
// before a fast one.
//
// Design: two kernels, deterministic (no atomics), 256 threads each as a
// 16 x 16 grid; each thread owns a 4 x 4 (or 4 x D/16) register tile of
// every 64 x 64 (or 64 x D) product, rows ty + 16 r and columns tx + 16 c.
// Tiles live in shared memory row-major with an odd row stride (D + 1, 65),
// so that 16 consecutive threads reading a row or a column hit 16 banks.
// - dq pass, a block per (batch*head, 64 query rows): Delta of its rows
//   (written to device memory for the next pass), then over the kept keys in
//   tiles of 64: S, dP -> dS^T (shared memory) -> dq += dS K.
// - dk/dv pass, a block per (batch*head, 64 kept keys): over all query rows
//   in tiles of 64: S^T, dP^T -> P, dS (shared memory) -> dv += P^T dO,
//   dk += dS^T Q, both held in registers across the query tiles. The block
//   also writes the zero rows of the masked keys among key positions
//   [64 x, 64 x + 64), so every row of dk and dv is written.
// The kept keys are listed per block as in the forward (kept_keys.cuh), 4
// bytes a key of shared memory, so an N whose tiles and list exceed the
// card's shared memory a block fails to launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kept_keys.cuh"
#include "max_smem.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int T = 64;       // query rows and keys per tile
constexpr int LDP = T + 1;  // row stride of the P and dS tiles

template <int D>
__host__ __device__ constexpr int ld() { return D + 1; }

// Shared memory before the kept-key list: four T x (D + 1) tiles, the P / dS
// tiles (one in the dq pass, two in the dk/dv pass), Delta and lse of T rows.
template <int D>
constexpr size_t tiles_bytes(bool dkdv) {
  return sizeof(float) * (4 * T * ld<D>() + (dkdv ? 2 : 1) * T * LDP + 2 * T);
}

// Rows [r0, r0 + T) of a row-major [*, D] matrix (gathered through `idx`
// when it is not null) into a T x (D + 1) tile; rows from `count` on are 0.
template <int D>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const float* __restrict__ src,
                                          int r0, int count, const int* __restrict__ idx) {
  constexpr int CH = D / 4;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < T * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const int p = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < count) {
      const long row = idx ? idx[p] : p;
      x = *reinterpret_cast<const float4*>(src + row * D + c * 4);
    }
    float* d = dst + r * ld<D>() + c * 4;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// acc[r][c] = sum_{k < D} a[(ty + 16 r) * (D + 1) + k] * b[(tx + 16 c) * (D + 1) + k]:
// the thread's 4 x 4 tile of A B^T for two T x (D + 1) tiles.
template <int D>
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* __restrict__ a,
                                         const float* __restrict__ b) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 8
  for (int k = 0; k < D; ++k) {
    float x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = a[(ty + 16 * r) * ld<D>() + k];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = b[(tx + 16 * c) * ld<D>() + k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(x[r], y[c], acc[r][c]);
  }
}

// acc[r][c] += sum_{i < T} a[i * LDP + ty + 16 r] * b[i * (D + 1) + tx + 16 c]:
// the thread's 4 x D/16 tile of A^T B, A a T x T tile (stride LDP) and B a
// T x (D + 1) tile, both with the summed index as rows.
template <int D>
__device__ __forceinline__ void tile_atb(float (&acc)[4][D / 16], const float* __restrict__ a,
                                         const float* __restrict__ b) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int i = 0; i < T; ++i) {
    float x[4], y[D / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = a[i * LDP + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) y[c] = b[i * ld<D>() + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] = fmaf(x[r], y[c], acc[r][c]);
  }
}

// The keys the blocks of a batch row walk: all n (no mask, or a row that
// keeps none: *all_masked), else its kept keys, listed at `list_smem`.
__device__ __forceinline__ int walked_keys(const unsigned char* mrow, int n, void* list_smem,
                                           const int** kept, bool* all_masked) {
  *kept = nullptr;
  *all_masked = false;
  if (!mrow) return n;
  const int n_kept = list_kept_keys<WARPS>(mrow, n, list_smem, kept);
  if (n_kept > 0) return n_kept;
  *kept = nullptr;
  *all_masked = true;
  return n;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const unsigned char* __restrict__ key_mask,
                        float* __restrict__ delta, float* __restrict__ dq,
                        int heads, int n, float qscale, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [T][D + 1] each
  float* dos = qs + T * ld<D>();
  float* ks = dos + T * ld<D>();
  float* vs = ks + T * ld<D>();
  float* dst = vs + T * ld<D>();  // dS^T: [key][query], stride LDP
  float* dl = dst + T * LDP;      // Delta of the block's rows
  float* ls = dl + T;             // lse of the block's rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const long g = blockIdx.y;
  const long base = g * n * D;
  const int i0 = blockIdx.x * T;
  const unsigned char* mrow = key_mask ? key_mask + (g / heads) * n : nullptr;

  // Delta_i = rowsum(dO_i * O_i), a warp per row
  for (int r = warp; r < T; r += WARPS) {
    const int i = i0 + r;
    float s = 0.f;
    if (i < n)
      for (int d = lane; d < D; d += 32)
        s = fmaf(dout[base + static_cast<long>(i) * D + d], o[base + static_cast<long>(i) * D + d], s);
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      dl[r] = s;
      ls[r] = i < n ? lse[g * n + i] : 0.f;
      if (i < n) delta[g * n + i] = s;
    }
  }
  const int* kept;
  bool all_masked;
  const int count = walked_keys(mrow, n, ls + T, &kept, &all_masked);

  float acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[r][c] = 0.f;

  if (!all_masked) {  // (a row that keeps no key: every dS is 0, so dq = 0)
    load_rows<D>(qs, q + base, i0, n, nullptr);
    load_rows<D>(dos, dout + base, i0, n, nullptr);
    for (int j0 = 0; j0 < count; j0 += T) {
      __syncthreads();  // the previous tile's K, V and dS^T are read
      load_rows<D>(ks, k + base, j0, count, kept);
      load_rows<D>(vs, v + base, j0, count, kept);
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_abt<D>(s, qs, ks);    // rows: queries ty + 16 r, columns: keys tx + 16 c
      tile_abt<D>(dp, dos, vs);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          const float p = j0 + col < count ? exp2f(fmaf(s[r][c], qscale, -ls[row])) : 0.f;
          dst[col * LDP + row] = p * (dp[r][c] - dl[row]);
        }
      }
      __syncthreads();
      tile_atb<D>(acc, dst, ks);  // dq += dS K
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i < n)
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        dq[base + static_cast<long>(i) * D + tx + 16 * c] = acc[r][c] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const unsigned char* __restrict__ key_mask,
                          const float* __restrict__ delta, float* __restrict__ dk,
                          float* __restrict__ dv, int heads, int n, float qscale, float scale) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [T][D + 1] each
  float* vs = ks + T * ld<D>();
  float* qs = vs + T * ld<D>();
  float* dos = qs + T * ld<D>();
  float* ps = dos + T * ld<D>();  // P: [query][key], stride LDP
  float* dss = ps + T * LDP;      // dS: [query][key]
  float* dl = dss + T * LDP;      // Delta of the query tile's rows
  float* ls = dl + T;             // lse of the query tile's rows
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long g = blockIdx.y;
  const long base = g * n * D;
  const int j0 = blockIdx.x * T;  // the block's first position in the walked keys
  const unsigned char* mrow = key_mask ? key_mask + (g / heads) * n : nullptr;

  const int* kept;
  bool all_masked;
  const int count = walked_keys(mrow, n, ls + T, &kept, &all_masked);

  if (mrow && !all_masked) {  // masked keys among positions [j0, j0 + T): zero rows
    for (int i = tid; i < T * D; i += THREADS) {
      const int p = j0 + i / D;
      if (p < n && !mrow[p]) {
        dk[base + static_cast<long>(p) * D + i % D] = 0.f;
        dv[base + static_cast<long>(p) * D + i % D] = 0.f;
      }
    }
  }
  if (all_masked) {
    // P = 1/n everywhere and dS = 0: every key's dv is the mean of dO over
    // the n queries, dk = 0. Column sums of dO through shared memory.
    constexpr int STRIDE = THREADS / D;  // rows summed in parallel per column
    float s = 0.f;
    for (int i = tid / D; i < n; i += STRIDE) s += dout[base + static_cast<long>(i) * D + tid % D];
    qs[tid] = s;
    __syncthreads();
    if (tid < D) {
      float tot = 0.f;
      for (int m = 0; m < STRIDE; ++m) tot += qs[m * D + tid];
      qs[THREADS + tid] = tot / static_cast<float>(n);
    }
    __syncthreads();
    for (int i = tid; i < T * D; i += THREADS) {
      const int p = j0 + i / D;
      if (p < n) {
        dk[base + static_cast<long>(p) * D + i % D] = 0.f;
        dv[base + static_cast<long>(p) * D + i % D] = qs[THREADS + i % D];
      }
    }
    return;
  }
  if (j0 >= count) return;

  load_rows<D>(ks, k + base, j0, count, kept);
  load_rows<D>(vs, v + base, j0, count, kept);
  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[r][c] = dva[r][c] = 0.f;

  for (int i0 = 0; i0 < n; i0 += T) {
    __syncthreads();  // the previous tile's Q, dO, P and dS are read
    load_rows<D>(qs, q + base, i0, n, nullptr);
    load_rows<D>(dos, dout + base, i0, n, nullptr);
    if (tid < T) {
      const int i = i0 + tid;
      ls[tid] = i < n ? lse[g * n + i] : 0.f;
      dl[tid] = i < n ? delta[g * n + i] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt<D>(s, ks, qs);    // rows: keys ty + 16 r, columns: queries tx + 16 c
    tile_abt<D>(dp, vs, dos);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int key = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = tx + 16 * c;
        const float p = (i0 + row < n && j0 + key < count)
                            ? exp2f(fmaf(s[r][c], qscale, -ls[row])) : 0.f;
        ps[row * LDP + key] = p;
        dss[row * LDP + key] = p * (dp[r][c] - dl[row]);
      }
    }
    __syncthreads();
    tile_atb<D>(dva, ps, dos);  // dv += P^T dO
    tile_atb<D>(dka, dss, qs);  // dk += dS^T Q
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty + 16 * r;
    if (j < count) {
      const long key = kept ? kept[j] : j;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        dk[base + key * D + tx + 16 * c] = dka[r][c] * scale;
        dv[base + key * D + tx + 16 * c] = dva[r][c];
      }
    }
  }
}

template <int D>
size_t smem_bytes(bool dkdv, bool masked, int n) {
  return tiles_bytes<D>(dkdv) + (masked ? kept_list_bytes(n) : 0);
}

// Lets both kernels take all the shared memory a block may have on the
// current device, set once per device (always the same values, so threads
// racing here do no harm).
template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                   const float* dout, const float* lse, const unsigned char* key_mask,
                   float* delta, float* dq, float* dk, float* dv, int groups, int heads,
                   int n, float qscale, float scale, cudaStream_t stream) {
  // both passes may take all the shared memory a block may have (max_smem.cuh)
  cudaError_t err = allow_max_smem<D>(attention_bwd_dq_kernel<D>, attention_bwd_dkdv_kernel<D>);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + T - 1) / T, groups);
  const bool masked = key_mask != nullptr;
  attention_bwd_dq_kernel<D><<<grid, THREADS, smem_bytes<D>(false, masked, n), stream>>>(
      q, k, v, o, dout, lse, key_mask, delta, dq, heads, n, qscale, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<D><<<grid, THREADS, smem_bytes<D>(true, masked, n), stream>>>(
      q, k, v, dout, lse, key_mask, delta, dk, dv, heads, n, qscale, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t info(int* regs, int* local_bytes) {
  cudaFuncAttributes a, b;
  cudaError_t err = cudaFuncGetAttributes(&a, attention_bwd_dq_kernel<D>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&b, attention_bwd_dkdv_kernel<D>);
  if (err != cudaSuccess) return err;
  regs[0] = a.numRegs;
  regs[1] = b.numRegs;
  local_bytes[0] = static_cast<int>(a.localSizeBytes);
  local_bytes[1] = static_cast<int>(b.localSizeBytes);
  return cudaSuccess;
}

}  // namespace

// q/k/v/o/dout/dq/dk/dv: [groups = batch*heads, n, d] contiguous, 16-byte
// aligned; lse: [groups, n], the forward's log-sum-exp in log2 units;
// key_mask: [batch, n] bytes (nonzero = attend) or null; delta: [groups, n]
// scratch; qscale: the softmax scale times log2(e). d in {16, 32, 64, 128}.
// Launches the dq pass, then the dk/dv pass, on `stream`.
extern "C" int sevit_attention_bwd(const float* q, const float* k, const float* v,
                                   const float* o, const float* dout, const float* lse,
                                   const unsigned char* key_mask, float* delta, float* dq,
                                   float* dk, float* dv, int groups, int heads, int n, int d,
                                   float qscale, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define SEVIT_BWD(D)                                                                      \
  case D:                                                                                 \
    return launch<D>(q, k, v, o, dout, lse, key_mask, delta, dq, dk, dv, groups, heads, n, \
                     qscale, scale, s);
    SEVIT_BWD(16)
    SEVIT_BWD(32)
    SEVIT_BWD(64)
    SEVIT_BWD(128)
#undef SEVIT_BWD
    default: return cudaErrorInvalidValue;
  }
}

// Registers and local (spill) bytes per thread of the dq pass ([0]) and the
// dk/dv pass ([1]) for head dim d.
extern "C" int sevit_attention_bwd_info(int d, int* regs, int* local_bytes) {
  switch (d) {
    case 16: return info<16>(regs, local_bytes);
    case 32: return info<32>(regs, local_bytes);
    case 64: return info<64>(regs, local_bytes);
    case 128: return info<128>(regs, local_bytes);
    default: return cudaErrorInvalidValue;
  }
}
