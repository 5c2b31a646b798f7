// K2 attention_bwd: the gradient of softmax(Q K^T * scale, key mask) V with
// respect to Q, K and V, fp32-accurate, on Hopper's tensor cores in 3xTF32.
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
// This kernel does 14: two deterministic passes (no atomics), each of which
// recomputes S and dP. A single pass that adds each tile's dq into device
// memory by atomics does 10, but its sums then change order from run to run.
//
// Design: the forward's building blocks (tf32_mma.cuh): mma.sync m16n8k8
// TF32, three per product (x = hi + lo), and an accumulator fragment of S
// (columns 2t, 2t + 1) taken as the A fragment of the next product with no
// shuffle, each 8-deep k-step taking its columns in the order 0,2,4,6,1,3,5,7.
// Each pass computes its products in its own orientation, so that the
// weights are always the first operand:
// - dq pass, a block of 4 warps per (batch*head, 64 query rows), 16 rows a
//   warp, A operands Q (scaled by scale * log2(e)) and dO. It writes Delta of
//   its rows for the next pass and walks the kept keys in tiles of 32, K and
//   V double buffered by cp.async: S = Q K^T and dP = dO V^T, P = exp2(S -
//   lse), dS = P (dP - Delta) in registers, dq += dS K.
// - dk/dv pass, a block of 4 warps per (batch*head, 64 walked keys), 16 keys
//   a warp, A operands K (scaled) and V. It walks all query rows in tiles of
//   32 (16 at D = 128), Q, dO and the rows' lse and Delta double buffered by
//   cp.async: S^T = K Q^T and dP^T = V dO^T (rows: keys), P^T = exp2(S^T -
//   lse of the columns), dS^T = P^T (dP^T - Delta of the columns), dv += P^T
//   dO, dk += dS^T Q. It also writes the zero rows of the masked keys among
//   key positions [64 x, 64 x + 64), so every row of dk and dv is written.
// Registers: two A operands (64 fp32 values a thread at D = 64, 128 as hi
// and lo), two accumulators (64 in the dk/dv pass) and two S-sized products.
// With the A operands in registers, split per k-step, both passes took 255
// registers and spilled on an H100. So each thread splits its A fragments
// once into hi and lo and keeps them in shared memory, its own 16-byte words
// (64 KB a block at D = 64), read back with one 16-byte load per k-step and
// half: 166 (dq) and 182 (dk/dv) registers at D = 64, no spills, two blocks
// an SM. Larger tiles (64 keys in the dq pass, 64 rows in the dk/dv pass)
// leave one block an SM or spill, and ran slower.
// Shared memory: every streamed tile is read in two patterns. As the B
// operand of S (8 rows g, a float2 at columns kcol(kk, t)) and as the B
// operand of dS K (rows 2t and 2t + 1, a float2 at columns 2g, 2g + 1 of a
// 16-column pair of n-tiles: n-tile 2p takes column 16p + 2g, 2p + 1 the
// next, so a thread's dq values lie at 16p + 4t .. 16p + 4t + 3, one float4
// store). One row stride, D + 4 floats (4 mod 32 banks), serves both when S's
// k-steps take their column pairs at 2 (t & 1) + 16 (t >> 1) in chunks of 32
// columns (kcol): no bank conflicts for D >= 32; at D = 16 the S loads are
// 2-way conflicted.
// The kept keys are listed per block as in the forward (kept_keys.cuh), 4
// bytes a key of shared memory beside the A operands and tiles (100,864
// bytes in the dk/dv pass at D = 64), so a mask over more than 30,956 keys at
// D = 64 (7,946 at D = 128) fails to launch.
// A head dim above 128 (SLICED), as the forward: q, k, v, o and dO
// zero-padded to whole 128-column slices, a third grid dimension over the
// output slice, and each tile walked one slice of its operands a step, the
// block's own slice last, so that S and dP (and Delta) sum over every slice
// while dq (or dk and dv) gathers only its 128 columns from the last step's
// tile. The A operands are read from device memory and split per step
// instead of kept in shared memory (which could not hold every slice's), so
// the sliced passes use the D = 128 tiles' shared memory alone.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kept_keys.cuh"
#include "max_smem.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;  // query rows (dq pass) or walked keys (dk/dv pass) per block

// Keys per K/V tile of the dq pass, and query rows per Q/dO tile of the
// dk/dv pass.
constexpr int BK = 32;
template <int D>
__host__ __device__ constexpr int dkdv_tile() { return D <= 64 ? 32 : 16; }

// Shared memory of a block's A operands in 16-byte words: two operands, D / 8
// k-steps, hi and lo, a word per thread (none in the sliced passes).
template <int D, bool SLICED>
__host__ __device__ constexpr int a_words() { return SLICED ? 0 : 2 * (D / 8) * 2 * THREADS; }

template <int D>
__host__ __device__ constexpr int ld() { return D + 4; }  // row stride of every tile

// Shared memory before the kept-key list: the A operands, then two K and
// two V tiles (dq pass) or two Q and two dO tiles and their rows' lse and
// Delta (dk/dv pass).
template <int D, bool SLICED>
constexpr size_t tiles_bytes(bool dkdv) {
  return 16 * a_words<D, SLICED>() +
         sizeof(float) * (dkdv ? 2 * dkdv_tile<D>() * (2 * ld<D>() + 2) : 2 * 2 * BK * ld<D>());
}

// The first of the two columns thread t takes at k-step kk of a product over
// the head dim (the forward's order at D = 16).
template <int D>
__device__ __forceinline__ int kcol(int kk, int t) {
  if constexpr (D >= 32)
    return (kk >> 2) * 32 + (kk & 3) * 4 + (t & 1) * 2 + (t >> 1) * 16;
  else
    return kk * 8 + 2 * t;
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The hi and lo A fragments of four fp32 values.
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(x[e], hi[e], lo[e]);
}

// An accumulator tile (columns 2t, 2t + 1 of rows g, g + 8) as the A
// fragment of the next product's k-step (columns t and t + 4).
__device__ __forceinline__ void acc_as_a(const float (&c)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// acc[2p + e] += A B for the k-step whose B rows are `r` and `r + LD` of a
// tile (float2 loads at columns 16p + 2g: e = 0, 1).
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const float* r) {
#pragma unroll
  for (int p = 0; p < D / 16; ++p) {
    const float2 b0 = ld2(r + 16 * p), b1 = ld2(r + ld<D>() + 16 * p);
    mma3(acc[2 * p], ah, al, b0.x, b1.x);
    mma3(acc[2 * p + 1], ah, al, b0.y, b1.y);
  }
}

// The accumulators' rows g and g + 8 (n-tiles 2p, 2p + 1 of each 16-column
// pair) times `mul` into rows ra and rb (-1: none) of a matrix of row stride
// `stride`, as float4 stores at columns 16p + 4t.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, long ra, long rb, const float (&acc)[D / 8][4],
                                           float mul, int t, int stride) {
#pragma unroll
  for (int p = 0; p < D / 16; ++p) {
    const int c = 16 * p + 4 * t;
    if (ra >= 0)
      *reinterpret_cast<float4*>(dst + ra * stride + c) =
          make_float4(acc[2 * p][0] * mul, acc[2 * p + 1][0] * mul, acc[2 * p][1] * mul,
                      acc[2 * p + 1][1] * mul);
    if (rb >= 0)
      *reinterpret_cast<float4*>(dst + rb * stride + c) =
          make_float4(acc[2 * p][2] * mul, acc[2 * p + 1][2] * mul, acc[2 * p][3] * mul,
                      acc[2 * p + 1][3] * mul);
  }
}

// The A fragment of k-step column c (kcol's) of rows ra and rb (-1: a zero
// row) of a matrix of row stride `stride`, times `mul`.
__device__ __forceinline__ void frag_a(float (&f)[4], const float* src, long ra, long rb, int c,
                                       float mul, int stride) {
  const float2 x = ra >= 0 ? ld2(src + ra * stride + c) : make_float2(0.f, 0.f);
  const float2 y = rb >= 0 ? ld2(src + rb * stride + c) : make_float2(0.f, 0.f);
  f[0] = x.x * mul;
  f[1] = y.x * mul;
  f[2] = x.y * mul;
  f[3] = y.y * mul;
}

// A fragments of rows ra and rb (-1: a zero row) of a [*, D] matrix, times
// `mul`, in kcol's column order.
template <int D>
__device__ __forceinline__ void load_a(float (&f)[D / 8][4], const float* src, long ra, long rb,
                                       float mul, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) frag_a(f[kk], src, ra, rb, kcol<D>(kk, t), mul, D);
}

// The hi and lo A fragments of k-step kk of rows ra and rb of a matrix of
// row stride `stride` times `mul` (the sliced passes, per step).
template <int D>
__device__ __forceinline__ void split_a(const float* src, long ra, long rb, int kk, int t,
                                        float mul, int stride, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  float f[4];
  frag_a(f, src, ra, rb, kcol<D>(kk, t), mul, stride);
  split4(f, hi, lo);
}

// The A fragments of operand `op` (0 or 1) over the head dim, rows ra and
// rb of `src` times `mul`, split into hi and lo once and kept in shared
// memory: each thread's own 16-byte words (`own` = the A words +
// threadIdx.x; it alone writes and reads them, so no barrier), a word per
// k-step and half, lane after lane.
template <int D>
__device__ __forceinline__ void put_a(uint4* own, int op, const float* src, long ra, long rb,
                                      float mul, int t) {
  float a[D / 8][4];
  load_a<D>(a, src, ra, rb, mul, t);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t hi[4], lo[4];
    split4(a[kk], hi, lo);
    own[(op * (D / 8) + kk) * 2 * THREADS] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    own[((op * (D / 8) + kk) * 2 + 1) * THREADS] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

template <int D>
__device__ __forceinline__ void get_a(const uint4* own, int op, int kk, uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
  const uint4 h = own[(op * (D / 8) + kk) * 2 * THREADS];
  const uint4 l = own[((op * (D / 8) + kk) * 2 + 1) * THREADS];
  hi[0] = h.x, hi[1] = h.y, hi[2] = h.z, hi[3] = h.w;
  lo[0] = l.x, lo[1] = l.y, lo[2] = l.z, lo[3] = l.w;
}

// Columns [0, D) of rows [r0, r0 + R) of a row-major matrix of row stride
// `stride` (gathered through `idx` when it is not null) into an R x ld<D>()
// tile by cp.async; rows from `count` on are zero filled.
template <int D, int R>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int r0, int count,
                                          const int* idx, int stride) {
  constexpr int CH = D / 4;  // 16-byte chunks of a row
#pragma unroll
  for (int it = 0; it < (R * CH + THREADS - 1) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (R * CH % THREADS && i >= R * CH) break;
    const int r = i / CH, c = i % CH;
    const int p = r0 + r;
    const bool in = p < count;
    const long row = in ? (idx ? idx[p] : p) : 0;
    cp_async16(dst + r * ld<D>() + c * 4, src + row * stride + c * 4, in);
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

// The slice of step st's operands: st % slices counts up from the one after
// the output slice z, which comes last (SLICED), else 0.
__device__ __forceinline__ int slice_of(int i, int slices) {
  return (static_cast<int>(blockIdx.z) + 1 + i) % slices;
}

template <int D, bool SLICED>
__global__ void __launch_bounds__(THREADS, 2)
attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        const unsigned char* __restrict__ key_mask,
                        float* __restrict__ delta, float* __restrict__ dq,
                        int heads, int n, float qscale, float scale, int slices) {
  constexpr int LD = ld<D>();
  constexpr int KS = D / 8;   // k-steps of S and dP
  constexpr int NT = BK / 8;  // 8-key column tiles of S, k-steps of dS K
  static_assert(!SLICED || D == 128, "slices of 128 columns");
  const int ns = SLICED ? slices : 1;  // 128-column slices of the head dim
  const int stride = D * ns;           // row stride of every [G, N, *] operand
  const int zo = SLICED ? static_cast<int>(blockIdx.z) * D : 0;  // the output slice's column

  extern __shared__ uint4 smem[];
  float* ks = reinterpret_cast<float*>(smem + a_words<D, SLICED>());  // [2][BK][LD]
  float* vs = ks + 2 * BK * LD;                                       // [2][BK][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long gi = blockIdx.y;
  const long base = gi * n * stride;
  const unsigned char* mrow = key_mask ? key_mask + (gi / heads) * n : nullptr;

  const int* kept;
  bool all_masked;
  const int count = walked_keys(mrow, n, vs + 2 * BK * LD, &kept, &all_masked);

  // the warp's rows g and g + 8 (-1 past the last row)
  const int i_a = blockIdx.x * BM + warp * 16 + g, i_b = i_a + 8;
  const long ra = i_a < n ? i_a : -1, rb = i_b < n ? i_b : -1;
  uint4* own = smem + threadIdx.x;  // A operands 0: Q (scaled), 1: dO
  if constexpr (!SLICED) {
    put_a<D>(own, 0, q + base, ra, rb, qscale, t);
    put_a<D>(own, 1, dout + base, ra, rb, 1.f, t);
  }
  // Delta of rows g and g + 8: this thread's columns of every slice, then
  // the quad's
  float d0 = 0.f, d1 = 0.f;
  for (int sl = 0; sl < ns; ++sl) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float df[4], of[4];
      frag_a(df, dout + base + sl * D, ra, rb, kcol<D>(kk, t), 1.f, stride);
      frag_a(of, o + base + sl * D, ra, rb, kcol<D>(kk, t), 1.f, stride);
      d0 = fmaf(df[0], of[0], fmaf(df[2], of[2], d0));
      d1 = fmaf(df[1], of[1], fmaf(df[3], of[3], d1));
    }
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  if (t == 0 && (!SLICED || blockIdx.z == 0)) {
    if (ra >= 0) delta[gi * n + ra] = d0;
    if (rb >= 0) delta[gi * n + rb] = d1;
  }
  const float l0 = ra >= 0 ? lse[gi * n + ra] : 0.f, l1 = rb >= 0 ? lse[gi * n + rb] : 0.f;

  float acc[D / 8][4];  // dq: n-tiles 2p, 2p + 1 of each 16-column pair
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  if (!all_masked) {  // (a row that keeps no key: every dS is 0, so dq = 0)
    // step st: key tile st / ns, slice slice_of(st % ns) of Q, dO, K and V
    auto load_tile = [&](int st, int buf) {
      const int so = SLICED ? slice_of(st % ns, ns) * D : 0;
      const int r0 = (SLICED ? st / ns : st) * BK;
      copy_rows<D, BK>(ks + buf * BK * LD, k + base + so, r0, count, kept, stride);
      copy_rows<D, BK>(vs + buf * BK * LD, v + base + so, r0, count, kept, stride);
      cp_async_commit();
    };
    const int nsteps = (count + BK - 1) / BK * ns;
    float s[NT][4], dp[NT][4];
    load_tile(0, 0);
    for (int st = 0; st < nsteps; ++st) {
      const int buf = st & 1;
      if (st + 1 < nsteps) {
        load_tile(st + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int tile = SLICED ? st / ns : st;
      const int i_s = SLICED ? st % ns : 0;
      const int so = SLICED ? slice_of(i_s, ns) * D : 0;
      const float* kt = ks + buf * BK * LD;
      const float* vt = vs + buf * BK * LD;

      // S = Q K^T (log2 units) and dP = dO V^T, summed over the slices
      if (i_s == 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qh[4], ql[4], dh[4], dl[4];
        if constexpr (SLICED) {
          split_a<D>(q + base + so, ra, rb, kk, t, qscale, stride, qh, ql);
          split_a<D>(dout + base + so, ra, rb, kk, t, 1.f, stride, dh, dl);
        } else {
          get_a<D>(own, 0, kk, qh, ql);
          get_a<D>(own, 1, kk, dh, dl);
        }
        const int c = kcol<D>(kk, t);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 b = ld2(kt + (nt * 8 + g) * LD + c);
          mma3(s[nt], qh, ql, b.x, b.y);
          const float2 e = ld2(vt + (nt * 8 + g) * LD + c);
          mma3(dp[nt], dh, dl, e.x, e.y);
        }
      }
      if (i_s != ns - 1) {  // more slices of this tile to sum
        __syncthreads();    // the next iteration refills this buffer
        continue;
      }

      // P = exp2(S - lse), 0 past the last walked key; dS = P (dP - Delta)
      const int lim = count - tile * BK;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float p0 = exp2f(s[nt][c] - l0), p1 = exp2f(s[nt][2 + c] - l1);
          if (lim < BK && nt * 8 + 2 * t + c >= lim) p0 = p1 = 0.f;
          s[nt][c] = p0 * (dp[nt][c] - d0);
          s[nt][2 + c] = p1 * (dp[nt][2 + c] - d1);
        }
      }

      // dq += dS K: k-step nt is S's column tile nt, keys 2t and 2t + 1
      // (the tile holds K's output slice: the tile's last step)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t ah[4], al[4];
        acc_as_a(s[nt], ah, al);
        mma_rows<D>(acc, ah, al, kt + (nt * 8 + 2 * t) * LD + 2 * g);
      }
      __syncthreads();  // the next iteration refills this buffer
    }
  }
  store_rows<D>(dq + base + zo, ra, rb, acc, scale, t, stride);
}

template <int D, bool SLICED>
__global__ void __launch_bounds__(THREADS, 2)
attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const unsigned char* __restrict__ key_mask,
                          const float* __restrict__ delta, float* __restrict__ dk,
                          float* __restrict__ dv, int heads, int n, float qscale, float scale,
                          int slices) {
  constexpr int BQ = dkdv_tile<D>();
  constexpr int LD = ld<D>();
  constexpr int KS = D / 8;   // k-steps of S^T and dP^T
  constexpr int NT = BQ / 8;  // 8-query column tiles of S^T, k-steps of P^T dO and dS^T Q
  static_assert(!SLICED || D == 128, "slices of 128 columns");
  const int ns = SLICED ? slices : 1;  // 128-column slices of the head dim
  const int stride = D * ns;           // row stride of every [G, N, *] operand
  const int zo = SLICED ? static_cast<int>(blockIdx.z) * D : 0;  // the output slice's column

  extern __shared__ uint4 smem[];
  float* qs = reinterpret_cast<float*>(smem + a_words<D, SLICED>());  // [2][BQ][LD]
  float* dos = qs + 2 * BQ * LD;                                      // [2][BQ][LD]
  float* ls = dos + 2 * BQ * LD;  // [2][BQ]: lse of the tile's rows
  float* dls = ls + 2 * BQ;       // [2][BQ]: Delta of the tile's rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long gi = blockIdx.y;
  const long base = gi * n * stride;
  const int j0 = blockIdx.x * BM;  // the block's first position in the walked keys
  const unsigned char* mrow = key_mask ? key_mask + (gi / heads) * n : nullptr;

  const int* kept;
  bool all_masked;
  const int count = walked_keys(mrow, n, dls + 2 * BQ, &kept, &all_masked);

  if (mrow && !all_masked) {  // masked keys among positions [j0, j0 + BM): zero rows
    for (int i = tid; i < BM * D; i += THREADS) {
      const int p = j0 + i / D;
      if (p < n && !mrow[p]) {
        dk[base + static_cast<long>(p) * stride + zo + i % D] = 0.f;
        dv[base + static_cast<long>(p) * stride + zo + i % D] = 0.f;
      }
    }
  }
  if (all_masked) {
    // P = 1/n everywhere and dS = 0: every key's dv is the mean of dO over
    // the n queries, dk = 0. Column sums of dO through shared memory.
    constexpr int STRIDE = THREADS / D;  // rows summed in parallel per column
    float s = 0.f;
    for (int i = tid / D; i < n; i += STRIDE)
      s += dout[base + static_cast<long>(i) * stride + zo + tid % D];
    qs[tid] = s;
    __syncthreads();
    if (tid < D) {
      float tot = 0.f;
      for (int m = 0; m < STRIDE; ++m) tot += qs[m * D + tid];
      qs[THREADS + tid] = tot / static_cast<float>(n);
    }
    __syncthreads();
    for (int i = tid; i < BM * D; i += THREADS) {
      const int p = j0 + i / D;
      if (p < n) {
        dk[base + static_cast<long>(p) * stride + zo + i % D] = 0.f;
        dv[base + static_cast<long>(p) * stride + zo + i % D] = qs[THREADS + i % D];
      }
    }
    return;
  }
  if (j0 >= count) return;

  // the warp's keys g and g + 8 (-1 past the last walked key)
  const int j_a = j0 + warp * 16 + g, j_b = j_a + 8;
  const long ka = j_a < count ? (kept ? kept[j_a] : j_a) : -1;
  const long kb = j_b < count ? (kept ? kept[j_b] : j_b) : -1;
  uint4* own = smem + tid;  // A operands 0: K (scaled), 1: V
  if constexpr (!SLICED) {
    put_a<D>(own, 0, k + base, ka, kb, qscale, t);
    put_a<D>(own, 1, v + base, ka, kb, 1.f, t);
  }
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[c][e] = dva[c][e] = 0.f;

  // step st: query tile st / ns, slice slice_of(st % ns) of K, V, Q and dO
  auto load_tile = [&](int st, int buf) {
    const int so = SLICED ? slice_of(st % ns, ns) * D : 0;
    const int i0 = (SLICED ? st / ns : st) * BQ;
    copy_rows<D, BQ>(qs + buf * BQ * LD, q + base + so, i0, n, nullptr, stride);
    copy_rows<D, BQ>(dos + buf * BQ * LD, dout + base + so, i0, n, nullptr, stride);
    static_assert(2 * BQ <= THREADS, "one round of lse and Delta copies");
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      const bool in = i0 + r < n;
      const long at = gi * n + (in ? i0 + r : 0);
      cp_async4((tid < BQ ? ls : dls) + buf * BQ + r, (tid < BQ ? lse : delta) + at, in);
    }
    cp_async_commit();
  };
  const int nsteps = (n + BQ - 1) / BQ * ns;
  float s[NT][4], dp[NT][4];
  load_tile(0, 0);
  for (int st = 0; st < nsteps; ++st) {
    const int buf = st & 1;
    if (st + 1 < nsteps) {
      load_tile(st + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int tile = SLICED ? st / ns : st;
    const int i_s = SLICED ? st % ns : 0;
    const int so = SLICED ? slice_of(i_s, ns) * D : 0;
    const float* qt = qs + buf * BQ * LD;
    const float* dt = dos + buf * BQ * LD;

    // S^T = K Q^T (log2 units) and dP^T = V dO^T: rows keys, columns
    // queries, summed over the slices
    if (i_s == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      if constexpr (SLICED) {
        split_a<D>(k + base + so, ka, kb, kk, t, qscale, stride, kh, kl);
        split_a<D>(v + base + so, ka, kb, kk, t, 1.f, stride, vh, vl);
      } else {
        get_a<D>(own, 0, kk, kh, kl);
        get_a<D>(own, 1, kk, vh, vl);
      }
      const int c = kcol<D>(kk, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 b = ld2(qt + (nt * 8 + g) * LD + c);
        mma3(s[nt], kh, kl, b.x, b.y);
        const float2 e = ld2(dt + (nt * 8 + g) * LD + c);
        mma3(dp[nt], vh, vl, e.x, e.y);
      }
    }
    if (i_s != ns - 1) {  // more slices of this tile to sum
      __syncthreads();    // the next iteration refills this buffer
      continue;
    }

    // P^T = exp2(S^T - lse of the column), 0 past the last query row;
    // dS^T = P^T (dP^T - Delta of the column)
    const int lim = n - tile * BQ;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 lc = ld2(ls + buf * BQ + nt * 8 + 2 * t);
      const float2 dc = ld2(dls + buf * BQ + nt * 8 + 2 * t);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float l = c ? lc.y : lc.x, dl = c ? dc.y : dc.x;
        float p0 = exp2f(s[nt][c] - l), p1 = exp2f(s[nt][2 + c] - l);
        if (lim < BQ && nt * 8 + 2 * t + c >= lim) p0 = p1 = 0.f;
        s[nt][c] = p0;
        s[nt][2 + c] = p1;
        dp[nt][c] = p0 * (dp[nt][c] - dl);
        dp[nt][2 + c] = p1 * (dp[nt][2 + c] - dl);
      }
    }

    // dv += P^T dO and dk += dS^T Q: k-step nt is S^T's column tile nt,
    // query rows 2t and 2t + 1 (the tiles hold the output slice: the
    // tile's last step)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t ah[4], al[4];
      acc_as_a(s[nt], ah, al);
      mma_rows<D>(dva, ah, al, dt + (nt * 8 + 2 * t) * LD + 2 * g);
      acc_as_a(dp[nt], ah, al);
      mma_rows<D>(dka, ah, al, qt + (nt * 8 + 2 * t) * LD + 2 * g);
    }
    __syncthreads();  // the next iteration refills this buffer
  }
  store_rows<D>(dk + base + zo, ka, kb, dka, scale, t, stride);
  store_rows<D>(dv + base + zo, ka, kb, dva, 1.f, t, stride);
}

template <int D, bool SLICED>
size_t smem_bytes(bool dkdv, bool masked, int n) {
  return tiles_bytes<D, SLICED>(dkdv) + (masked ? kept_list_bytes(n) : 0);
}

// slices: 128-column slices of the head dim (SLICED), else 1
template <int D, bool SLICED = false>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                   const float* dout, const float* lse, const unsigned char* key_mask,
                   float* delta, float* dq, float* dk, float* dv, int groups, int heads,
                   int n, float qscale, float scale, cudaStream_t stream, int slices = 1) {
  // both passes may take all the shared memory a block may have (max_smem.cuh)
  cudaError_t err = allow_max_smem<SLICED ? -D : D>(attention_bwd_dq_kernel<D, SLICED>,
                                                    attention_bwd_dkdv_kernel<D, SLICED>);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM, groups, slices);
  const bool masked = key_mask != nullptr;
  attention_bwd_dq_kernel<D, SLICED>
      <<<grid, THREADS, smem_bytes<D, SLICED>(false, masked, n), stream>>>(
          q, k, v, o, dout, lse, key_mask, delta, dq, heads, n, qscale, scale, slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<D, SLICED>
      <<<grid, THREADS, smem_bytes<D, SLICED>(true, masked, n), stream>>>(
          q, k, v, dout, lse, key_mask, delta, dk, dv, heads, n, qscale, scale, slices);
  return cudaGetLastError();
}

template <int D, bool SLICED = false>
cudaError_t info(int* regs, int* local_bytes) {
  cudaFuncAttributes a, b;
  cudaError_t err = cudaFuncGetAttributes(&a, attention_bwd_dq_kernel<D, SLICED>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&b, attention_bwd_dkdv_kernel<D, SLICED>);
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
// scratch; qscale: the softmax scale times log2(e). d in {16, 32, 64, 128},
// or a multiple of 128 above it (the sliced passes). Launches the dq pass,
// then the dk/dv pass, on `stream`.
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
    default:
      if (d <= 128 || d % 128) return cudaErrorInvalidValue;
      return launch<128, true>(q, k, v, o, dout, lse, key_mask, delta, dq, dk, dv, groups,
                               heads, n, qscale, scale, s, d / 128);
  }
}

// Registers and local (spill) bytes per thread of the dq pass ([0]) and the
// dk/dv pass ([1]) for head dim d (above 128: the sliced passes).
extern "C" int sevit_attention_bwd_info(int d, int* regs, int* local_bytes) {
  switch (d) {
    case 16: return info<16>(regs, local_bytes);
    case 32: return info<32>(regs, local_bytes);
    case 64: return info<64>(regs, local_bytes);
    case 128: return info<128>(regs, local_bytes);
    default:
      if (d <= 128 || d % 128) return cudaErrorInvalidValue;
      return info<128, true>(regs, local_bytes);
  }
}
