// K2r attention_relpos_fwd: softmax((Q K^T + Q E[clamp(i - j)]^T) * scale,
// key mask) V, forward, fp32, on Hopper's tensor cores in 3xTF32: Shaw's
// relative-position attention of the conformers in CMGAN's generator
// (conformer.py's Attention, max_pos_emb 512, head dim 16).
//
// Ports no TPU kernel: the JAX package has no CMGAN. It was added because K2
// (attention.cu) cannot add the term q_i . E[clamp(i - j, -P, P) + P], and
// materialising it as a bias costs rows * heads * N^2 floats, 1.7 GB per
// 10-s clip per layer over time.
//
// What bounds it on an H100: three matrix products, 6 * N * D operations per
// query row and key (Q K^T, the relative term and P V), at a third of the
// dense TF32 rate (3xTF32, as K2: x = hi + lo, a*b ~ a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi); over frequency (N = 101) Q, K, V and O pass HBM once for less
// work per byte, and the padding of 101 rows and keys to 128 costs 60% more
// products.
//
// Design (K2's, with the relative term added per key tile):
// - One block of four warps per (batch*head, 64 query rows); each warp owns
//   16 rows and keeps their Q A-fragments (scaled by scale * log2(e), split
//   into hi and lo) in registers. K and V tiles of 64 keys are double
//   buffered in shared memory by cp.async, at K's row strides.
// - The relative term. For a warp's 16 rows [i0, i0 + 16) and a tile's 64
//   keys [j0, j0 + 64) the offsets i - j lie in a band of 79 values from
//   i0 - j0 - 63. The warp takes R = Q E_band^T (16 x 80) on the tensor cores
//   (E's band rows read through L1, each clamped to +-P, so the clamp costs
//   nothing), writes R to its own shared-memory scratch, and each thread
//   reads its logits' terms along the diagonals, R[r][r - col + 63]. Each
//   scratch row starts at a swizzled offset, so that the 32 lanes of a
//   diagonal read hit 32 banks. R costs 10/8 of Q K^T's products. A
//   per-pair fp32 dot product (E's rows through L1) instead ran 2.7-3.7x
//   slower on an H100 at the cell's shapes.
// - Key mask: the walk is over key tiles at their original positions, so an
//   offset is always i - j of the keys' own indices. A block lists the tiles
//   that hold a kept key of its batch row (a warp ballot per 32 keys) and
//   walks only those; within a tile a masked key's logit is -inf (weight
//   exactly 0, since the tile holds a kept key). A row that keeps no key
//   walks every tile with every logit -1e30, as the plain version: it
//   averages V over its N keys. CMGAN's time mask keeps a prefix, so a row
//   walks ceil(kept / 64) tiles.
// - Online softmax in base 2 and the P V product are K2's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "max_smem.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;    // query rows per block, 16 per warp
constexpr int BK = 64;            // keys per tile
constexpr int BAND = BK + 16;     // offsets a warp's 16 rows see in a tile (79, padded)
constexpr int LDR = 112;          // floats a scratch row of R (80 used, 31 of swizzle)
constexpr float MASKED = -1e30f;  // a masked key's logit in a row that keeps none

// The scratch row r of R starts at r * LDR + swizzle(r): the thread of
// quad g reads row g (and g + 8) at column g + const - 2t - c, so with the
// row starts at 0, 8, 16, 24, 1, 9, 17, 25 banks past their row index the
// reads of one instruction fill all 32 banks.
__device__ __forceinline__ int r_row(int r) {
  const int i = r & 7, lead = 8 * (i & 3) + (i >> 2);
  return r * LDR + ((lead - i - r * LDR) & 31);
}

template <int D>
constexpr size_t tile_bytes() {
  return sizeof(float) * (2 * BK * ((D + 8) + (D + 4)) + WARPS * 16 * LDR);
}

inline size_t list_bytes(int n) {
  const int nw = (n + 31) / 32, nt = (n + BK - 1) / BK;
  return sizeof(uint32_t) * nw + sizeof(int) * nt;
}

// Three blocks (twelve warps) an SM: at four, the 128-register cap spilled
// and the kernel ran 0.5-3.8% slower on an H100 (162 registers at three).
template <int D>
__global__ void __launch_bounds__(THREADS, 3)
attention_relpos_fwd_kernel(const float* __restrict__ q,    // [G, N, D]
                            const float* __restrict__ k,    // [G, N, D]
                            const float* __restrict__ v,    // [G, N, D]
                            const float* __restrict__ emb,  // [2P + 1, D]
                            const unsigned char* __restrict__ key_mask,  // [B, N] or null
                            float* __restrict__ out,        // [G, N, D]
                            int heads, int n, int max_pos, float qscale, int row_blocks) {
  constexpr int LDK = D + 8, LDV = D + 4;
  constexpr int KS = D / 8;    // k-steps of S = Q K^T and of R = Q E^T
  constexpr int NT = BK / 8;   // 8-key column tiles of S, k-steps of P V
  constexpr int NB = BAND / 8; // 8-offset column tiles of R
  constexpr int DT = D / 8;    // 8-wide column tiles of O
  constexpr int CH = D / 4;    // 16-byte chunks of a K or V row

  extern __shared__ float4 smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [2][BK][LDK]
  float* vs = ks + 2 * BK * LDK;               // [2][BK][LDV]
  float* rs = vs + 2 * BK * LDV;               // [WARPS][16 rows at r_row]
  uint32_t* words = reinterpret_cast<uint32_t*>(rs + WARPS * 16 * LDR);  // kept-key ballots
  const int nw = (n + 31) / 32;
  int* tiles = reinterpret_cast<int*>(words + nw);  // the walked tiles
  __shared__ int n_walk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rblk = blockIdx.x % row_blocks;
  const long grp = blockIdx.x / row_blocks;
  const long base = grp * n * D;
  const unsigned char* mrow = key_mask ? key_mask + (grp / heads) * n : nullptr;
  const int ntiles = (n + BK - 1) / BK;

  // The tiles to walk: with a mask those holding a kept key, in order; a row
  // keeping none walks all of them at -1e30 (all_masked).
  int count = ntiles;
  bool listed = false, all_masked = false;
  if (mrow) {
    for (int c = warp; c < nw; c += WARPS) {
      const int j = c * 32 + lane;
      const uint32_t b = __ballot_sync(0xffffffffu, j < n && mrow[j]);
      if (lane == 0) words[c] = b;
    }
    __syncthreads();
    if (warp == 0) {
      int carry = 0;
      for (int t0 = 0; t0 < ntiles; t0 += 32) {
        const int tt = t0 + lane;
        const bool any = tt < ntiles &&
                         (words[2 * tt] != 0u || (2 * tt + 1 < nw && words[2 * tt + 1] != 0u));
        const uint32_t b = __ballot_sync(0xffffffffu, any);
        if (any) tiles[carry + __popc(b & ((1u << lane) - 1u))] = tt;
        carry += __popc(b);
      }
      if (lane == 0) n_walk = carry;
    }
    __syncthreads();
    if (n_walk > 0) {
      count = n_walk;
      listed = true;
    } else {
      all_masked = true;
    }
  }
  auto tile_at = [&](int st) { return listed ? tiles[st] : st; };

  auto load_tile = [&](int st, int buf) {
    const int j0 = tile_at(st) * BK;
    float* kd = ks + buf * BK * LDK;
    float* vd = vs + buf * BK * LDV;
    static_assert(BK * CH % THREADS == 0, "whole rounds of 16-byte copies");
#pragma unroll
    for (int it = 0; it < BK * CH / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / CH, c = i % CH;
      const bool in = j0 + r < n;
      const long key = in ? j0 + r : 0;
      cp_async16(kd + r * LDK + c * 4, k + base + key * D + c * 4, in);
      cp_async16(vd + r * LDV + c * 4, v + base + key * D + c * 4, in);
    }
    cp_async_commit();
  };

  // Q's A fragments: rows g and g + 8 of the warp's 16, columns 2t and
  // 2t + 1 of each k-step (a0, a2 and a1, a3), scaled and split once.
  const int i0 = rblk * BM + warp * 16;
  const int ra = i0 + g, rb = ra + 8;
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int col = kk * 8 + 2 * t;
    const float2 x = ra < n ? *reinterpret_cast<const float2*>(q + base + static_cast<long>(ra) * D + col)
                            : make_float2(0.f, 0.f);
    const float2 y = rb < n ? *reinterpret_cast<const float2*>(q + base + static_cast<long>(rb) * D + col)
                            : make_float2(0.f, 0.f);
    split(x.x * qscale, qh[kk][0], ql[kk][0]);
    split(y.x * qscale, qh[kk][1], ql[kk][1]);
    split(x.y * qscale, qh[kk][2], ql[kk][2]);
    split(y.y * qscale, qh[kk][3], ql[kk][3]);
  }

  float* const rwa = rs + warp * 16 * LDR + r_row(g);  // this warp's R scratch, rows g
  float* const rwb = rs + warp * 16 * LDR + r_row(g + 8);  // and g + 8

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their sums

  float s[NT][4];
  load_tile(0, 0);
  for (int st = 0; st < count; ++st) {
    const int buf = st & 1;
    if (st + 1 < count) {
      load_tile(st + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = tile_at(st) * BK;
    const float* kt = ks + buf * BK * LDK;
    const float* vt = vs + buf * BK * LDV;

    // R = Q E_band^T: band column x is offset i0 - j0 - 63 + x, E's row
    // clamped; written to the warp's scratch
    const int d0 = i0 - j0 - 63;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int off = min(max(d0 + nb * 8 + g, -max_pos), max_pos) + max_pos;
      float r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const float2 e = __ldg(reinterpret_cast<const float2*>(emb + static_cast<long>(off) * D + kk * 8 + 2 * t));
        mma3(r, qh[kk], ql[kk], e.x, e.y);
      }
      rwa[nb * 8 + 2 * t] = r[0];
      rwa[nb * 8 + 2 * t + 1] = r[1];
      rwb[nb * 8 + 2 * t] = r[2];
      rwb[nb * 8 + 2 * t + 1] = r[3];
    }

    // S = Q K^T (log2 units)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 b = *reinterpret_cast<const float2*>(kt + (nt * 8 + g) * LDK + kk * 8 + 2 * t);
        mma3(s[nt], qh[kk], ql[kk], b.x, b.y);
      }
    }
    __syncwarp();

    // + the relative term along the diagonals: key column nt * 8 + 2t + c of
    // row g is band column g + 63 - (nt * 8 + 2t + c)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[nt][c] += rwa[g + 63 - 2 * t - nt * 8 - c];
        s[nt][2 + c] += rwb[g + 71 - 2 * t - nt * 8 - c];
      }
    }

    // absent keys (past n), masked keys (-inf), or a row keeping none (-1e30)
    const int lim = n - j0;
    const uint32_t w0 = mrow ? words[j0 >> 5] : ~0u;
    const uint32_t w1 = mrow && (j0 >> 5) + 1 < nw ? words[(j0 >> 5) + 1] : (mrow ? 0u : ~0u);
    if (all_masked || lim < BK || (w0 & w1) != ~0u) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = nt * 8 + 2 * t + c;
          const bool kept = ((nt < 4 ? w0 : w1) >> (col & 31)) & 1u;
          if (col >= lim) {
            s[nt][c] = s[nt][2 + c] = -INFINITY;
          } else if (all_masked) {
            s[nt][c] = s[nt][2 + c] = MASKED;
          } else if (!kept) {
            s[nt][c] = s[nt][2 + c] = -INFINITY;
          }
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        mx0 = fmaxf(mx0, s[nt][c]);
        mx1 = fmaxf(mx1, s[nt][2 + c]);
      }
    }
    // every walked tile holds a kept (or, all masked, a present) key, so the
    // new maxima are finite
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= c0;
      o[dt][1] *= c0;
      o[dt][2] *= c1;
      o[dt][3] *= c1;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[nt][c] = exp2f(s[nt][c] - m0);
        l0 += s[nt][c];
        s[nt][2 + c] = exp2f(s[nt][2 + c] - m1);
        l1 += s[nt][2 + c];
      }
    }

    // O += P V: k-step kk2 is S's column tile kk2, keys 2t and 2t + 1 as
    // columns t and t + 4 of the A fragment
#pragma unroll
    for (int kk2 = 0; kk2 < NT; ++kk2) {
      uint32_t ah[4], al[4];
      split(s[kk2][0], ah[0], al[0]);
      split(s[kk2][2], ah[1], al[1]);
      split(s[kk2][1], ah[2], al[2]);
      split(s[kk2][3], ah[3], al[3]);
      const float* vr = vt + (kk2 * 8 + 2 * t) * LDV + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) mma3(o[dt], ah, al, vr[dt * 8], vr[LDV + dt * 8]);
    }
    __syncthreads();  // the next iteration refills this buffer and the scratch
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0_ = 1.f / l0, i1_ = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    if (ra < n)
      *reinterpret_cast<float2*>(out + base + static_cast<long>(ra) * D + dt * 8 + 2 * t) =
          make_float2(o[dt][0] * i0_, o[dt][1] * i0_);
    if (rb < n)
      *reinterpret_cast<float2*>(out + base + static_cast<long>(rb) * D + dt * 8 + 2 * t) =
          make_float2(o[dt][2] * i1_, o[dt][3] * i1_);
  }
}

template <int D>
size_t smem_bytes(bool masked, int n) {
  return tile_bytes<D>() + (masked ? list_bytes(n) : 0);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* emb,
                   const unsigned char* key_mask, float* out, int groups, int heads, int n,
                   int max_pos, float qscale, cudaStream_t stream) {
  cudaError_t err = allow_max_smem<D>(attention_relpos_fwd_kernel<D>);
  if (err != cudaSuccess) return err;
  const int row_blocks = (n + BM - 1) / BM;
  const long blocks = static_cast<long>(row_blocks) * groups;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  attention_relpos_fwd_kernel<D><<<static_cast<unsigned>(blocks), THREADS,
                                   smem_bytes<D>(key_mask != nullptr, n), stream>>>(
      q, k, v, emb, key_mask, out, heads, n, max_pos, qscale, row_blocks);
  return cudaGetLastError();
}

template <int D>
cudaError_t info(int n, int masked, int* regs, int* local_bytes, int* smem, int* blocks_per_sm) {
  cudaError_t err = allow_max_smem<D>(attention_relpos_fwd_kernel<D>);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, attention_relpos_fwd_kernel<D>);
  if (err != cudaSuccess) return err;
  const size_t bytes = smem_bytes<D>(masked != 0, n);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem = static_cast<int>(bytes + attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                       attention_relpos_fwd_kernel<D>, THREADS,
                                                       bytes);
}

}  // namespace

// q/k/v/out: [groups = batch*heads, n, d] contiguous, 16-byte aligned; emb:
// [2 * max_pos + 1, d]; key_mask: [batch, n] bytes (nonzero = attend) or
// null; qscale: the softmax scale times log2(e). d = 16.
extern "C" int sevit_attention_relpos_fwd(const float* q, const float* k, const float* v,
                                          const float* emb, const unsigned char* key_mask,
                                          float* out, int groups, int heads, int n, int d,
                                          int max_pos, float qscale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (max_pos < 0) return cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return launch<16>(q, k, v, emb, key_mask, out, groups, heads, n, max_pos, qscale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Registers and local (spill) bytes per thread, shared memory per block and
// resident blocks per SM of the instance for head dim d at n keys.
extern "C" int sevit_attention_relpos_info(int d, int n, int masked, int* regs, int* local_bytes,
                                           int* smem, int* blocks_per_sm) {
  switch (d) {
    case 16: return info<16>(n, masked, regs, local_bytes, smem, blocks_per_sm);
    default: return cudaErrorInvalidValue;
  }
}
