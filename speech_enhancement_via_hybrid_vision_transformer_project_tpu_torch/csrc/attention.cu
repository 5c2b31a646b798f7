// K2 attention_fwd: fused softmax(Q K^T * scale, key mask) V, forward, fp32,
// on Hopper's tensor cores in 3xTF32.
//
// Replaces the TPU kernel _attention_kernel in
// speech_enhancement_via_hybrid_vision_transformer_project_tpu/ops/pallas_attention.py
// (launched by _pallas_attention_3d, reached through fused_attention). The
// TPU kernel keeps a whole [128, N] logit block in VMEM; a GPU block has far
// less fast memory, so this kernel walks the keys in tiles with an online
// softmax (flash-attention 2) and never materializes the logits.
//
// What bounds it on an H100: the two matrix products, 4 * N * D operations
// per query row and key. fp32 accuracy on the tensor cores costs three TF32
// products per fp32 product (3xTF32): x = hi + lo with hi the TF32 rounding
// of x and lo the TF32 rounding of x - hi, and a*b ~ a_lo*b_hi + a_hi*b_lo +
// a_hi*b_hi, the small terms accumulated first (a_lo*b_lo, ~2^-22 of a*b, is
// dropped). So the least time is the operations over a third of the dense
// TF32 rate (165 TFLOP/s); the CUDA cores' fp32 rate is 67 TFLOP/s. That
// dense rate is wgmma's; this kernel's mma.sync stays well below it, and
// each warp issues several other instructions per mma (the hi/lo splits of
// the K and V values it loads, the online softmax) beside it.
//
// Design:
// - One block of four warps per (batch*head, 64 query rows). Each warp owns
//   16 rows and keeps their Q A-fragments in registers, scaled by
//   scale * log2(e) (the softmax runs in base 2) and, for D <= 64, split
//   into hi and lo once.
// - K and V tiles of BK keys are double buffered in shared memory by
//   cp.async (16-byte copies; rows past the last key are zero filled). Row
//   strides of D + 8 (K) and D + 4 (V) floats keep the fragment loads free
//   of bank conflicts. Every warp splits the B values it loads into hi and
//   lo itself. Splitting each value once per block instead, into a second
//   buffer of hi and lo laid out for 16-byte fragment loads, issues fewer
//   instructions but ran slower on an H100 (a split pass between two
//   barriers a tile, and one staging buffer to load the next tile into).
// - S = Q K^T and O += P V are chains of mma.sync m16n8k8 TF32, three per
//   product. Each 8-deep k-step takes its 8 columns in the order
//   0,2,4,6,1,3,5,7 (thread t holds columns 2t and 2t+1 where the fragment
//   layout names t and t+4): a thread's two K values are adjacent (one
//   8-byte load), and the accumulator fragment of S (columns 2t, 2t+1) is
//   the A fragment of P with no shuffle. A sum over k does not depend on the
//   order of its terms.
// - Online softmax in fp32 registers: per row a running max (quad shuffles)
//   and per thread a partial sum; O is rescaled once per tile; the four
//   partial sums of a row meet in the epilogue, which divides by them.
// - Masked keys. With a mask, each block first lists the kept keys of its
//   batch row in shared memory (a warp ballot per 32 keys, a popcount
//   prefix) and gathers only those rows of K and V. In fp32 a masked key's
//   weight is exactly 0 when its row keeps any key, so leaving it out
//   changes nothing but the work. A row that keeps no key walks all N keys,
//   every logit replaced by -1e30 as in sdpa_reference: it averages V over
//   its N keys. Positions past the last key of a tile are -inf. The list
//   takes 4 bytes a key of shared memory; an N whose tiles and list exceed
//   the card's shared memory a block fails to launch.
// - For training, a second instance also writes each row's log-sum-exp,
//   m + log2 l in log2 units, from which the backward (attention_bwd.cu)
//   recomputes the weights.
// - A head dim above 128 (SLICED, the D = 128 instance's tiles and
//   registers): q, k and v are zero-padded to whole 128-column slices, and
//   the grid gets a third dimension, the output's slice. Each block walks
//   its keys tile by tile and, within a tile, the slices of Q and K one
//   step at a time (its own output slice last), summing S = sum_s Q_s K_s^T
//   in registers; Q's fragments are read and split per step (L1 holds the
//   block's rows), not kept. At the last slice it loads its slice of V
//   with that step's K, and the softmax and O += P V_z run as above. Every
//   block of a row recomputes the same S, so the QK^T work grows with the
//   number of slices (2x at D = 256); the registers stay the D = 128
//   instance's (O of 128 columns), and no block holds all of D.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kept_keys.cuh"
#include "max_smem.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 16 * WARPS;    // query rows per block, 16 per warp
constexpr float MASKED = -1e30f;  // a masked key's logit, as sdpa_reference

// Keys per K/V tile: 64, and 32 at D = 128, so that two tiles of K and V
// take ~70 KB of shared memory.
template <int D>
__host__ __device__ constexpr int tile_keys() { return D <= 64 ? 64 : 32; }

template <int D>
constexpr size_t tile_bytes() {
  return sizeof(float) * 2 * tile_keys<D>() * ((D + 8) + (D + 4));
}

// LSE: also write each row's log-sum-exp for the backward. A separate
// instance, so that the serving path (lse null) pays nothing for it.
// Two blocks (eight warps) an SM. A cap of 168 registers for three blocks
// makes the D = 64 instance spill, and it ran slower on an H100.
template <int D, bool LSE, bool SLICED>
__global__ void __launch_bounds__(THREADS, 2)
attention_fwd_kernel(const float* __restrict__ q,   // [G, N, D * slices]
                     const float* __restrict__ k,   // [G, N, D * slices]
                     const float* __restrict__ v,   // [G, N, D * slices]
                     const unsigned char* __restrict__ key_mask,  // [B, N] or null
                     float* __restrict__ out,       // [G, N, D * slices]
                     float* __restrict__ lse,       // [G, N] when LSE
                     int heads, int n, float qscale, int slices) {
  constexpr int BK = tile_keys<D>();
  constexpr int LDK = D + 8, LDV = D + 4;
  constexpr int KS = D / 8;   // k-steps of S = Q K^T
  constexpr int NT = BK / 8;  // 8-key column tiles of S, k-steps of P V
  constexpr int DT = D / 8;   // 8-wide column tiles of O
  constexpr int CH = D / 4;   // 16-byte chunks of a K or V row
  constexpr bool Q_SPLIT = D <= 64;  // Q's hi/lo kept, not recomputed per tile
  static_assert(!SLICED || D == 128, "slices of 128 columns");
  const int ns = SLICED ? slices : 1;  // 128-column slices of the head dim
  const int ld = D * ns;               // row stride of q, k, v and out
  const int zo = SLICED ? static_cast<int>(blockIdx.z) * D : 0;  // the output slice's column

  extern __shared__ float4 smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [2][BK][LDK]
  float* vs = ks + 2 * BK * LDK;               // [2][BK][LDV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long base = static_cast<long>(blockIdx.y) * n * ld;
  const unsigned char* mrow =
      key_mask ? key_mask + static_cast<long>(blockIdx.y / heads) * n : nullptr;

  // The keys the block walks: its batch row's kept keys (gathered through
  // `kept`), or all n of them, unmasked or (`all_masked`) each at -1e30.
  int count = n;
  bool all_masked = false;
  const int* kept = nullptr;
  if (mrow) {
    const int n_kept = list_kept_keys<WARPS>(mrow, n, vs + 2 * BK * LDV, &kept);
    if (n_kept > 0) {
      count = n_kept;
    } else {
      kept = nullptr;
      all_masked = true;
    }
  }

  // step st walks key tile st / ns and, of Q and K, slice slice_at(st % ns):
  // the block's output slice comes last, and only then is V (its slice)
  // loaded, into the same buffer as that step's K
  auto slice_at = [&](int i) { return SLICED ? (static_cast<int>(blockIdx.z) + 1 + i) % ns : 0; };
  auto load_tile = [&](int st, int buf) {
    const int i_s = SLICED ? st % ns : 0;
    const int j0 = (SLICED ? st / ns : st) * BK;
    const int ko = slice_at(i_s) * D;
    const bool with_v = i_s == ns - 1;
    float* kd = ks + buf * BK * LDK;
    float* vd = vs + buf * BK * LDV;
    static_assert(BK * CH % THREADS == 0, "whole rounds of 16-byte copies");
#pragma unroll
    for (int it = 0; it < BK * CH / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / CH, c = i % CH;
      const int p = j0 + r;
      const bool in = p < count;
      const long key = in ? (kept ? kept[p] : p) : 0;
      cp_async16(kd + r * LDK + c * 4, k + base + key * ld + ko + c * 4, in);
      if (with_v) cp_async16(vd + r * LDV + c * 4, v + base + key * ld + zo + c * 4, in);
    }
    cp_async_commit();
  };

  // Q's A fragments: rows g and g + 8 of the warp's 16, columns 2t and
  // 2t + 1 of each k-step (a0, a2 and a1, a3).
  const int ra = blockIdx.x * BM + warp * 16 + g, rb = ra + 8;
  // (SLICED: read per step instead, at the step's slice)
  auto q_frag = [&](int col, float (&f)[4]) {
    const float2 x = ra < n ? *reinterpret_cast<const float2*>(q + base + static_cast<long>(ra) * ld + col)
                            : make_float2(0.f, 0.f);
    const float2 y = rb < n ? *reinterpret_cast<const float2*>(q + base + static_cast<long>(rb) * ld + col)
                            : make_float2(0.f, 0.f);
    f[0] = x.x * qscale;
    f[1] = y.x * qscale;
    f[2] = x.y * qscale;
    f[3] = y.y * qscale;
  };
  float qf[SLICED ? 1 : KS][4];
  if constexpr (!SLICED) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) q_frag(kk * 8 + 2 * t, qf[kk]);
  }
  uint32_t qh[Q_SPLIT ? KS : 1][4], ql[Q_SPLIT ? KS : 1][4];
  if constexpr (Q_SPLIT) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) split(qf[kk][e], qh[kk][e], ql[kk][e]);
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their sums

  const int ntiles = (count + BK - 1) / BK;
  const int nsteps = ntiles * ns;
  float s[NT][4];
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
    const float* kt = ks + buf * BK * LDK;
    const float* vt = vs + buf * BK * LDV;

    // S = Q K^T (log2 units), summed over the slices of a tile's steps
    if (i_s == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (SLICED) {
        float f[4];
        q_frag(slice_at(i_s) * D + kk * 8 + 2 * t, f);
#pragma unroll
        for (int e = 0; e < 4; ++e) split(f[e], ah[e], al[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (Q_SPLIT) {
            ah[e] = qh[kk][e];
            al[e] = ql[kk][e];
          } else {
            split(qf[kk][e], ah[e], al[e]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 b = *reinterpret_cast<const float2*>(kt + (nt * 8 + g) * LDK + kk * 8 + 2 * t);
        mma3(s[nt], ah, al, b.x, b.y);
      }
    }
    if (i_s != ns - 1) {  // more slices of this tile to sum
      __syncthreads();    // the next iteration refills this buffer
      continue;
    }

    // masks (a full tile of kept or unmasked keys has none), row max, rescale
    const int lim = count - tile * BK;  // positions present in this tile
    if (all_masked || lim < BK) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = nt * 8 + 2 * t + c;
          if (col >= lim) {
            s[nt][c] = s[nt][2 + c] = -INFINITY;
          } else if (all_masked) {
            s[nt][c] = s[nt][2 + c] = MASKED;
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
    // every tile holds a present key, so the new maxima are finite
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
    __syncthreads();  // the next iteration refills this buffer
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    if (ra < n)
      *reinterpret_cast<float2*>(out + base + static_cast<long>(ra) * ld + zo + dt * 8 + 2 * t) =
          make_float2(o[dt][0] * i0, o[dt][1] * i0);
    if (rb < n)
      *reinterpret_cast<float2*>(out + base + static_cast<long>(rb) * ld + zo + dt * 8 + 2 * t) =
          make_float2(o[dt][2] * i1, o[dt][3] * i1);
  }
  // the log-sum-exp of each row's logits in log2 units (m + log2 l), which
  // the backward (attention_bwd.cu) recomputes the weights from (every
  // slice's block computes the same; the first writes it)
  if (LSE && t == 0 && (!SLICED || blockIdx.z == 0)) {
    if (ra < n) lse[blockIdx.y * static_cast<long>(n) + ra] = m0 + log2f(l0);
    if (rb < n) lse[blockIdx.y * static_cast<long>(n) + rb] = m1 + log2f(l1);
  }
}

// The block's dynamic shared memory: two K/V tiles, and the kept-key list
// with a mask.
template <int D>
size_t smem_bytes(bool masked, int n) {
  return tile_bytes<D>() + (masked ? kept_list_bytes(n) : 0);
}

// Lets both instances take all the shared memory a block may have on the
// current device (max_smem.cuh).
template <int D, bool SLICED>
cudaError_t configure() {
  return allow_max_smem<SLICED ? -D : D>(attention_fwd_kernel<D, false, SLICED>,
                                         attention_fwd_kernel<D, true, SLICED>);
}

// slices: 128-column slices of the head dim (SLICED), else 1
template <int D, bool SLICED = false>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const unsigned char* key_mask, float* out, float* lse, int groups,
                   int heads, int n, float qscale, cudaStream_t stream, int slices = 1) {
  cudaError_t err = configure<D, SLICED>();
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM, groups, slices);
  const size_t smem = smem_bytes<D>(key_mask != nullptr, n);
  if (lse)
    attention_fwd_kernel<D, true, SLICED><<<grid, THREADS, smem, stream>>>(
        q, k, v, key_mask, out, lse, heads, n, qscale, slices);
  else
    attention_fwd_kernel<D, false, SLICED><<<grid, THREADS, smem, stream>>>(
        q, k, v, key_mask, out, nullptr, heads, n, qscale, slices);
  return cudaGetLastError();
}

template <int D, bool SLICED = false>
cudaError_t info(int n, int masked, int* regs, int* local_bytes, int* smem,
                 int* blocks_per_sm) {
  cudaError_t err = configure<D, SLICED>();
  if (err != cudaSuccess) return err;
  const auto kernel = attention_fwd_kernel<D, false, SLICED>;  // the serving instance
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const size_t bytes = smem_bytes<D>(masked != 0, n);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem = static_cast<int>(bytes + attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS, bytes);
}

}  // namespace

// q/k/v/out: [groups = batch*heads, n, d] contiguous, 16-byte aligned;
// key_mask: [batch, n] bytes (nonzero = attend) or null; lse: [groups, n]
// or null (the serving path), each row's log-sum-exp in log2 units for the
// backward; qscale: the softmax scale times log2(e). d in {16, 32, 64, 128},
// or a multiple of 128 above it (the sliced instance).
extern "C" int sevit_attention_fwd(const float* q, const float* k,
                                   const float* v, const unsigned char* key_mask,
                                   float* out, float* lse, int groups, int heads, int n,
                                   int d, float qscale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, key_mask, out, lse, groups, heads, n, qscale, s);
    case 32: return launch<32>(q, k, v, key_mask, out, lse, groups, heads, n, qscale, s);
    case 64: return launch<64>(q, k, v, key_mask, out, lse, groups, heads, n, qscale, s);
    case 128: return launch<128>(q, k, v, key_mask, out, lse, groups, heads, n, qscale, s);
    default:
      if (d <= 128 || d % 128) return cudaErrorInvalidValue;
      return launch<128, true>(q, k, v, key_mask, out, lse, groups, heads, n, qscale, s,
                               d / 128);
  }
}

// Registers and local (spill) bytes per thread, shared memory per block and
// resident blocks per SM of the instance for head dim d at n keys, with or
// without a mask (d above 128: the sliced instance).
extern "C" int sevit_attention_info(int d, int n, int masked, int* regs, int* local_bytes,
                                    int* smem, int* blocks_per_sm) {
  switch (d) {
    case 16: return info<16>(n, masked, regs, local_bytes, smem, blocks_per_sm);
    case 32: return info<32>(n, masked, regs, local_bytes, smem, blocks_per_sm);
    case 64: return info<64>(n, masked, regs, local_bytes, smem, blocks_per_sm);
    case 128: return info<128>(n, masked, regs, local_bytes, smem, blocks_per_sm);
    default:
      if (d <= 128 || d % 128) return cudaErrorInvalidValue;
      return info<128, true>(n, masked, regs, local_bytes, smem, blocks_per_sm);
  }
}
