// Shared-memory Stockham FFT, shared by K1 (csrc/stft.cu) and K3
// (csrc/istft.cu).
//
// A block transforms `frames` complex signals of M = 2^log2m points. Each
// stage is one radix-R butterfly per thread (R = 16 while four or more
// bits of M are left, then 4, then 2), its R points held in registers, so
// M = 256 takes two passes through shared memory. Stockham's autosort
// leaves the result in natural order, with no bit reversal; since every
// thread holds its whole butterfly in registers, a barrier between reads
// and writes lets each stage work in place in one buffer, which halves the
// shared memory of a two-buffer ping-pong. In a stage of stride s (the
// product of the earlier radices), butterfly j = p * s + q of a frame reads
// x[j + c * M/R]
// (c < R: contiguous across a warp), takes the R-point DFT, multiplies
// output c by W_M^{c p s} and writes it to y[q + s * (R p + c)].
//
// Layout: frame t's point i lives at float2 offset t * rs + pad16(i), with
// rs = fft_row_stride(M). pad16 adds one slot per 16 points so that the
// stride-16 writes of a radix-16 stage fall in different banks, and the
// odd row stride spreads a column of frames (one bin of every frame) over
// the banks.
//
// tw[k] = exp(-2 pi i k / M), k < M, built in float64 and rounded to fp32
// once on the host; the inverse reads it conjugated. The constants of the
// radix-16 butterfly are the fp32 roundings of cos and sin of multiples of
// pi/8. No scaling is applied.

#pragma once

#include <cuda_runtime.h>

__host__ __device__ constexpr int fft_row_stride(int m) { return m + (m >> 4) + 1; }

__device__ __forceinline__ int pad16(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * exp(-+2 pi i e / 16) given cos and sin of 2 pi e / 16: the sign of
// the exponent is - for the forward transform, + for the inverse
template <bool INV>
__device__ __forceinline__ float2 w16(float2 a, float c, float s) {
  return cmul(a, make_float2(c, INV ? s : -s));
}

// -i a forward, +i a inverse
template <bool INV>
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c, float2& d) {
  const float2 apc = cadd(a, c), amc = csub(a, c), bpd = cadd(b, d);
  const float2 jb = mul_mi<INV>(csub(b, d));
  a = cadd(apc, bpd);
  b = cadd(amc, jb);
  c = csub(apc, bpd);
  d = csub(amc, jb);
}

// In-place R-point DFT of x[0..R). For R = 16 (as 4 x 4: n = 4 n1 + n2,
// k = k1 + 4 k2) output k lands in slot 4 (k % 4) + k / 4; see slot().
template <int LOG2R, bool INV>
__device__ __forceinline__ void dft(float2 (&x)[1 << LOG2R]) {
  if constexpr (LOG2R == 1) {
    const float2 a = x[0];
    x[0] = cadd(a, x[1]);
    x[1] = csub(a, x[1]);
  } else if constexpr (LOG2R == 2) {
    dft4<INV>(x[0], x[1], x[2], x[3]);
  } else {
    constexpr float C1 = 0.923879532511286756f;  // cos(pi/8)
    constexpr float S1 = 0.382683432365089772f;  // sin(pi/8)
    constexpr float R2 = 0.707106781186547524f;  // cos(pi/4)
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) dft4<INV>(x[n2], x[n2 + 4], x[n2 + 8], x[n2 + 12]);
    // slot n2 + 4 k1 times W16^(n2 k1)
    x[5] = w16<INV>(x[5], C1, S1);
    x[6] = w16<INV>(x[6], R2, R2);
    x[7] = w16<INV>(x[7], S1, C1);
    x[9] = w16<INV>(x[9], R2, R2);
    x[10] = mul_mi<INV>(x[10]);
    x[11] = w16<INV>(x[11], -R2, R2);
    x[13] = w16<INV>(x[13], S1, C1);
    x[14] = w16<INV>(x[14], -R2, R2);
    x[15] = w16<INV>(x[15], -C1, -S1);
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) dft4<INV>(x[4 * k1], x[4 * k1 + 1], x[4 * k1 + 2], x[4 * k1 + 3]);
  }
}

// register slot of DFT output c
template <int LOG2R>
__device__ __forceinline__ constexpr int slot(int c) {
  return LOG2R == 4 ? 4 * (c & 3) + (c >> 2) : c;
}

// One radix-2^LOG2R stage over every frame: inputs through load(t, i),
// outputs to dst (padded layout). The frames go in groups small enough for
// every thread to take at most one butterfly (M/R <= blockDim for every
// stage of M <= 1024), so a thread holds all it reads in registers: with
// IN_PLACE, a barrier between the group's reads and its writes lets dst be
// the buffer the loads read. Ends with a barrier.
template <int LOG2R, bool INV, bool IN_PLACE, class Load>
__device__ __forceinline__ void stockham_stage(Load load, float2* dst, const float2* tw,
                                               int frames, int log2m, int log2s, int rs) {
  constexpr int R = 1 << LOG2R;
  const int log2nb = log2m - LOG2R;  // butterflies per frame
  const int nb = 1 << log2nb;
  const int s = 1 << log2s;
  const int group = max(1, static_cast<int>(blockDim.x) >> log2nb);
  for (int g0 = 0; g0 < frames; g0 += group) {
    const int i = threadIdx.x;
    const bool active = i < (min(group, frames - g0) << log2nb);
    const int t = g0 + (i >> log2nb);
    const int j = i & (nb - 1);
    const int p = j >> log2s;
    const int q = j & (s - 1);
    float2 x[R];
    if (active) {
#pragma unroll
      for (int c = 0; c < R; ++c) x[c] = load(t, j + c * nb);
      dft<LOG2R, INV>(x);
    }
    if (IN_PLACE) __syncthreads();
    if (active) {
      float2* y = dst + t * rs;
      const int base = q + (p << (LOG2R + log2s));  // q + s R p
#pragma unroll
      for (int c = 0; c < R; ++c) {
        float2 v = x[slot<LOG2R>(c)];
        if (c > 0) {
          float2 w = tw[(p * c) << log2s];
          if (INV) w.y = -w.y;
          v = cmul(v, w);
        }
        y[pad16(base + (c << log2s))] = v;
      }
    }
    __syncthreads();
  }
}

template <bool INV, bool IN_PLACE, class Load>
__device__ __forceinline__ void any_stage(int log2r, Load load, float2* dst, const float2* tw,
                                          int frames, int log2m, int log2s, int rs) {
  if (log2r == 4) {
    stockham_stage<4, INV, IN_PLACE>(load, dst, tw, frames, log2m, log2s, rs);
  } else if (log2r == 2) {
    stockham_stage<2, INV, IN_PLACE>(load, dst, tw, frames, log2m, log2s, rs);
  } else {
    stockham_stage<1, INV, IN_PLACE>(load, dst, tw, frames, log2m, log2s, rs);
  }
}

__device__ __forceinline__ int next_log2r(int left) { return left >= 4 ? 4 : (left >= 2 ? 2 : 1); }

// The whole transform, into `buf`. The first stage reads its input through
// first(t, i) (point i of frame t), so the caller fuses its pack into it;
// FIRST_IN_PLACE says whether those reads are of `buf` itself. The later
// stages work in place in `buf`. Every thread of the block must call it.
template <bool INV, bool FIRST_IN_PLACE, class Load>
__device__ void stockham_fft(Load first, float2* buf, const float2* tw, int frames, int log2m,
                             int rs) {
  int log2r = next_log2r(log2m);
  any_stage<INV, FIRST_IN_PLACE>(log2r, first, buf, tw, frames, log2m, 0, rs);
  for (int log2s = log2r; log2s < log2m; log2s += log2r) {
    log2r = next_log2r(log2m - log2s);
    any_stage<INV, true>(
        log2r, [buf, rs](int t, int i) { return buf[t * rs + pad16(i)]; }, buf, tw, frames,
        log2m, log2s, rs);
  }
}
