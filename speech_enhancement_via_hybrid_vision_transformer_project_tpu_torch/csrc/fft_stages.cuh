// Shared-memory Stockham FFT, shared by K1 (csrc/stft.cu) and K3
// (csrc/istft.cu).
//
// A block transforms `frames` complex signals of M points, M = 2^a 3^b 5^c.
// The stages follow a radix plan made once on the host
// (ops/cuda_stft.py:fft_stages) and passed in as one int, RADIX_BITS bits a
// stage, the first stage in the low bits: radix 16 while 16 divides what is
// left of M's power of two, then 8, 4 or 2 for the rest of it (a power of
// two M: 4s, then a 2), then the 5s, then the 3s (M = 256: 16, 16;
// M = 128: 16, 4, 2; M = 200: 8, 5, 5; M = 160: 16, 2, 5). Each stage is
// one radix-R butterfly per thread, its R points held in registers.
// Stockham's autosort leaves the result in natural order, with no digit
// reversal; since every thread holds its whole butterfly in registers, a
// barrier between reads and writes lets each stage work in place in one
// buffer, which halves the shared memory of a two-buffer ping-pong. In a
// stage of stride s (the product of the earlier radices), butterfly
// j = p * s + q of a frame reads x[j + c * M/R] (c < R: contiguous across a
// warp), takes the R-point DFT, multiplies output c by W_M^{c p s}
// (c p s < M: no modulo) and writes it to y[q + s * (R p + c)].
//
// A stage takes at most one butterfly a thread: M/R <= blockDim for every
// stage, which the host plan guarantees (the route refuses an M with a
// larger stage) and the C entries check. Where M is a power of two
// (POW2), every division and remainder by a stage's sizes is a shift and a
// mask, and the stages are the radix-16, 4 and 2 ones alone: a radix-8 case
// beside them doubled K1's registers and made K3 spill under its register
// cap (nvcc -Xptxas=-v). Elsewhere the sizes are divided as integers.
//
// Layout: frame t's point i lives at float2 offset t * rs + pad16(i), with
// rs = fft_row_stride(M). pad16 adds one slot per 16 points so that the
// stride-16 writes of a radix-16 stage fall in different banks, and the
// odd row stride spreads a column of frames (one bin of every frame) over
// the banks.
//
// tw[k] = exp(-2 pi i k / M), k < M, built in float64 and rounded to fp32
// once on the host; the inverse reads it conjugated. The constants of the
// butterflies are the fp32 roundings of cos and sin of multiples of pi/8,
// of 2 pi/5 and 4 pi/5, and of 2 pi/3. No scaling is applied.

#pragma once

#include <cuda_runtime.h>

constexpr int RADIX_BITS = 5;  // bits of one stage's radix in the packed plan

__host__ __device__ constexpr int fft_row_stride(int m) { return m + (m >> 4) + 1; }

// Whether `radices` is a plan K1 and K3 run for an M-point FFT: every radix
// one of 16, 8, 4, 2, 5 and 3 (not 8 where M is a power of two), their
// product M, no stage with more butterflies a frame than `threads`.
inline bool fft_plan_ok(int m, int radices, int threads) {
  const bool pow2 = (m & (m - 1)) == 0;
  int prod = 1;
  for (int plan = radices; plan; plan >>= RADIX_BITS) {
    const int r = plan & ((1 << RADIX_BITS) - 1);
    if (r != 16 && r != 8 && r != 4 && r != 2 && r != 5 && r != 3) return false;
    if (r == 8 && pow2) return false;
    if (m % r || m / r > threads) return false;
    prod *= r;
  }
  return prod == m;
}

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

// (s a) times -i forward, +i inverse
template <bool INV>
__device__ __forceinline__ float2 mul_mis(float2 a, float s) {
  return mul_mi<INV>(make_float2(s * a.x, s * a.y));
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

// In-place R-point DFT of x[0..R). Output k lands in register slot(k):
// R = 16 as 4 x 4 (n = 4 n1 + n2, k = k1 + 4 k2) in slot 4 k1 + k2, R = 8
// as 4 x 2 (n = 2 n1 + n2, k = k1 + 4 k2) in slot 2 k1 + k2; the others in
// slot k.
template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&x)[R]) {
  constexpr float R2 = 0.707106781186547524f;  // cos(pi/4)
  if constexpr (R == 2) {
    const float2 a = x[0];
    x[0] = cadd(a, x[1]);
    x[1] = csub(a, x[1]);
  } else if constexpr (R == 3) {
    constexpr float S3 = 0.866025403784438647f;  // sin(2 pi/3); cos(2 pi/3) = -1/2
    const float2 a = cadd(x[1], x[2]);
    const float2 b = mul_mis<INV>(csub(x[1], x[2]), S3);
    const float2 m = make_float2(x[0].x - 0.5f * a.x, x[0].y - 0.5f * a.y);
    x[0] = cadd(x[0], a);
    x[1] = cadd(m, b);
    x[2] = csub(m, b);
  } else if constexpr (R == 4) {
    dft4<INV>(x[0], x[1], x[2], x[3]);
  } else if constexpr (R == 5) {
    constexpr float C1 = 0.309016994374947424f;   // cos(2 pi/5)
    constexpr float C2 = -0.809016994374947424f;  // cos(4 pi/5)
    constexpr float S1 = 0.951056516295153572f;   // sin(2 pi/5)
    constexpr float S2 = 0.587785252292473129f;   // sin(4 pi/5)
    const float2 a1 = cadd(x[1], x[4]), b1 = csub(x[1], x[4]);
    const float2 a2 = cadd(x[2], x[3]), b2 = csub(x[2], x[3]);
    const float2 x0 = x[0];
    // the real-coefficient parts, then -i (forward) or +i (inverse) times
    // the odd parts
    const float2 m1 = make_float2(x0.x + C1 * a1.x + C2 * a2.x, x0.y + C1 * a1.y + C2 * a2.y);
    const float2 m2 = make_float2(x0.x + C2 * a1.x + C1 * a2.x, x0.y + C2 * a1.y + C1 * a2.y);
    const float2 n1 = mul_mi<INV>(
        make_float2(S1 * b1.x + S2 * b2.x, S1 * b1.y + S2 * b2.y));
    const float2 n2 = mul_mi<INV>(
        make_float2(S2 * b1.x - S1 * b2.x, S2 * b1.y - S1 * b2.y));
    x[0] = cadd(x0, cadd(a1, a2));
    x[1] = cadd(m1, n1);
    x[4] = csub(m1, n1);
    x[2] = cadd(m2, n2);
    x[3] = csub(m2, n2);
  } else if constexpr (R == 8) {
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2) dft4<INV>(x[n2], x[n2 + 2], x[n2 + 4], x[n2 + 6]);
    // slot n2 + 2 k1 times W8^(n2 k1)
    x[3] = w16<INV>(x[3], R2, R2);
    x[5] = mul_mi<INV>(x[5]);
    x[7] = w16<INV>(x[7], -R2, R2);
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      const float2 a = x[2 * k1];
      x[2 * k1] = cadd(a, x[2 * k1 + 1]);
      x[2 * k1 + 1] = csub(a, x[2 * k1 + 1]);
    }
  } else {
    static_assert(R == 16, "radix 16, 8, 5, 4, 3 or 2");
    constexpr float C1 = 0.923879532511286756f;  // cos(pi/8)
    constexpr float S1 = 0.382683432365089772f;  // sin(pi/8)
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
template <int R>
__device__ __forceinline__ constexpr int slot(int c) {
  return R == 16 ? 4 * (c & 3) + (c >> 2) : (R == 8 ? 2 * (c & 3) + (c >> 2) : c);
}

__device__ __forceinline__ int log2_of(int d) { return __ffs(d) - 1; }  // d a power of two

// Division and remainder by d: a shift and a mask where POW2 says d is a
// power of two, else integer arithmetic.
template <bool POW2>
struct Divisor {
  int d, shift;
  __device__ __forceinline__ explicit Divisor(int d_) : d(d_), shift(POW2 ? log2_of(d_) : 0) {}
  __device__ __forceinline__ int div(int x) const { return POW2 ? x >> shift : x / d; }
  __device__ __forceinline__ int mod(int x) const { return POW2 ? x & (d - 1) : x - div(x) * d; }
};

// One radix-R stage of stride s over every frame: inputs through
// load(t, i), outputs to dst (padded layout). The frames go in groups small
// enough for every thread to take at most one butterfly (M/R <= blockDim),
// so a thread holds all it reads in registers: with IN_PLACE, a barrier
// between the group's reads and its writes lets dst be the buffer the loads
// read. Ends with a barrier.
template <int R, bool INV, bool IN_PLACE, bool POW2, class Load>
__device__ __forceinline__ void stockham_stage(Load load, float2* dst, const float2* tw,
                                               int frames, int m, int s, int rs) {
  const Divisor<POW2> nb(m / R), st(s);  // butterflies per frame, stride
  const int group = max(1, nb.div(static_cast<int>(blockDim.x)));
  for (int g0 = 0; g0 < frames; g0 += group) {
    const int i = threadIdx.x;
    const bool active = i < min(group, frames - g0) * nb.d;
    const int t = g0 + nb.div(i);
    const int j = nb.mod(i);
    const int p = st.div(j);
    const int q = st.mod(j);
    float2 x[R];
    if (active) {
#pragma unroll
      for (int c = 0; c < R; ++c) x[c] = load(t, j + c * nb.d);
      dft<R, INV>(x);
    }
    if (IN_PLACE) __syncthreads();
    if (active) {
      float2* y = dst + t * rs;
      const int base = q + p * R * s;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        float2 v = x[slot<R>(c)];
        if (c > 0) {
          float2 w = tw[p * c * s];
          if (INV) w.y = -w.y;
          v = cmul(v, w);
        }
        y[pad16(base + c * s)] = v;
      }
    }
    __syncthreads();
  }
}

// The stage of radix r (16, 4 or 2 where POW2).
template <bool INV, bool IN_PLACE, bool POW2, class Load>
__device__ __forceinline__ void any_stage(int r, Load load, float2* dst, const float2* tw,
                                          int frames, int m, int s, int rs) {
  switch (r) {
    case 16: stockham_stage<16, INV, IN_PLACE, POW2>(load, dst, tw, frames, m, s, rs); break;
    case 4: stockham_stage<4, INV, IN_PLACE, POW2>(load, dst, tw, frames, m, s, rs); break;
    case 2: stockham_stage<2, INV, IN_PLACE, POW2>(load, dst, tw, frames, m, s, rs); break;
    default:
      if constexpr (!POW2) {
        if (r == 8)
          stockham_stage<8, INV, IN_PLACE, false>(load, dst, tw, frames, m, s, rs);
        else if (r == 5)
          stockham_stage<5, INV, IN_PLACE, false>(load, dst, tw, frames, m, s, rs);
        else
          stockham_stage<3, INV, IN_PLACE, false>(load, dst, tw, frames, m, s, rs);
      }
  }
}

// The whole transform of M = m points along the plan `radices`, into
// `buf`. The first stage reads its input through first(t, i) (point i of
// frame t), so the caller fuses its pack into it; FIRST_IN_PLACE says
// whether those reads are of `buf` itself. The later stages work in place
// in `buf`. Every thread of the block must call it.
template <bool INV, bool FIRST_IN_PLACE, bool POW2, class Load>
__device__ void stockham_fft(Load first, float2* buf, const float2* tw, int frames, int m,
                             int radices, int rs) {
  constexpr int MASK = (1 << RADIX_BITS) - 1;
  int s = radices & MASK;
  any_stage<INV, FIRST_IN_PLACE, POW2>(s, first, buf, tw, frames, m, 1, rs);
  for (int plan = radices >> RADIX_BITS; plan; plan >>= RADIX_BITS) {
    const int r = plan & MASK;
    any_stage<INV, true, POW2>(
        r, [buf, rs](int t, int i) { return buf[t * rs + pad16(i)]; }, buf, tw, frames, m, s,
        rs);
    s *= r;
  }
}
