// selective_scan: Mamba-1's selective scan, forward only, fp32, over
// length-masked sequences in either direction: for each sequence g, channel
// d and state n, from a zero state,
//
//   delta_t = softplus(delta_t + delta_bias_d)      (x for x > 20, as F.softplus)
//   h_t     = exp(delta_t * A_dn) h_{t-1} + delta_t B_tn u_t,  A = -exp(A_log)
//   y_t     = (sum_n C_tn h_t + D_d u_t) * silu(z_t)
//
// over the first n_valid[g] steps of the sequence, t = 0 .. n_valid - 1, or
// with `reverse` t = n_valid - 1 .. 0 (the state then starts at the row's
// last valid step, and y is written at the steps' own places, so the
// backward direction of a bidirectional block needs no flipped copies);
// y is 0 at the padded steps t >= n_valid. This is mamba_ssm's
// selective_scan_fn(u, delta, A, B, C, D, z, delta_bias, delta_softplus=True)
// on each sequence's valid prefix (reversed where asked).
//
// Ports no TPU kernel: the JAX package has no SEMamba. It was added for the
// TFMamba blocks of SEMamba's generator (arXiv:2405.06573), which run 16
// such scans a forward: 4 blocks x time and frequency x both directions.
//
// What bounds it on an H100: bytes, and the SFU nearly as much. Each valid
// step of a sequence reads u, delta and z (d_inner floats each) and B, C
// (d_state each) and writes y (d_inner): 4.2 KB a step at d_inner 256,
// d_state 16. Each (step, channel) takes d_state exponentials, and the
// softplus and SiLU three more, on the SFU's 16 a clock an SM.
//
// Design:
// - Layout token-major, as the model's linear layers leave it: u, delta, y
//   [seqs, steps, channels]; z and B, C are strided views of the in_proj and
//   x_proj outputs (a token's z every z_stride floats, its B and C every
//   bc_stride floats), read in place with no split copies.
// - One thread a channel of one sequence, its d_state states in registers,
//   the steps in order inside the thread: a block is 128 channels of one
//   sequence (the grid's x the sequence, its y the channel group). The
//   cell's scans have 3,200 to 52,416 sequences of 256 channels, far more
//   threads than the card holds, so no scan across threads is needed and
//   the recurrence rounds as the plain version's sequential loop does.
// - A warp's 32 channels of one step are 128 contiguous bytes of u, delta,
//   z and y: every such access is one full line. B and C of a step are the
//   same for every channel: float4 loads that a warp broadcasts and the
//   block's other warps find in L1.
// - Four steps' u, delta and z are loaded before any of them is used, so
//   each thread keeps 12 loads in flight ahead of its dependent chain.
// - exp(delta A) as exp2f(delta * A log2(e)), A log2(e) computed once a
//   thread; expf, log1pf and exp2f IEEE (no fast math).
// - 64-bit offsets: the largest time scan's z view spans 3.4G floats.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;  // channels a block
constexpr int UNROLL = 4;     // steps whose loads are issued together
constexpr float LOG2E = 1.4426950408889634f;

template <int N>
struct Scan {
  const float* u;
  const float* delta;
  const float* z;
  const float* b;
  const float* c;
  float* y;
  long channels;
  long z_stride;
  long bc_stride;
  float a2[N];  // A log2(e)
  float h[N];
  float d_skip;
  float bias;

  __device__ __forceinline__ void step(long tok, float uv, float dv, float zv) {
    float dl = dv + bias;
    dl = dl <= 20.f ? log1pf(expf(dl)) : dl;
    const float du = dl * uv;
    const float4* bp = reinterpret_cast<const float4*>(b + tok * bc_stride);
    const float4* cp = reinterpret_cast<const float4*>(c + tok * bc_stride);
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 b4 = __ldg(bp + q);
      const float4 c4 = __ldg(cp + q);
      const float bs[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = 4 * q + k;
        h[n] = exp2f(dl * a2[n]) * h[n] + du * bs[k];
        acc = fmaf(cs[k], h[n], acc);
      }
    }
    const float out = acc + uv * d_skip;
    y[tok * channels] = out * (zv / (1.f + expf(-zv)));
  }
};

template <int N>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                      const float* __restrict__ z, const float* __restrict__ b,
                      const float* __restrict__ c, const float* __restrict__ a_log,
                      const float* __restrict__ d_skip, const float* __restrict__ delta_bias,
                      const int* __restrict__ n_valid, float* __restrict__ y, int steps,
                      int channels, long z_stride, long bc_stride, int reverse) {
  const int d = blockIdx.y * THREADS + threadIdx.x;
  if (d >= channels) return;
  const long seq = static_cast<long>(blockIdx.x) * steps;  // the sequence's first token
  const int n = n_valid == nullptr ? steps : min(max(n_valid[blockIdx.x], 0), steps);

  Scan<N> s;
  s.u = u + d;
  s.delta = delta + d;
  s.z = z + d;
  s.b = b;
  s.c = c;
  s.y = y + d;
  s.channels = channels;
  s.z_stride = z_stride;
  s.bc_stride = bc_stride;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s.a2[i] = -expf(a_log[static_cast<long>(d) * N + i]) * LOG2E;
    s.h[i] = 0.f;
  }
  s.d_skip = d_skip[d];
  s.bias = delta_bias[d];

  int i = 0;
  for (; i + UNROLL <= n; i += UNROLL) {
    float uv[UNROLL], dv[UNROLL], zv[UNROLL];
    long tok[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      tok[k] = seq + (reverse ? n - 1 - (i + k) : i + k);
      uv[k] = __ldg(s.u + tok[k] * channels);
      dv[k] = __ldg(s.delta + tok[k] * channels);
      zv[k] = __ldg(s.z + tok[k] * z_stride);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) s.step(tok[k], uv[k], dv[k], zv[k]);
  }
  for (; i < n; ++i) {
    const long tok = seq + (reverse ? n - 1 - i : i);
    s.step(tok, __ldg(s.u + tok * channels), __ldg(s.delta + tok * channels),
           __ldg(s.z + tok * z_stride));
  }
  for (int t = n; t < steps; ++t) s.y[(seq + t) * channels] = 0.f;
}

template <int N>
cudaError_t launch(const float* u, const float* delta, const float* z, const float* b,
                   const float* c, const float* a_log, const float* d_skip,
                   const float* delta_bias, const int* n_valid, float* y, int seqs, int steps,
                   int channels, int z_stride, int bc_stride, int reverse, cudaStream_t s) {
  const int threads = channels < THREADS ? (channels + 31) / 32 * 32 : THREADS;
  const dim3 grid(seqs, (channels + THREADS - 1) / THREADS);
  selective_scan_kernel<N><<<grid, threads, 0, s>>>(u, delta, z, b, c, a_log, d_skip,
                                                    delta_bias, n_valid, y, steps, channels,
                                                    z_stride, bc_stride, reverse);
  return cudaGetLastError();
}

}  // namespace

// u, delta, y [seqs, steps, channels] contiguous; z a token every z_stride
// floats, B and C every bc_stride floats (16-byte aligned, bc_stride a
// multiple of 4); A_log [channels, states]; D, delta_bias [channels];
// n_valid [seqs] int32 or null (every step valid); states 16.
extern "C" int sevit_selective_scan(const float* u, const float* delta, const float* z,
                                    const float* b, const float* c, const float* a_log,
                                    const float* d_skip, const float* delta_bias,
                                    const int* n_valid, float* y, int seqs, int steps,
                                    int channels, int states, int z_stride, int bc_stride,
                                    int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seqs < 0 || steps < 0 || channels < 0 || bc_stride % 4 != 0) return cudaErrorInvalidValue;
  if (static_cast<long>(seqs) * steps * channels == 0) return cudaSuccess;
  if (states != 16) return cudaErrorInvalidValue;  // the published d_state, the one instance
  return launch<16>(u, delta, z, b, c, a_log, d_skip, delta_bias, n_valid, y, seqs, steps,
                    channels, z_stride, bc_stride, reverse, s);
}
