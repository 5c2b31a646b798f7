// conv1d_silu: Mamba-1's short depthwise convolution and its SiLU, forward
// only, fp32, over token-major sequences: for each sequence g, step t and
// channel d,
//
//   causal (forward):  u_t = silu(bias_d + sum_j w_dj x_{t-k+1+j})
//   mirrored (reverse): u_t = silu(bias_d + sum_j w_dj x_{t+k-1-j})
//
// with x = 0 outside the sequence's 0 .. steps - 1. The causal one is
// mamba_ssm's conv1d (padded k - 1 on the left, the first `steps` outputs);
// the mirrored one is that conv on the flipped sequence, flipped back, which
// is what the backward direction of a bidirectional block needs with no
// flipped copies (the window reaches k - 1 steps ahead, the kernel flipped).
// Every step is computed, padded ones included: the model zeroes a row's
// padded tokens before in_proj, so the mirrored conv sees exact zeros past
// a row's end.
//
// Ports no TPU kernel: the JAX package has no SEMamba. It was added for the
// 16 Mamba layers a forward of SEMamba's generator (arXiv:2405.06573), where
// ATen ran each as four passes: a padded transposed copy of x, its depthwise
// conv (channel-major), a transpose back and the SiLU, ~8 KB of traffic a
// token at d_inner 256 where the function needs 2 KB.
//
// What bounds it on an H100: bytes. Each step reads x (channels floats) and
// writes u (channels floats); k fused multiply-adds and one exponential a
// (step, channel) are far below the card's rates.
//
// Design:
// - x is read in place: a token's channels every x_stride floats (the first
//   half of the in_proj output's rows, 2 * d_inner apart), sequences
//   steps * x_stride apart; u is written contiguous [seqs, steps, channels],
//   as x_proj and the scan read it.
// - A warp's lanes are adjacent channels of one token, a float4 each where
//   the channels, x_stride and both pointers allow it (else a float each):
//   every load and store is whole 128-byte lines. A block is 256 threads,
//   the channels of one token times runs of consecutive tokens.
// - Each thread walks a run of ~64 consecutive tokens of one sequence (the
//   steps cut into equal runs), the k - 1 tokens before the current one in
//   registers, so each x element is loaded once a run; the k - 1 tokens of
//   halo at a run's start are loaded again (~5% more reads at 64). The
//   mirrored conv walks its run from the end down.
// - Four tokens' loads are issued before any of them is used.
// - The k products are summed into the bias in fp32 in F.conv1d's order
//   (the kernel's taps in ascending order over the padded input: ATen's
//   depthwise kernel), the SiLU as x / (1 + expf(-x)), IEEE (no fast math).
// - 64-bit offsets: the largest time mixer's x view spans 2.7G floats.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int K = 4;          // the taps: Mamba's published d_conv
constexpr int THREADS = 256;  // a block
constexpr int RUN = 64;       // tokens a thread walks, at most
constexpr int UNROLL = 4;     // tokens whose loads are issued together

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// u of the token whose window is win[first .. first + K - 1] (walking order)
template <int VEC, bool REVERSE, int N>
__device__ __forceinline__ void conv_silu(const float (&win)[N][VEC], int first,
                                          const float (&w)[K][VEC], const float (&b)[VEC],
                                          float (&out)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    float acc = b[v];
    // in walking order the window holds x_{t-3} .. x_t forward, x_{t+3} .. x_t
    // backward; F.conv1d sums tap 0 first over the padded input, i.e. the
    // farthest token forward and the current one backward (the kernel flipped)
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int j = REVERSE ? K - 1 - i : i;
      acc = fmaf(w[j][v], win[first + j][v], acc);
    }
    out[v] = acc / (1.f + expf(-acc));
  }
}

template <int VEC, bool REVERSE>
__global__ void __launch_bounds__(THREADS)
conv1d_silu_kernel(const float* __restrict__ x, const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ u, int steps,
                   int channels, long x_stride, long total_runs, int runs, int run) {
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  const long r = static_cast<long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (c >= channels || r >= total_runs) return;
  const long seq = r / runs;
  const int lo = static_cast<int>(r % runs) * run;
  const int hi = min(lo + run, steps);
  if (lo >= hi) return;

  float w[K][VEC], b[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    b[v] = bias[c + v];
#pragma unroll
    for (int j = 0; j < K; ++j) w[j][v] = weight[static_cast<long>(c + v) * K + j];
  }
  const float* xs = x + seq * steps * x_stride + c;  // token t at xs + t * x_stride
  float* us = u + seq * steps * channels + c;

  // the window in walking order: K - 1 tokens behind, then UNROLL loaded ahead
  float win[K - 1 + UNROLL][VEC];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    const int t = REVERSE ? hi + (K - 2 - i) : lo - (K - 1) + i;
    if (t >= 0 && t < steps) {
      load<VEC>(xs + t * x_stride, win[i]);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) win[i][v] = 0.f;
    }
  }

  const int n = hi - lo;
  int i = 0;
  for (; i + UNROLL <= n; i += UNROLL) {
    int t[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      t[k] = REVERSE ? hi - 1 - (i + k) : lo + i + k;
      load<VEC>(xs + t[k] * x_stride, win[K - 1 + k]);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      float out[VEC];
      conv_silu<VEC, REVERSE>(win, k, w, b, out);
      store<VEC>(us + static_cast<long>(t[k]) * channels, out);
    }
#pragma unroll
    for (int j = 0; j < K - 1; ++j)
#pragma unroll
      for (int v = 0; v < VEC; ++v) win[j][v] = win[UNROLL + j][v];
  }
  for (; i < n; ++i) {
    const int t = REVERSE ? hi - 1 - i : lo + i;
    load<VEC>(xs + t * x_stride, win[K - 1]);
    float out[VEC];
    conv_silu<VEC, REVERSE>(win, 0, w, b, out);
    store<VEC>(us + static_cast<long>(t) * channels, out);
#pragma unroll
    for (int j = 0; j < K - 1; ++j)
#pragma unroll
      for (int v = 0; v < VEC; ++v) win[j][v] = win[j + 1][v];
  }
}

template <int VEC, bool REVERSE>
cudaError_t launch(const float* x, const float* weight, const float* bias, float* u, int seqs,
                   int steps, int channels, int x_stride, cudaStream_t s) {
  const int lanes = (channels + VEC - 1) / VEC;  // threads a token
  const int bx = lanes < THREADS ? (lanes + 31) / 32 * 32 : THREADS;
  const int by = THREADS / bx;                   // runs a block
  const int runs = (steps + RUN - 1) / RUN;      // runs a sequence, of equal length
  const int run = (steps + runs - 1) / runs;
  const long total_runs = static_cast<long>(seqs) * runs;
  const long blocks = (total_runs + by - 1) / by;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), (lanes + bx - 1) / bx);
  conv1d_silu_kernel<VEC, REVERSE><<<grid, dim3(bx, by), 0, s>>>(
      x, weight, bias, u, steps, channels, x_stride, total_runs, runs, run);
  return cudaGetLastError();
}

}  // namespace

// x: a token's channels every x_stride floats (contiguous within the token),
// sequences steps * x_stride apart; weight [channels, 1, width] and bias
// [channels] contiguous; u [seqs, steps, channels] contiguous; width 4;
// reverse: the mirrored conv.
extern "C" int sevit_conv1d_silu(const float* x, const float* weight, const float* bias,
                                 float* u, int seqs, int steps, int channels, int width,
                                 int x_stride, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seqs < 0 || steps < 0 || channels < 0 || x_stride < channels) return cudaErrorInvalidValue;
  if (static_cast<long>(seqs) * steps * channels == 0) return cudaSuccess;
  if (width != K) return cudaErrorInvalidValue;  // the published d_conv, the one instance
  const bool vec = channels % 4 == 0 && x_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(u) % 16 == 0;
  if (vec) {
    return reverse ? launch<4, true>(x, weight, bias, u, seqs, steps, channels, x_stride, s)
                   : launch<4, false>(x, weight, bias, u, seqs, steps, channels, x_stride, s);
  }
  return reverse ? launch<1, true>(x, weight, bias, u, seqs, steps, channels, x_stride, s)
                 : launch<1, false>(x, weight, bias, u, seqs, steps, channels, x_stride, s);
}
