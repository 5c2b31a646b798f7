// instance_norm: y = PReLU((x - mean) * rsqrt(var + eps) * weight + bias; slope)
// over x [B, C, T, F] fp32, the mean and the biased variance of each (b, c)
// plane taken over its first n_valid[b] frames (all T where no counts are
// given) and every frame normalised by them: the masked InstanceNorm2d
// (affine) and the PReLU after it at each of the 16 such sites of CMGAN's
// generator (the DenseEncoder's two convolutions, its DenseNet's four
// layers, each decoder's DenseNet, the mask decoder's one-channel norm and
// the complex decoder's norm).
//
// Ports no TPU kernel: the JAX package has no CMGAN. It was added because
// ATen runs each site as ~11 passes over the tensor (the mask's product, two
// sums, the centring twice, the square, rsqrt's product, the affine step and
// the PReLU), most of them through its generic broadcasting kernel.
//
// What bounds it on an H100: bytes. Three launches: the statistics read the
// valid frames once; a small one merges each plane's partial statistics; the
// normalisation reads every frame once more and writes the output once.
//
// Layouts: x and out contiguous [B, C, T, F] (NCHW, as the encoder's
// convolutions leave them), or channels-last [B, T, F, C] in memory (NHWC:
// the decoders' DenseNets run on the last conformer block's permuted output,
// and cuDNN keeps that layout), 4 <= C <= 256 a power of two there.
//
// Design:
// - The valid frames of a row are a contiguous prefix: n_valid[b] * F floats
//   of each plane (NCHW), or n_valid[b] * F positions of C floats (NHWC).
//   The statistics and the normalisation cut each plane (NCHW) or row (NHWC)
//   into `chunks` chunks of the same length, one block a chunk, so that a few
//   planes (the mask decoder's 32 at C = 1) still fill the card; the wrapper
//   picks `chunks`.
// - NCHW: a plane starts at (b * C + c) * T * F floats, only 4-byte aligned
//   where T * F is odd: a block takes the floats before its first 16-byte
//   boundary and after its last one alone and the rest as float4, UNROLL
//   loads a thread in flight. NHWC: a position is C / 4 float4, and a thread
//   always meets the same 4 channels (C / 4 divides the block's 256 threads).
// - Statistics as (count, mean, M2) in fp32, never as a sum of squares
//   (E[x^2] - E[x]^2 cancels over planes of up to 331k floats): a thread's
//   UNROLL float4s give the mean and M2 of their floats from registers,
//   merged into the thread's running moments by Chan's update (NCHW: one
//   division a 16 floats; NHWC: two a 4 positions, one count for the 4
//   channels); the block's threads merge in a fixed order, and each block
//   writes its chunk's moments of each of its planes to `partials`.
// - A warp a plane merges the plane's partials in a fixed order and writes
//   its mean and weight * rstd (1 / sqrtf, IEEE: no fast math). No atomics:
//   a call's output is the same bits every time.
// - The normalisation: y = (x - mean) * (weight * rstd) + bias, then the
//   PReLU with slope[0] or slope[c].
// - 64-bit offsets: the cell's largest tensor is 32 x 64 x 1638 x 202
//   floats, 2.7 GB.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // float4 loads a thread has in flight
constexpr unsigned FULL = 0xffffffffu;

struct Moments {
  float n, mean, m2;
};

// Chan's merge of two sets' moments; an empty set leaves the other as it is
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float f = b.n / n;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

// lane 0 ends with the merge of the warp's 32 moments, in a fixed tree
__device__ __forceinline__ Moments warp_merge(Moments a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Moments b{__shfl_down_sync(FULL, a.n, o), __shfl_down_sync(FULL, a.mean, o),
                    __shfl_down_sync(FULL, a.m2, o)};
    a = merge(a, b);
  }
  return a;
}

// A block's range [lo, hi) of one plane: `head` floats up to the first
// 16-byte boundary, then `nvec` float4, then the floats from `tail_at` on.
struct Split {
  long head, nvec, tail_at;
};

__device__ __forceinline__ Split split(const float* p, long lo, long hi) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(p + lo) >> 2) & 3);
  const long head = min(static_cast<long>(mis ? 4 - mis : 0), hi - lo);
  const long nvec = (hi - lo - head) / 4;
  return {head, nvec, lo + head + 4 * nvec};
}

__device__ __forceinline__ int row_frames(const int* n_valid, int b, int frames) {
  if (n_valid == nullptr) return frames;
  const int v = n_valid[b];
  return v < 0 ? 0 : (v > frames ? frames : v);
}

__device__ __forceinline__ float4 load_or_zero(const float4* q, long at, long end) {
  return at < end ? q[at] : make_float4(0.f, 0.f, 0.f, 0.f);
}

// how many of the UNROLL loads i, i + THREADS, ... lie below `end` (i < end)
__device__ __forceinline__ int present(long i, long end) {
  return static_cast<int>(min(static_cast<long>(UNROLL), (end - i + THREADS - 1) / THREADS));
}

__device__ __forceinline__ float sq(float a) { return a * a; }

__global__ void __launch_bounds__(THREADS)
instance_norm_stats_kernel(const float* __restrict__ x,      // [B, C, T, F]
                           const int* __restrict__ n_valid,  // [B] or null
                           float4* __restrict__ partials,    // [B * C, chunks]
                           int channels, int frames, int bins, int chunks, int chunk_len) {
  __shared__ Moments warp_m[WARPS];
  const long plane = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x - plane * chunks);
  const long plane_len = static_cast<long>(frames) * bins;
  const long valid_len =
      static_cast<long>(row_frames(n_valid, static_cast<int>(plane / channels), frames)) * bins;
  const long lo = static_cast<long>(chunk) * chunk_len;
  const long hi = min(lo + chunk_len, valid_len);
  const float* p = x + plane * plane_len;
  Moments acc{0.f, 0.f, 0.f};
  if (lo < hi) {
    const Split s = split(p, lo, hi);
    // the head's floats on threads 0-3, the tail's on 4-7: one float each
    if (threadIdx.x < s.head) {
      acc = {1.f, p[lo + threadIdx.x], 0.f};
    } else if (threadIdx.x >= 4 && threadIdx.x - 4 < hi - s.tail_at) {
      acc = {1.f, p[s.tail_at + threadIdx.x - 4], 0.f};
    }
    const float4* q = reinterpret_cast<const float4*>(p + lo + s.head);
    for (long i = threadIdx.x; i < s.nvec; i += UNROLL * THREADS) {
      float4 v[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) v[j] = load_or_zero(q, i + j * THREADS, s.nvec);
      const int k = present(i, s.nvec);  // v[0 .. k) were loaded, the rest are zeros
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) sum += (v[j].x + v[j].y) + (v[j].z + v[j].w);
      const float n = 4.f * k;
      const float mean = sum / n;
      float m2 = 0.f;
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        if (j < k) {
          m2 += (sq(v[j].x - mean) + sq(v[j].y - mean)) + (sq(v[j].z - mean) + sq(v[j].w - mean));
        }
      }
      acc = merge(acc, {n, mean, m2});
    }
  }
  acc = warp_merge(acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_m[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < WARPS ? warp_m[lane] : Moments{0.f, 0.f, 0.f};
    acc = warp_merge(acc);
    if (lane == 0) partials[blockIdx.x] = make_float4(acc.n, acc.mean, acc.m2, 0.f);
  }
}

__global__ void __launch_bounds__(THREADS)
instance_norm_stats_cl_kernel(const float* __restrict__ x,      // [B, T, F, C] in memory
                              const int* __restrict__ n_valid,  // [B] or null
                              float4* __restrict__ partials,    // [B * C, chunks]
                              int channels, int frames, int bins, int chunks, int chunk_pos) {
  __shared__ float count_s[THREADS];
  __shared__ float4 mean_s[THREADS], m2_s[THREADS];
  const int b = blockIdx.x / chunks;
  const int chunk = blockIdx.x - b * chunks;
  const int groups = channels / 4;  // float4 a position
  const long positions = static_cast<long>(frames) * bins;
  const long valid = static_cast<long>(row_frames(n_valid, b, frames)) * bins;
  const long lo = static_cast<long>(chunk) * chunk_pos;
  const long end = min(lo + chunk_pos, valid) * groups;  // float4 of the row
  const float4* q = reinterpret_cast<const float4*>(x + b * positions * channels);
  // this thread's 4 channels' moments, one count for the four
  float n = 0.f;
  float4 mean = make_float4(0.f, 0.f, 0.f, 0.f), m2 = mean;
  for (long i = lo * groups + threadIdx.x; i < end; i += UNROLL * THREADS) {
    float4 v[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) v[j] = load_or_zero(q, i + j * THREADS, end);
    const int k = present(i, end);
    float4 s = v[0];
#pragma unroll
    for (int j = 1; j < UNROLL; ++j) {
      s = make_float4(s.x + v[j].x, s.y + v[j].y, s.z + v[j].z, s.w + v[j].w);
    }
    const float inv_k = 1.f / k;
    const float4 bm = make_float4(s.x * inv_k, s.y * inv_k, s.z * inv_k, s.w * inv_k);
    float4 bm2 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (j < k) {
        bm2 = make_float4(bm2.x + sq(v[j].x - bm.x), bm2.y + sq(v[j].y - bm.y),
                          bm2.z + sq(v[j].z - bm.z), bm2.w + sq(v[j].w - bm.w));
      }
    }
    // Chan's merge of (k, bm, bm2) into (n, mean, m2), channel by channel
    const float nn = n + k;
    const float f = k / nn, g = n * f;
    const float4 d = make_float4(bm.x - mean.x, bm.y - mean.y, bm.z - mean.z, bm.w - mean.w);
    mean = make_float4(mean.x + d.x * f, mean.y + d.y * f, mean.z + d.z * f, mean.w + d.w * f);
    m2 = make_float4(m2.x + bm2.x + d.x * d.x * g, m2.y + bm2.y + d.y * d.y * g,
                     m2.z + bm2.z + d.z * d.z * g, m2.w + bm2.w + d.w * d.w * g);
    n = nn;
  }
  count_s[threadIdx.x] = n;
  mean_s[threadIdx.x] = mean;
  m2_s[threadIdx.x] = m2;
  __syncthreads();
  if (threadIdx.x < channels) {  // channel c merges the threads that met it, in order
    const int c = threadIdx.x, e = c & 3;
    Moments acc{0.f, 0.f, 0.f};
    for (int t = c / 4; t < THREADS; t += groups) {
      const float* tm = reinterpret_cast<const float*>(&mean_s[t]);
      const float* t2 = reinterpret_cast<const float*>(&m2_s[t]);
      acc = merge(acc, {count_s[t], tm[e], t2[e]});
    }
    partials[(static_cast<long>(b) * channels + c) * chunks + chunk] =
        make_float4(acc.n, acc.mean, acc.m2, 0.f);
  }
}

// a warp a plane (b, c): its chunks' moments merged in a fixed order, then
// its mean and weight * rstd
__global__ void __launch_bounds__(THREADS)
instance_norm_finalize_kernel(const float4* __restrict__ partials,  // [planes, chunks]
                              const float* __restrict__ weight,     // [C]
                              float2* __restrict__ coef,            // [planes]
                              int channels, long planes, int chunks, float eps) {
  const long plane = (static_cast<long>(blockIdx.x) * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (plane >= planes) return;  // whole warps
  Moments acc{0.f, 0.f, 0.f};
  for (int k = lane; k < chunks; k += 32) {
    const float4 m = partials[plane * chunks + k];
    acc = merge(acc, {m.x, m.y, m.z});
  }
  acc = warp_merge(acc);
  if (lane == 0) {
    const float rstd = 1.f / sqrtf(acc.m2 / acc.n + eps);
    coef[plane] = make_float2(acc.mean, weight[plane % channels] * rstd);
  }
}

__device__ __forceinline__ float norm_prelu(float x, float mean, float scale, float shift,
                                            float a) {
  const float y = (x - mean) * scale + shift;
  return y > 0.f ? y : a * y;
}

__global__ void __launch_bounds__(THREADS)
instance_norm_apply_kernel(const float* __restrict__ x,      // [B, C, T, F]
                           const float2* __restrict__ coef,  // [B * C]
                           const float* __restrict__ bias,   // [C]
                           const float* __restrict__ slope,  // [1] or [C]
                           float* __restrict__ out,          // [B, C, T, F]
                           int channels, int frames, int bins, int chunks, int chunk_len,
                           int slopes) {
  const long plane = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x - plane * chunks);
  const int c = static_cast<int>(plane % channels);
  const long plane_len = static_cast<long>(frames) * bins;
  const long lo = min(static_cast<long>(chunk) * chunk_len, plane_len);
  const long hi = min(lo + chunk_len, plane_len);
  const float* p = x + plane * plane_len;
  float* o = out + plane * plane_len;
  const float2 mc = coef[plane];
  const float mean = mc.x, scale = mc.y, shift = bias[c], a = slope[slopes == 1 ? 0 : c];
  const Split s = split(p, lo, hi);
  const float4* q = reinterpret_cast<const float4*>(p + lo + s.head);
  float4* r = reinterpret_cast<float4*>(o + lo + s.head);
  for (long i = threadIdx.x; i < s.nvec; i += UNROLL * THREADS) {
    float4 v[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) v[j] = load_or_zero(q, i + j * THREADS, s.nvec);
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (i + j * THREADS < s.nvec) {
        r[i + j * THREADS] = make_float4(
            norm_prelu(v[j].x, mean, scale, shift, a), norm_prelu(v[j].y, mean, scale, shift, a),
            norm_prelu(v[j].z, mean, scale, shift, a), norm_prelu(v[j].w, mean, scale, shift, a));
      }
    }
  }
  // the head's floats on threads 0-3, the tail's on 4-7, after the float4
  // loads, which need not wait for the plane's statistics
  if (threadIdx.x < s.head) {
    o[lo + threadIdx.x] = norm_prelu(p[lo + threadIdx.x], mean, scale, shift, a);
  } else if (threadIdx.x >= 4 && threadIdx.x - 4 < hi - s.tail_at) {
    const long at = s.tail_at + threadIdx.x - 4;
    o[at] = norm_prelu(p[at], mean, scale, shift, a);
  }
}

__global__ void __launch_bounds__(THREADS)
instance_norm_apply_cl_kernel(const float* __restrict__ x,      // [B, T, F, C] in memory
                              const float2* __restrict__ coef,  // [B * C]
                              const float* __restrict__ bias,   // [C]
                              const float* __restrict__ slope,  // [1] or [C]
                              float* __restrict__ out,          // [B, T, F, C] in memory
                              int channels, int frames, int bins, int chunks, int chunk_pos,
                              int slopes) {
  const int b = blockIdx.x / chunks;
  const int chunk = blockIdx.x - b * chunks;
  const int groups = channels / 4;
  const int c0 = 4 * (threadIdx.x % groups);  // this thread's 4 channels
  const long positions = static_cast<long>(frames) * bins;
  const long lo = static_cast<long>(chunk) * chunk_pos;
  const long end = min(lo + chunk_pos, positions) * groups;
  const long row = b * positions * channels;
  const float4* q = reinterpret_cast<const float4*>(x + row);
  float4* r = reinterpret_cast<float4*>(out + row);
  float mean[4], scale[4], shift[4], a[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 mc = coef[static_cast<long>(b) * channels + c0 + e];
    mean[e] = mc.x;
    scale[e] = mc.y;
    shift[e] = bias[c0 + e];
    a[e] = slope[slopes == 1 ? 0 : c0 + e];
  }
  for (long i = lo * groups + threadIdx.x; i < end; i += UNROLL * THREADS) {
    float4 v[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) v[j] = load_or_zero(q, i + j * THREADS, end);
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (i + j * THREADS < end) {
        r[i + j * THREADS] = make_float4(norm_prelu(v[j].x, mean[0], scale[0], shift[0], a[0]),
                                         norm_prelu(v[j].y, mean[1], scale[1], shift[1], a[1]),
                                         norm_prelu(v[j].z, mean[2], scale[2], shift[2], a[2]),
                                         norm_prelu(v[j].w, mean[3], scale[3], shift[3], a[3]));
      }
    }
  }
}

}  // namespace

// x, out: [batch, channels, frames, bins], contiguous (channels_last 0) or
// channels-last (1: [batch, frames, bins, channels] in memory, channels a
// power of two from 4 to 256), 16-byte aligned; n_valid: [batch] int32 valid
// frames of each row (clamped to [0, frames]), or null for all; weight,
// bias: [channels]; slope: [slopes], 1 or channels; scratch: batch *
// channels * (4 * chunks + 2) floats, 16-byte aligned. `chunks` cuts each
// plane (channels_last 0) or row (1). An empty tensor launches nothing.
// Three launches on `stream`: the statistics, their merge, the normalisation.
extern "C" int sevit_instance_norm_prelu(const float* x, const int* n_valid, const float* weight,
                                         const float* bias, const float* slope, float* scratch,
                                         float* out, int batch, int channels, int frames,
                                         int bins, int slopes, int chunks, int channels_last,
                                         float eps, void* stream) {
  if (batch < 0 || channels < 1 || frames < 0 || bins < 0 || chunks < 1 ||
      (slopes != 1 && slopes != channels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (channels_last && (channels < 4 || channels > THREADS || (channels & (channels - 1)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long positions = static_cast<long>(frames) * bins;
  const long planes = static_cast<long>(batch) * channels;
  const long blocks = (channels_last ? batch : planes) * static_cast<long>(chunks);
  if (positions * (channels_last ? channels : 1) > 0x7fffffffL || blocks > 0x7fffffffL ||
      planes > 0x7fffffffL / 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || positions == 0) return static_cast<int>(cudaSuccess);
  float4* partials = reinterpret_cast<float4*>(scratch);
  float2* coef = reinterpret_cast<float2*>(scratch + planes * chunks * 4);
  const int per_chunk = static_cast<int>((positions + chunks - 1) / chunks);
  const int chunk_len = (per_chunk + 3) / 4 * 4;  // NCHW: chunks start 16 bytes apart
  const unsigned grid = static_cast<unsigned>(blocks);
  const unsigned merge_grid = static_cast<unsigned>((planes * 32 + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels_last) {
    instance_norm_stats_cl_kernel<<<grid, THREADS, 0, s>>>(x, n_valid, partials, channels,
                                                           frames, bins, chunks, per_chunk);
  } else {
    instance_norm_stats_kernel<<<grid, THREADS, 0, s>>>(x, n_valid, partials, channels, frames,
                                                        bins, chunks, chunk_len);
  }
  instance_norm_finalize_kernel<<<merge_grid, THREADS, 0, s>>>(partials, weight, coef, channels,
                                                               planes, chunks, eps);
  if (channels_last) {
    instance_norm_apply_cl_kernel<<<grid, THREADS, 0, s>>>(x, coef, bias, slope, out, channels,
                                                           frames, bins, chunks, per_chunk,
                                                           slopes);
  } else {
    instance_norm_apply_kernel<<<grid, THREADS, 0, s>>>(x, coef, bias, slope, out, channels,
                                                        frames, bins, chunks, chunk_len, slopes);
  }
  return static_cast<int>(cudaGetLastError());
}
