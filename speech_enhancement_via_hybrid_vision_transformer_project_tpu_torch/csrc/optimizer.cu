// The optimizer's chain clip_by_global_norm -> adam | adamw over every
// parameter tensor at once, fp32: two multi-tensor kernels.
//
// Replaces the JAX package's chain_with_clip
// (speech_enhancement_via_hybrid_vision_transformer_project_tpu/training/
// optimizer.py), which XLA compiles into a few fused loops over the
// parameter pytree. No Pallas kernel stood here: the port's per-tensor loop
// (ops/cuda_optimizer.py, the plain version) launches about 24 small kernels
// a parameter tensor, each shorter than its launch, so the card waits on the
// host through the whole update.
//
// What bounds them on an H100: bytes. global_sq_norm reads every gradient
// once (4 B an element); adam_update reads p, g, m and v and writes p, m and
// v (28 B an element): 0.80 GB at 28.6M parameters, 0.24 ms at 3.35 TB/s.
// The design reads each element once, 16 B a thread where the tensor allows.
//
// The table: the wrapper passes host arrays of device pointers and element
// counts; the C entries pack up to MAX tensors into a struct passed by value
// as the kernel's parameter (CUDA 12.1+ takes up to 32,764 bytes of them on
// sm_70 and later; __grid_constant__, so that indexing it makes no local
// copy), so no table is copied to the device and nothing waits on the host.
// A tensor is cut into chunks of CHUNK elements, one block a chunk; a block
// finds its tensor by a binary search over the chunk starts.
// A tensor whose pointers are all 16-byte aligned is read as float4 with a
// scalar tail; any other (a view at an odd offset) element by element.
//
// global_sq_norm: each block sums the squares of its chunk in double (the
// product of two floats is exact in double), reduces in a fixed order and
// writes its partial; the block that finishes last (a counter, the only
// atomic) sums the partials in a fixed order and writes sqrt to a 0-d fp32
// tensor, then sets the counter back to 0. Deterministic: no atomic touches
// the value. A table split over several launches shares one partials array
// (block_offset) and finalizes once, in the last block of all.
//
// adam_update: optax's arithmetic, op by op as the plain loop's ATen kernels
// round it (__fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn, so that no FMA
// contraction changes a rounding): the clip g / n * max_norm where
// n >= max_norm, read from device memory (never a host sync);
// m = (1-b1) g + b1 m; v = (1-b2) g^2 + b2 v; u = (m * inv_c1) /
// (sqrt(v * inv_c2) + eps), where inv_c is 1/c taken in double on the host
// and rounded to fp32, as ATen divides by a host scalar; AdamW's u + wd p;
// p + (-lr) u. p, m and v are written in place.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int NORM_CHUNK = THREADS * 4 * 8;  // elements a block
constexpr int ADAM_CHUNK = THREADS * 4 * 4;
constexpr int NORM_MAX = 1024;  // tensors a launch: 20.5 KB of parameters
constexpr int ADAM_MAX = 512;   // 22.5 KB

struct NormTable {
  const float* x[NORM_MAX];
  long long n[NORM_MAX];
  int start[NORM_MAX + 1];  // first chunk of each tensor; start[count] = blocks
  unsigned char vec[NORM_MAX];
  int count;
};

struct AdamTable {
  float* p[ADAM_MAX];
  const float* g[ADAM_MAX];
  float* m[ADAM_MAX];
  float* v[ADAM_MAX];
  long long n[ADAM_MAX];
  int start[ADAM_MAX + 1];
  unsigned char vec[ADAM_MAX];
  int count;
};

struct AdamScalars {
  float max_norm, b1, cb1, b2, cb2, inv_c1, inv_c2, eps, wd, neg_lr;
  int adamw;
};

// the tensor whose chunks hold block b: the last i with start[i] <= b
__device__ __forceinline__ int find_tensor(const int* start, int count, int b) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// the block's sum of x, every thread's value summed in a fixed order;
// the result is valid in thread 0
__device__ __forceinline__ double block_sum(double x, double* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = threadIdx.x < THREADS / 32 ? warp_sums[threadIdx.x] : 0.0;
  if (warp == 0) {
    for (int o = THREADS / 64; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  __syncthreads();  // warp_sums may be reused
  return x;
}

__device__ __forceinline__ double sq(float a) {
  const double d = a;
  return d * d;
}

__global__ void __launch_bounds__(THREADS)
global_sq_norm_kernel(const __grid_constant__ NormTable t, double* partials,
                      unsigned* counter, float* out, int block_offset, int total_blocks) {
  __shared__ double warp_sums[THREADS / 32];
  __shared__ bool last;
  const int b = blockIdx.x;
  const int i = find_tensor(t.start, t.count, b);
  const float* x = t.x[i];
  const long long lo = static_cast<long long>(b - t.start[i]) * NORM_CHUNK;
  const long long hi = min(lo + NORM_CHUNK, t.n[i]);
  double acc = 0.0;
  if (t.vec[i]) {
    const long long vec_hi = lo + ((hi - lo) & ~3LL);
    for (long long j = lo + 4LL * threadIdx.x; j < vec_hi; j += 4LL * THREADS) {
      const float4 q = *reinterpret_cast<const float4*>(x + j);
      acc += sq(q.x) + sq(q.y) + sq(q.z) + sq(q.w);
    }
    for (long long j = vec_hi + threadIdx.x; j < hi; j += THREADS) acc += sq(x[j]);
  } else {
    for (long long j = lo + threadIdx.x; j < hi; j += THREADS) acc += sq(x[j]);
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) {
    partials[block_offset + b] = acc;
    __threadfence();
    last = atomicAdd(counter, 1u) == static_cast<unsigned>(total_blocks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double s = 0.0;
  for (int k = threadIdx.x; k < total_blocks; k += THREADS) s += __ldcg(partials + k);
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) {
    *out = static_cast<float>(sqrt(s));
    *counter = 0u;
  }
}

__device__ __forceinline__ void adam_element(float& p, float g, float& m, float& v,
                                             const AdamScalars& s, bool clip, float n) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, n), s.max_norm);
  m = __fadd_rn(__fmul_rn(s.cb1, g), __fmul_rn(s.b1, m));
  v = __fadd_rn(__fmul_rn(s.cb2, __fmul_rn(g, g)), __fmul_rn(s.b2, v));
  float u = __fdiv_rn(__fmul_rn(m, s.inv_c1),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_c2)), s.eps));
  if (s.adamw) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fadd_rn(p, __fmul_rn(s.neg_lr, u));
}

__device__ __forceinline__ void adam_scalar(const AdamTable& t, int i, long long j,
                                            const AdamScalars& s, bool clip, float n) {
  float p = t.p[i][j], m = t.m[i][j], v = t.v[i][j];
  adam_element(p, t.g[i][j], m, v, s, clip, n);
  t.p[i][j] = p;
  t.m[i][j] = m;
  t.v[i][j] = v;
}

__global__ void __launch_bounds__(THREADS)
adam_update_kernel(const __grid_constant__ AdamTable t, const float* norm,
                   const __grid_constant__ AdamScalars s) {
  const int b = blockIdx.x;
  const int i = find_tensor(t.start, t.count, b);
  const long long lo = static_cast<long long>(b - t.start[i]) * ADAM_CHUNK;
  const long long hi = min(lo + ADAM_CHUNK, t.n[i]);
  const float n = norm != nullptr ? __ldg(norm) : 0.0f;
  const bool clip = norm != nullptr && n >= s.max_norm;
  if (t.vec[i]) {
    const long long vec_hi = lo + ((hi - lo) & ~3LL);
    for (long long j = lo + 4LL * threadIdx.x; j < vec_hi; j += 4LL * THREADS) {
      float4 p = *reinterpret_cast<const float4*>(t.p[i] + j);
      const float4 g = *reinterpret_cast<const float4*>(t.g[i] + j);
      float4 m = *reinterpret_cast<const float4*>(t.m[i] + j);
      float4 v = *reinterpret_cast<const float4*>(t.v[i] + j);
      adam_element(p.x, g.x, m.x, v.x, s, clip, n);
      adam_element(p.y, g.y, m.y, v.y, s, clip, n);
      adam_element(p.z, g.z, m.z, v.z, s, clip, n);
      adam_element(p.w, g.w, m.w, v.w, s, clip, n);
      *reinterpret_cast<float4*>(t.p[i] + j) = p;
      *reinterpret_cast<float4*>(t.m[i] + j) = m;
      *reinterpret_cast<float4*>(t.v[i] + j) = v;
    }
    for (long long j = vec_hi + threadIdx.x; j < hi; j += THREADS) adam_scalar(t, i, j, s, clip, n);
  } else {
    for (long long j = lo + threadIdx.x; j < hi; j += THREADS) adam_scalar(t, i, j, s, clip, n);
  }
}

bool aligned(long long ptr) { return (ptr & 15) == 0; }

// chunk starts of tensors 0..count-1 into start[0..count]; false when a
// count is not positive or the blocks overflow an int
bool chunk_starts(const long long* numel, int count, long long chunk, int* start) {
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (numel[i] <= 0) return false;
    start[i] = static_cast<int>(blocks);
    blocks += (numel[i] + chunk - 1) / chunk;
    if (blocks > 0x7fffffffLL) return false;
  }
  start[count] = static_cast<int>(blocks);
  return true;
}

}  // namespace

// sqrt(sum x^2) over tensors [0, count) of one launch into out[0]. partials:
// total_blocks doubles shared by every launch of the table, this one's from
// block_offset; counter: one unsigned, 0 before the first launch, left 0.
// `chunk` must equal the source's NORM_CHUNK.
extern "C" int sevit_global_sq_norm(const long long* ptrs, const long long* numel, int count,
                                    int chunk, double* partials, unsigned* counter, float* out,
                                    int block_offset, int total_blocks, void* stream) {
  if (count < 1 || count > NORM_MAX || chunk != NORM_CHUNK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static thread_local NormTable t;  // ~21 KB, off the host stack; the launch copies it
  if (!chunk_starts(numel, count, NORM_CHUNK, t.start)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (block_offset < 0 || block_offset + t.start[count] > total_blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < count; ++i) {
    t.x[i] = reinterpret_cast<const float*>(ptrs[i]);
    t.n[i] = numel[i];
    t.vec[i] = aligned(ptrs[i]);
  }
  t.count = count;
  global_sq_norm_kernel<<<t.start[count], THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, partials, counter, out, block_offset, total_blocks);
  return static_cast<int>(cudaGetLastError());
}

// One AdamW (adamw != 0) or Adam step over tensors [0, count): p, m and v in
// place from g; clipped by g / norm * max_norm where norm (a device scalar;
// null: no clip) >= max_norm. The scalars are the fp32 values the plain
// loop's ops use. `chunk` must equal the source's ADAM_CHUNK.
extern "C" int sevit_adam_update(const long long* p, const long long* g, const long long* m,
                                 const long long* v, const long long* numel, int count, int chunk,
                                 const float* norm, float max_norm, float b1, float cb1, float b2,
                                 float cb2, float inv_c1, float inv_c2, float eps, float wd,
                                 float neg_lr, int adamw, void* stream) {
  if (count < 1 || count > ADAM_MAX || chunk != ADAM_CHUNK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static thread_local AdamTable t;  // ~23 KB
  if (!chunk_starts(numel, count, ADAM_CHUNK, t.start)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < count; ++i) {
    t.p[i] = reinterpret_cast<float*>(p[i]);
    t.g[i] = reinterpret_cast<const float*>(g[i]);
    t.m[i] = reinterpret_cast<float*>(m[i]);
    t.v[i] = reinterpret_cast<float*>(v[i]);
    t.n[i] = numel[i];
    t.vec[i] = aligned(p[i]) && aligned(g[i]) && aligned(m[i]) && aligned(v[i]);
  }
  t.count = count;
  const AdamScalars s{max_norm, b1, cb1, b2, cb2, inv_c1, inv_c2, eps, wd, neg_lr, adamw};
  adam_update_kernel<<<t.start[count], THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, norm, s);
  return static_cast<int>(cudaGetLastError());
}
