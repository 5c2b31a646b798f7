// The kept keys of one batch row's key mask, listed in shared memory: the
// gather that K2's forward (attention.cu) and backward (attention_bwd.cu)
// walk instead of every key of a masked row.
#pragma once

#include <stddef.h>
#include <stdint.h>

// Shared memory of the list of n keys: ballot words, their prefix, key indices.
inline size_t kept_list_bytes(int n) {
  const size_t nw = (n + 31) / 32;
  return sizeof(uint32_t) * 2 * nw + sizeof(int) * n;
}

// Lists the kept keys (mrow[j] != 0) of a row of n keys at `smem`
// (kept_list_bytes(n) bytes): a warp ballot per 32 keys, an exclusive prefix
// of the ballots' popcounts, then each kept key's index at its rank, in key
// order. Every thread of the block calls it; it returns the number of kept
// keys to all of them, and *list points at the indices.
template <int WARPS>
__device__ int list_kept_keys(const unsigned char* __restrict__ mrow, int n, void* smem,
                              const int** list_out) {
  __shared__ int n_kept;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (n + 31) / 32;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  uint32_t* prefix = words + nw;
  int* list = reinterpret_cast<int*>(prefix + nw);
  for (int c = warp; c < nw; c += WARPS) {
    const int j = c * 32 + lane;
    const uint32_t b = __ballot_sync(0xffffffffu, j < n && mrow[j]);
    if (lane == 0) words[c] = b;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix of the words' popcounts, 32 at a time
    int carry = 0;
    for (int c0 = 0; c0 < nw; c0 += 32) {
      const int c = c0 + lane;
      const int cnt = c < nw ? __popc(words[c]) : 0;
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (c < nw) prefix[c] = carry + incl - cnt;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) n_kept = carry;
  }
  __syncthreads();
  for (int c = warp; c < nw; c += WARPS) {
    const uint32_t w = words[c];
    if ((w >> lane) & 1u) list[prefix[c] + __popc(w & ((1u << lane) - 1u))] = c * 32 + lane;
  }
  __syncthreads();
  *list_out = list;
  return n_kept;
}
