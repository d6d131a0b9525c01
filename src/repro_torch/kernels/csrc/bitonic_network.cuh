// The bitonic compare-exchange network of the JAX package's
// kernels/bitonic.py:bitonic_network_rows, on rows held in shared memory,
// and the lexicographic order of (key words, payload) it sorts by.
//
// Included by K1 (tile_sort.cu), K4 (topk.cu) and K6 (merge_sort.cu), so
// the network exists once.  K2 and K3 search the same order on packed keys
// (packed_key.cuh).
//
// Key words are the port's biased int32 words (core/key_codec.py), so the
// order on (*words, payload) is plain signed int32 order word by word.

#pragma once

#include <cuda_runtime.h>

namespace repro {

// (a0, a1, av) > (b0, b1, bv), lexicographically; a1/b1 are read only when
// NW == 2.
template <int NW>
__device__ __forceinline__ bool key_gt(int a0, int a1, int av, int b0, int b1,
                                       int bv) {
  if (a0 != b0) return a0 > b0;
  if (NW == 2 && a1 != b1) return a1 > b1;
  return av > bv;
}

template <int NW>
__device__ __forceinline__ bool lex_gt(const int* s0, const int* s1,
                                       const int* sv, int i, int j) {
  return key_gt<NW>(s0[i], NW == 2 ? s1[i] : 0, sv[i], s0[j],
                    NW == 2 ? s1[j] : 0, sv[j]);
}

__device__ __forceinline__ void swap_at(int* s, int i, int j) {
  const int t = s[i];
  s[i] = s[j];
  s[j] = t;
}

// Sorts E / T consecutive rows of T elements (T a power of two, E a
// multiple of T) held in shared memory as one int32 array per key word
// (s1 is ignored when NW == 1) plus one for the payload, ascending on
// (*words, payload).  Element i pairs with i ^ d; the pair is ascending iff
// (i & size) == 0 within its row.  Called by every thread of the block
// after the rows are stored and a __syncthreads(); returns after a
// __syncthreads() with the rows sorted.
template <int NW>
__device__ __forceinline__ void bitonic_sort_rows(int* s0, int* s1, int* sv,
                                                  int E, int T) {
  const int half = E >> 1;
  for (int size = 2; size <= T; size <<= 1) {
    for (int d = size >> 1; d > 0; d >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        // p-th pair: insert a zero bit at position log2(d) to get its low
        // element i; the high element is i | d (== i ^ d).
        const int i = ((p & ~(d - 1)) << 1) | (p & (d - 1));
        const int j = i | d;
        // (i & (T - 1)) is the index within the row.
        const bool asc = ((i & (T - 1)) & size) == 0;
        if (lex_gt<NW>(s0, s1, sv, i, j) == asc) {
          swap_at(s0, i, j);
          if (NW == 2) swap_at(s1, i, j);
          swap_at(sv, i, j);
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace repro
