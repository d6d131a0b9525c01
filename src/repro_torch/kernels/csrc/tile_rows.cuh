// The row load, row store and sample epilogue of the row-sort kernels, K1
// (tile_sort.cu), K5 (radix_sort.cu) and K6 (merge_sort.cu), which share
// one layout: a CTA sorts E = rows_per_cta * T consecutive elements of
// (m, T) contiguous rows in dynamic shared memory, one int32 array per key
// word (s1 unused when NW == 1) plus one for the payload.
//
// Replaces the row blocking and the fused sample output of the TPU kernel
// src/repro/kernels/bitonic.py:tile_sort_call (_block_kernel), through
// which all three TPU row sorts are launched.

#pragma once

#include <cuda_runtime.h>

namespace repro {

// Copies the CTA's E elements, from element offset base, into shared
// memory, coalesced.  The caller synchronises before reading them.
template <int NW>
__device__ __forceinline__ void load_rows(int* s0, int* s1, int* sv,
                                          const int* __restrict__ k0,
                                          const int* __restrict__ k1,
                                          const int* __restrict__ v,
                                          long long base, int E) {
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    s0[i] = k0[base + i];
    if (NW == 2) s1[i] = k1[base + i];
    sv[i] = v[base + i];
  }
}

// Writes the CTA's sorted rows back from shared memory to element offset
// base and, when num_samples > 0, sample j of each row, its element
// (j + 1) * T / num_samples - 1, to the (m, num_samples) sample arrays.
// Called after a __syncthreads() that follows the sort.
template <int NW>
__device__ __forceinline__ void store_rows(
    const int* s0, const int* s1, const int* sv, int* __restrict__ ok0,
    int* __restrict__ ok1, int* __restrict__ ov, int* __restrict__ sk0,
    int* __restrict__ sk1, int* __restrict__ ssv, long long base, int E,
    int T, int num_samples) {
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    ok0[base + i] = s0[i];
    if (NW == 2) ok1[base + i] = s1[i];
    ov[base + i] = sv[i];
  }
  if (num_samples) {
    const int chunk = T / num_samples;
    const int ns = E / T * num_samples;
    const long long sbase = base / T * num_samples;
    for (int q = threadIdx.x; q < ns; q += blockDim.x) {
      const int src = (q / num_samples) * T + (q % num_samples + 1) * chunk - 1;
      sk0[sbase + q] = s0[src];
      if (NW == 2) sk1[sbase + q] = s1[src];
      ssv[sbase + q] = sv[src];
    }
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB only
// by opt-in, up to 227 KB a block on the H100).
template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace repro
