// The row load, row store and sample epilogue of the row-sort kernels, K1
// (tile_sort.cu), K5 (radix_sort.cu) and K6 (merge_sort.cu).  A CTA sorts
// E = rows_per_cta * T consecutive elements of (m, T) contiguous rows, in
// registers, ITEMS consecutive elements a thread as packed keys (RegRows,
// bitonic_network.cuh), moved with 16-byte accesses where the pointers
// allow (load_ints / store_ints); the samples come from the registers that
// hold them.  K1 and K6 load with load_regs (K5 loads warp-striped, as
// its ranking needs), and K1, K5 and K6 store with store_regs.  K4
// (topk.cu) loads its words with load_ints.
//
// Replaces the row blocking and the fused sample output of the TPU kernel
// src/repro/kernels/bitonic.py:tile_sort_call (_block_kernel), through
// which all three TPU row sorts are launched.

#pragma once

#include <cuda_runtime.h>

#include <initializer_list>

#include "bitonic_network.cuh"

namespace repro {

// Reads N consecutive int32 from p: as int4 when N is a multiple of 4 and
// `vec` says p is 16-byte aligned, else one by one.
template <int N>
__device__ __forceinline__ void load_ints(int (&x)[N], const int* __restrict__ p,
                                          bool vec) {
  if constexpr (N % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const int4 a = reinterpret_cast<const int4*>(p)[q];
        x[4 * q] = a.x;
        x[4 * q + 1] = a.y;
        x[4 * q + 2] = a.z;
        x[4 * q + 3] = a.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = p[i];
}

template <int N>
__device__ __forceinline__ void store_ints(int* __restrict__ p,
                                           const int (&x)[N], bool vec) {
  if constexpr (N % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        reinterpret_cast<int4*>(p)[q] =
            make_int4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = x[i];
}

// Loads this thread's ITEMS elements from element offset off (its first)
// and packs them.
template <int NW, int ITEMS>
__device__ __forceinline__ void load_regs(RegRows<NW, ITEMS>& r,
                                          const int* __restrict__ k0,
                                          const int* __restrict__ k1,
                                          const int* __restrict__ v,
                                          long long off, bool vec) {
  int w0[ITEMS], w1[ITEMS], pv[ITEMS];
  load_ints(w0, k0 + off, vec);
  if (NW == 2) load_ints(w1, k1 + off, vec);
  load_ints(pv, v + off, vec);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    r.h[i] = pack2(w0[i], NW == 2 ? w1[i] : pv[i]);
    if (NW == 2) r.l[i] = pv[i];
  }
}

// Unpacks this thread's sorted elements and stores them at element offset
// off and, when num_samples > 0, those that are samples: sample j of a
// row is its element (j + 1) * T / num_samples - 1, written to the
// (m, num_samples) sample arrays.
template <int NW, int ITEMS>
__device__ __forceinline__ void store_regs(
    const RegRows<NW, ITEMS>& r, int* __restrict__ ok0, int* __restrict__ ok1,
    int* __restrict__ ov, int* __restrict__ sk0, int* __restrict__ sk1,
    int* __restrict__ ssv, long long off, int T, int num_samples, bool vec) {
  int w0[ITEMS], w1[ITEMS], pv[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    w0[i] = (int)(r.h[i] >> 32);
    const int low = (int)(unsigned)r.h[i] ^ (int)0x80000000;
    w1[i] = low;
    pv[i] = NW == 2 ? r.l[i] : low;
  }
  store_ints(ok0 + off, w0, vec);
  if (NW == 2) store_ints(ok1 + off, w1, vec);
  store_ints(ov + off, pv, vec);
  if (num_samples) {
    const int log_t = __ffs(T) - 1;
    const int log_chunk = __ffs(T / num_samples) - 1;
    const int chunk_mask = (1 << log_chunk) - 1;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long e = off + i;
      const int pos = (int)(e & (T - 1));
      if (((pos + 1) & chunk_mask) == 0) {
        const long long q =
            (e >> log_t) * num_samples + ((pos + 1) >> log_chunk) - 1;
        sk0[q] = w0[i];
        if (NW == 2) sk1[q] = w1[i];
        ssv[q] = pv[i];
      }
    }
  }
}

// Whether every non-null pointer is 16-byte aligned.
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (p && ((unsigned long long)p & 15)) return false;
  }
  return true;
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB only
// by opt-in, up to 227 KB a block on the H100).
template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace repro
