// K3: splitter ranks (step 6 of GPU BUCKET SORT, unfused): for every tile
// and each of its S splitters, the count of tile elements
// lexicographically below the splitter on (*words, payload).
//
// Replaces the TPU kernel src/repro/kernels/splitter.py:splitter_ranks
// (_splitter_kernel + _lt_matrix).  It keeps the TPU kernel's contract: it
// COUNTS, so it is right on unsorted tiles and on unsorted splitters (the
// partial sort, the unfused bucket round and, later, the distributed sort
// and the baselines call it).  It does not binary-search as K2 does.
//
// Layout: one CTA of 128 threads per tile.  The tile's splitters are
// staged in shared memory, up to 1024 at a time.  Each thread holds 8 tile
// elements in registers at a time (128 x 8 = 1024 per pass over the tile)
// and, for every staged splitter, counts its elements below it; each
// warp's count is summed with __reduce_add_sync and added to the
// splitter's shared-memory counter by one atomic per warp.
//
// Bound on the H100: the bytes are the whole tile read once (the contract
// allows unsorted tiles), (nw + 1) * 4 * m * T, plus the splitters and the
// ranks.  The operations are T * S lexicographic compares per tile in this
// design (a lower bound for the function is T * ceil(log2(S + 1)) per
// tile, a search of each element among sorted splitters); at S = 63 the
// compares and the warp reductions, not device memory, bound this simple
// version.

#include <cuda_runtime.h>

#include "bitonic_network.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 8;
constexpr int kSplitChunk = 1024;

template <int NW>
__global__ void __launch_bounds__(kThreads)
    splitter_ranks_kernel(const int* __restrict__ k0,
                          const int* __restrict__ k1,
                          const int* __restrict__ v,
                          const int* __restrict__ p0,
                          const int* __restrict__ p1,
                          const int* __restrict__ pv, int* __restrict__ ranks,
                          int T, int S) {
  __shared__ int q0[kSplitChunk];
  __shared__ int q1[NW == 2 ? kSplitChunk : 1];
  __shared__ int qv[kSplitChunk];
  __shared__ int cnt[kSplitChunk];
  const long long tb = (long long)blockIdx.x * T;
  const long long sb = (long long)blockIdx.x * S;
  const int lane = threadIdx.x & 31;

  for (int c0 = 0; c0 < S; c0 += kSplitChunk) {
    const int ns = S - c0 < kSplitChunk ? S - c0 : kSplitChunk;
    for (int j = threadIdx.x; j < ns; j += kThreads) {
      q0[j] = p0[sb + c0 + j];
      if (NW == 2) q1[j] = p1[sb + c0 + j];
      qv[j] = pv[sb + c0 + j];
      cnt[j] = 0;
    }
    __syncthreads();
    for (int e0 = 0; e0 < T; e0 += kThreads * kPerThread) {
      int a0[kPerThread], a1[kPerThread], av[kPerThread];
      bool ok[kPerThread];
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int i = e0 + u * kThreads + threadIdx.x;
        ok[u] = i < T;
        a0[u] = ok[u] ? k0[tb + i] : 0;
        a1[u] = (NW == 2 && ok[u]) ? k1[tb + i] : 0;
        av[u] = ok[u] ? v[tb + i] : 0;
      }
      for (int j = 0; j < ns; ++j) {
        const int b0 = q0[j], b1 = NW == 2 ? q1[j] : 0, bv = qv[j];
        unsigned c = 0;
#pragma unroll
        for (int u = 0; u < kPerThread; ++u) {
          // element < splitter  <=>  splitter > element
          c += ok[u] && repro::key_gt<NW>(b0, b1, bv, a0[u], a1[u], av[u]);
        }
        c = __reduce_add_sync(0xffffffffu, c);
        if (lane == 0 && c != 0) atomicAdd(&cnt[j], (int)c);
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < ns; j += kThreads) ranks[sb + c0 + j] = cnt[j];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// m tiles of T elements (any order), S >= 1 splitters per tile (any order).
// k1/p1 are ignored when nw == 1.  Returns cudaGetLastError().
int repro_splitter_ranks(int nw, const void* k0, const void* k1,
                         const void* v, const void* p0, const void* p1,
                         const void* pv, void* ranks, long long m, int T,
                         int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nw == 1) {
    splitter_ranks_kernel<1><<<(unsigned)m, kThreads, 0, st>>>(
        (const int*)k0, (const int*)k1, (const int*)v, (const int*)p0,
        (const int*)p1, (const int*)pv, (int*)ranks, T, S);
  } else {
    splitter_ranks_kernel<2><<<(unsigned)m, kThreads, 0, st>>>(
        (const int*)k0, (const int*)k1, (const int*)v, (const int*)p0,
        (const int*)p1, (const int*)pv, (int*)ranks, T, S);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
