// K2: fused splitter partition (steps 6-7 of GPU BUCKET SORT): for every
// sorted tile and each of its S splitters, the splitter's rank (the count of
// tile elements lexicographically below it), and the tile's S + 1 bucket
// counts, counts[j] = ends[j] - starts[j].
//
// Replaces the TPU kernel src/repro/kernels/splitter.py:splitter_partition
// (_partition_kernel + _lt_matrix).  The TPU builds a T x S comparison matrix
// and reduces it, which suits its wide vector unit.  Here each thread does a
// lexicographic lower-bound binary search of one splitter in its tile,
// straight from device memory.  PRECONDITION: every tile is sorted
// ascending on (*words, payload), which always holds on the sort's path
// (K1's output feeds K2); on such tiles the search gives exactly the
// matrix's counts.
//
// Layout: blockDim = (64, tiles_per_cta); thread x of row y handles
// splitters x, x + 64, ... of tile blockIdx.x * tiles_per_cta + y, keeps the
// ranks in shared memory, and after one barrier writes the counts.
//
// Bound on the H100: the work is S * log2(T) dependent probes per tile, so
// the bytes this function must move are the splitters, the outputs and the
// probed elements (S * log2(T) per tile), not the whole tile.  Each probe is
// a dependent load, so the kernel is bound by memory latency; thousands of
// tiles in flight hide it.  Its design reads nothing but the probes.

#include <cuda_runtime.h>

namespace {

template <int NW>
__global__ void splitter_partition_kernel(
    const int* __restrict__ k0, const int* __restrict__ k1,
    const int* __restrict__ v, const int* __restrict__ p0,
    const int* __restrict__ p1, const int* __restrict__ pv,
    int* __restrict__ ranks, int* __restrict__ counts, long long m, int T,
    int S) {
  extern __shared__ int sr[];
  int* r = sr + threadIdx.y * S;
  const long long tile = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (tile < m) {
    const long long tb = tile * T;
    for (int j = threadIdx.x; j < S; j += blockDim.x) {
      const long long sb = tile * S + j;
      const int q0 = p0[sb];
      const int q1 = NW == 2 ? p1[sb] : 0;
      const int qv = pv[sb];
      int lo = 0, hi = T;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const int e0 = k0[tb + mid];
        bool lt;
        if (e0 != q0) {
          lt = e0 < q0;
        } else if (NW == 2 && k1[tb + mid] != q1) {
          lt = k1[tb + mid] < q1;
        } else {
          lt = v[tb + mid] < qv;
        }
        if (lt) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      r[j] = lo;
      ranks[sb] = lo;
    }
  }
  __syncthreads();
  if (tile < m) {
    for (int j = threadIdx.x; j <= S; j += blockDim.x) {
      const int end = j < S ? r[j] : T;
      const int start = j > 0 ? r[j - 1] : 0;
      counts[tile * (S + 1) + j] = end - start;
    }
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// m sorted tiles of T elements, S >= 1 splitters per tile.  k1/p1 are
// ignored when nw == 1.  Returns cudaGetLastError().
int repro_splitter_partition(int nw, const void* k0, const void* k1,
                             const void* v, const void* p0, const void* p1,
                             const void* pv, void* ranks, void* counts,
                             long long m, int T, int S, int tiles_per_cta,
                             void* stream) {
  const dim3 block(64, tiles_per_cta);
  const long long blocks = (m + tiles_per_cta - 1) / tiles_per_cta;
  const size_t smem = (size_t)tiles_per_cta * S * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
  if (nw == 1) {
    splitter_partition_kernel<1><<<(unsigned)blocks, block, smem, st>>>(
        (const int*)k0, (const int*)k1, (const int*)v, (const int*)p0,
        (const int*)p1, (const int*)pv, (int*)ranks, (int*)counts, m, T, S);
  } else {
    splitter_partition_kernel<2><<<(unsigned)blocks, block, smem, st>>>(
        (const int*)k0, (const int*)k1, (const int*)v, (const int*)p0,
        (const int*)p1, (const int*)pv, (int*)ranks, (int*)counts, m, T, S);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
