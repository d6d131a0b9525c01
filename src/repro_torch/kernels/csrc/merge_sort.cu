// K6: merge-path sort of (m, T) rows: bitonic runs, then merge levels on the
// key words alone, with the optional sample epilogue of K1.
//
// Replaces the TPU kernel src/repro/kernels/merge.py:merge_sort_rows
// (bitonic_network_rows + _merge_level), launched through
// bitonic.py:tile_sort_call by merge.sort_tiles_kv and
// merge.sort_tiles_sample_kv.
//
// Layout: as K1 (tile_rows.cuh): one CTA sorts rows_per_cta rows of T
// elements held in dynamic shared memory, one int32 array per key word plus
// one for the payload.
//   1. Runs: K1's network (bitonic_network.cuh) sorts every sub-row of
//      r0 = min(merge_run, T) elements on (*words, payload).  When
//      merge_run >= T this is all, and K6 is K1.
//   2. Merge levels, run = r0, 2 r0, ... < T: thread t owns the ITEMS output
//      slots from t * ITEMS.  It finds how many of the slots before its first
//      come from the left run A of its pair by a merge-path binary search
//      along that diagonal, then merges its slots sequentially: A[a] goes
//      first unless B[b] is smaller on the key words (ties to the left run,
//      which keeps the merge stable).  A thread whose slots span whole pairs
//      starts each at its beginning.  It records the source of each slot;
//      then every array is moved in place: read into registers, a barrier,
//      write, a barrier.  There is no room for a second copy of the row: at
//      T = 16384 with two key words the row alone takes 192 KB of 227 KB.
//
// Bound on the H100: as K1, the bytes bound is 2 * (nw + 1) * 4 * m * T over
// 3.35 TB/s.  The runs cost log2(r0) * (log2(r0) + 1) / 2 network steps
// (45 at r0 = 512, against K1's 78 at T = 4096), each a barrier apart; each
// merge level costs a log2(run)-step search and ITEMS sequential
// compare-and-move steps a thread, with 2 * (nw + 1) barriers.  This first
// version is bound by shared-memory traffic and barrier latency; merging in
// registers across warps without the per-array round trips is later work.

#include <cuda_runtime.h>

#include "bitonic_network.cuh"
#include "tile_rows.cuh"

namespace {

constexpr int MAX_THREADS = 512;

// Key words of elements i and j: i > j (biased words, signed order).
template <int NW>
__device__ __forceinline__ bool keys_gt(const int* s0, const int* s1, int i,
                                        int j) {
  if (s0[i] != s0[j]) return s0[i] > s0[j];
  return NW == 2 && s1[i] > s1[j];
}

// Writes a[src[j]] to a[first + j] for this thread's slots, in place; every
// thread of the block calls it.
template <int ITEMS>
__device__ __forceinline__ void gather(int* a, const int (&src)[ITEMS],
                                       int first, bool active) {
  int tmp[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) tmp[j] = active ? a[src[j]] : 0;
  __syncthreads();
  if (active) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) a[first + j] = tmp[j];
  }
  __syncthreads();
}

template <int NW, int ITEMS>
__global__ void __launch_bounds__(MAX_THREADS)
    merge_sort_kernel(const int* __restrict__ k0, const int* __restrict__ k1,
                      const int* __restrict__ v, int* __restrict__ ok0,
                      int* __restrict__ ok1, int* __restrict__ ov,
                      int* __restrict__ sk0, int* __restrict__ sk1,
                      int* __restrict__ sv, int T, int rows_per_cta,
                      int num_samples, int merge_run) {
  extern __shared__ int smem[];
  const int E = T * rows_per_cta;
  int* s0 = smem;
  int* s1 = smem + E;  // used only when NW == 2
  int* sval = smem + NW * E;
  const long long base = (long long)blockIdx.x * E;

  repro::load_rows<NW>(s0, s1, sval, k0, k1, v, base, E);
  __syncthreads();
  const int r0 = merge_run < T ? merge_run : T;
  repro::bitonic_sort_rows<NW>(s0, s1, sval, E, r0);

  const int first = threadIdx.x * ITEMS;
  const bool active = first < E;
  for (int run = r0; run < T; run <<= 1) {
    const int width = 2 * run;
    int src[ITEMS];
    if (active) {
      int pair = first & ~(width - 1);
      const int q = first - pair;
      // a = slots before `first` taken from A: the first mid with
      // A[mid] > B[q - mid - 1] on the diagonal a + b = q.
      int lo = q > run ? q - run : 0;
      int hi = q < run ? q : run;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (!keys_gt<NW>(s0, s1, pair + mid, pair + run + q - mid - 1)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      int a = lo;
      int b = q - lo;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if (a + b == width) {  // the next pair (only when ITEMS > width)
          pair += width;
          a = 0;
          b = 0;
        }
        const bool take_a =
            a < run &&
            (b >= run || !keys_gt<NW>(s0, s1, pair + a, pair + run + b));
        src[j] = take_a ? pair + a : pair + run + b;
        a += take_a;
        b += !take_a;
      }
    }
    gather<ITEMS>(s0, src, first, active);
    if (NW == 2) gather<ITEMS>(s1, src, first, active);
    gather<ITEMS>(sval, src, first, active);
  }

  repro::store_rows<NW>(s0, s1, sval, ok0, ok1, ov, sk0, sk1, sv, base, E, T,
                        num_samples);
}

struct Args {
  const int *k0, *k1, *v;
  int *ok0, *ok1, *ov, *sk0, *sk1, *sv;
  long long m;
  int T, rows_per_cta, num_samples, merge_run;
  cudaStream_t stream;
};

template <int NW, int ITEMS>
cudaError_t launch_items(const Args& a, int threads) {
  const int E = a.T * a.rows_per_cta;
  const size_t smem = (size_t)(NW + 1) * E * sizeof(int);
  cudaError_t err = repro::allow_shared(merge_sort_kernel<NW, ITEMS>, smem);
  if (err != cudaSuccess) return err;
  merge_sort_kernel<NW, ITEMS>
      <<<(unsigned)(a.m / a.rows_per_cta), threads, smem, a.stream>>>(
          a.k0, a.k1, a.v, a.ok0, a.ok1, a.ov, a.sk0, a.sk1, a.sv, a.T,
          a.rows_per_cta, a.num_samples, a.merge_run);
  return cudaGetLastError();
}

template <int NW>
cudaError_t launch(const Args& a) {
  // E / 8 threads, 32 to 512: ITEMS = E / threads is 1 to 32 (1 with
  // threads past E idle when E < 32).
  const int E = a.T * a.rows_per_cta;
  int threads = E / 8;
  threads = threads < 32 ? 32 : threads > MAX_THREADS ? MAX_THREADS : threads;
  switch (E <= threads ? 1 : E / threads) {
    case 1: return launch_items<NW, 1>(a, threads);
    case 2: return launch_items<NW, 2>(a, threads);
    case 4: return launch_items<NW, 4>(a, threads);
    case 8: return launch_items<NW, 8>(a, threads);
    case 16: return launch_items<NW, 16>(a, threads);
    case 32: return launch_items<NW, 32>(a, threads);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Sorts m rows of T elements (m a multiple of rows_per_cta, T a power of
// two, T * rows_per_cta <= 16384): runs of min(merge_run, T) on (*words,
// payload), merged stably on the key words; merge_run a power of two >= 2.
// k1/ok1/sk1 are ignored when nw == 1; sk0/sk1/sv when num_samples == 0.
// Returns cudaGetLastError().
int repro_merge_sort(int nw, const void* k0, const void* k1, const void* v,
                     void* ok0, void* ok1, void* ov, void* sk0, void* sk1,
                     void* sv, long long m, int T, int rows_per_cta,
                     int num_samples, int merge_run, void* stream) {
  if (merge_run < 2 || (merge_run & (merge_run - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{(const int*)k0, (const int*)k1, (const int*)v, (int*)ok0,
               (int*)ok1,      (int*)ov,       (int*)sk0,      (int*)sk1,
               (int*)sv,       m,              T,              rows_per_cta,
               num_samples,    merge_run,      (cudaStream_t)stream};
  return (int)(nw == 1 ? launch<1>(a) : launch<2>(a));
}

}  // extern "C"
