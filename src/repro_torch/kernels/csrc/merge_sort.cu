// K6: merge-path sort of (m, T) rows: bitonic runs, then merge levels on the
// key words alone, with the optional sample epilogue of K1.
//
// Replaces the TPU kernel src/repro/kernels/merge.py:merge_sort_rows
// (bitonic_network_rows + _merge_level), launched through
// bitonic.py:tile_sort_call by merge.sort_tiles_kv and
// merge.sort_tiles_sample_kv.
//
// Layout: as K1 (tile_sort.cu), with the same geometry
// (bitonic.py:row_sort_geometry): a CTA sorts rows_per_cta rows of T
// elements, ITEMS consecutive elements a thread, held in registers as packed
// keys from the load to the store.
//   1. Runs: K1's register network (bitonic_network.cuh, bitonic_sort_regs)
//      sorts every sub-row of r0 = min(merge_run, T) elements on (*words,
//      payload).  At r0 <= 32 * ITEMS (the default 512 at 16 items) a run is
//      one warp's and needs no barrier.  When merge_run >= T this is all,
//      and K6 is K1.
//   2. Merge levels, run = r0, 2 r0, ... < T: every thread writes its items
//      once into one shared copy of packed keys (natural order, one slot of
//      padding after every ITEMS, so a warp's writes fall in distinct
//      banks), a barrier; then it finds how many of the slots before its
//      first output come from the left run A of its pair by a merge-path
//      binary search along that diagonal, and merges its ITEMS outputs from
//      the copy back into registers: A[a] goes first unless B[b] is smaller
//      on the key words (with one word the high half of the packed key, with
//      two the whole of it; never the payload), so ties go to the left run
//      and the merge is stable.  A thread whose slots span whole pairs starts
//      each at its beginning.  One barrier pair a level; the copy is the only
//      one (at T = 16384 with two words, 198 KB of the 227 KB a block may
//      take).
//
// Bound on the H100: as K1, the bytes bound is 2 * (nw + 1) * 4 * m * T over
// 3.35 TB/s.  The runs cost log2(r0) * (log2(r0) + 1) / 2 network steps (45
// at r0 = 512, against K1's 78 at T = 4096); each merge level a
// log2(run)-step search and ITEMS sequential compare-and-move steps a
// thread.  It is bound by instruction issue and shared-memory latency.

#include <cuda_runtime.h>

#include "bitonic_network.cuh"
#include "tile_rows.cuh"

namespace {

constexpr int MAX_THREADS = 512;
// One key word and up to 16 items: at most 64 registers a thread (two
// CTAs of 512 threads an SM), which was faster on the H100 at T = 4096
// than the compiler's own choice and no slower at the other widths; with
// two words the compiler's choice was faster.

// Key words of packed keys: a < b.  One word: the high halves; two words:
// the whole keys (the payload is in RegRows::l).
template <int NW>
__device__ __forceinline__ bool words_lt(long long a, long long b) {
  if (NW == 1) return (int)(a >> 32) < (int)(b >> 32);
  return a < b;
}

// Slot of element e in the padded shared copy.
template <int ITEMS>
__device__ __forceinline__ int padded(int e) {
  return e + e / ITEMS;
}

// This thread's ITEMS outputs of the merge of runs of `run` from the shared
// copy; SPAN when a thread's outputs span whole pairs (2 * run < ITEMS).
template <bool SPAN, int NW, int ITEMS>
__device__ __forceinline__ void merge_items(repro::RegRows<NW, ITEMS>& r,
                                            const long long* sh, const int* sl,
                                            int first, int run) {
  const int width = 2 * run;
  int pair = first & ~(width - 1);
  const int q = first - pair;
  // a = slots before `first` taken from A: the first mid with
  // A[mid] > B[q - mid - 1] on the diagonal a + b = q.
  int lo = q > run ? q - run : 0;
  int hi = q < run ? q : run;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (words_lt<NW>(sh[padded<ITEMS>(pair + run + q - mid - 1)],
                     sh[padded<ITEMS>(pair + mid)])) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  int a = lo;
  int b = q - lo;
  long long ha = 0, hb = 0;
  int la = 0, lb = 0;
  if (a < run) {
    ha = sh[padded<ITEMS>(pair + a)];
    if (NW == 2) la = sl[padded<ITEMS>(pair + a)];
  }
  if (b < run) {
    hb = sh[padded<ITEMS>(pair + run + b)];
    if (NW == 2) lb = sl[padded<ITEMS>(pair + run + b)];
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (SPAN && a + b == width) {  // the next pair, from its beginning
      pair += width;
      a = 0;
      b = 0;
      ha = sh[padded<ITEMS>(pair)];
      hb = sh[padded<ITEMS>(pair + run)];
      if (NW == 2) {
        la = sl[padded<ITEMS>(pair)];
        lb = sl[padded<ITEMS>(pair + run)];
      }
    }
    const bool take_a = a < run && (b >= run || !words_lt<NW>(hb, ha));
    r.h[j] = take_a ? ha : hb;
    if (NW == 2) r.l[j] = take_a ? la : lb;
    if (take_a) {
      ++a;
      if (a < run) {
        ha = sh[padded<ITEMS>(pair + a)];
        if (NW == 2) la = sl[padded<ITEMS>(pair + a)];
      }
    } else {
      ++b;
      if (b < run) {
        hb = sh[padded<ITEMS>(pair + run + b)];
        if (NW == 2) lb = sl[padded<ITEMS>(pair + run + b)];
      }
    }
  }
}

template <int NW, int ITEMS>
__global__ void __launch_bounds__(MAX_THREADS, NW == 1 && ITEMS <= 16 ? 2 : 1)
    merge_sort_kernel(const int* __restrict__ k0, const int* __restrict__ k1,
                      const int* __restrict__ v, int* __restrict__ ok0,
                      int* __restrict__ ok1, int* __restrict__ ov,
                      int* __restrict__ sk0, int* __restrict__ sk1,
                      int* __restrict__ sv, int T, int num_samples,
                      int merge_run, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = blockDim.x * ITEMS;
  long long* sh = reinterpret_cast<long long*>(smem);
  int* sl = reinterpret_cast<int*>(sh + E + E / ITEMS);  // when NW == 2
  const int first = threadIdx.x * ITEMS;
  const long long off = (long long)blockIdx.x * E + first;

  repro::RegRows<NW, ITEMS> r;
  repro::load_regs(r, k0, k1, v, off, vec);
  const int r0 = merge_run < T ? merge_run : T;
  repro::bitonic_sort_regs(r, sh, sl, r0);
  for (int run = r0; run < T; run <<= 1) {
    __syncthreads();  // the previous level's (or step's) reads are done
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      sh[padded<ITEMS>(first + i)] = r.h[i];
      if (NW == 2) sl[padded<ITEMS>(first + i)] = r.l[i];
    }
    __syncthreads();
    if (2 * run < ITEMS) {
      merge_items<true>(r, sh, sl, first, run);
    } else {
      merge_items<false>(r, sh, sl, first, run);
    }
  }
  repro::store_regs(r, ok0, ok1, ov, sk0, sk1, sv, off, T, num_samples, vec);
}

struct Args {
  const int *k0, *k1, *v;
  int *ok0, *ok1, *ov, *sk0, *sk1, *sv;
  long long m;
  int T, rows_per_cta, num_samples, merge_run, threads, smem;
  cudaStream_t stream;
};

template <int NW, int ITEMS>
cudaError_t launch_items(const Args& a) {
  cudaError_t err = repro::allow_shared(merge_sort_kernel<NW, ITEMS>, a.smem);
  if (err != cudaSuccess) return err;
  const bool vec = repro::aligned16({a.k0, a.k1, a.v, a.ok0, a.ok1, a.ov});
  merge_sort_kernel<NW, ITEMS>
      <<<(unsigned)(a.m / a.rows_per_cta), a.threads, a.smem, a.stream>>>(
          a.k0, a.k1, a.v, a.ok0, a.ok1, a.ov, a.sk0, a.sk1, a.sv, a.T,
          a.num_samples, a.merge_run, vec);
  return cudaGetLastError();
}

template <int NW>
cudaError_t launch(const Args& a, int items) {
  switch (items) {
    case 2: return launch_items<NW, 2>(a);
    case 4: return launch_items<NW, 4>(a);
    case 8: return launch_items<NW, 8>(a);
    case 16: return launch_items<NW, 16>(a);
    case 32: return launch_items<NW, 32>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Sorts m rows of T elements (m a multiple of rows_per_cta, T a power of
// two): runs of min(merge_run, T) on (*words, payload), merged stably on
// the key words; merge_run a power of two >= 2.  The geometry is
// bitonic.py:row_sort_geometry's, as for repro_tile_sort, with `smem` its
// merge copy's bytes.  k1/ok1/sk1 are ignored when nw == 1; sk0/sk1/sv
// when num_samples == 0.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a merge_run or geometry the kernel does not
// take.
int repro_merge_sort(int nw, const void* k0, const void* k1, const void* v,
                     void* ok0, void* ok1, void* ov, void* sk0, void* sk1,
                     void* sv, long long m, int T, int rows_per_cta,
                     int num_samples, int merge_run, int threads, int items,
                     int smem, void* stream) {
  if (merge_run < 2 || (merge_run & (merge_run - 1)) || threads < 1 ||
      threads > MAX_THREADS ||
      (long long)threads * items != (long long)T * rows_per_cta) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{(const int*)k0, (const int*)k1, (const int*)v, (int*)ok0,
               (int*)ok1,      (int*)ov,       (int*)sk0,      (int*)sk1,
               (int*)sv,       m,              T,              rows_per_cta,
               num_samples,    merge_run,      threads,        smem,
               (cudaStream_t)stream};
  return (int)(nw == 1 ? launch<1>(a, items) : launch<2>(a, items));
}

}  // extern "C"
