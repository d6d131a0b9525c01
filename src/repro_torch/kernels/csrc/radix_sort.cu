// K5: stable LSD radix sort of (m, T) rows on the key words alone, the
// payload carried along, with the optional sample epilogue of K1.
//
// Replaces the TPU kernel src/repro/kernels/radix.py:radix_sort_rows
// (digit_rank + _hillis), launched through bitonic.py:tile_sort_call by
// radix.sort_tiles_kv and radix.sort_tiles_sample_kv.
//
// Layout: as K1 (tile_rows.cuh): one CTA sorts rows_per_cta rows of T
// elements held in dynamic shared memory, one int32 array per key word plus
// one for the payload.  Each thread ranks ITEMS elements, warp-striped: item
// i of lane l in warp w is element w * 32 * ITEMS + i * 32 + l.
//
// Each key word (least significant first) takes 32 / radix_bits passes of a
// radix_bits-wide digit, read from the canonical word (biased ^ 0x80000000,
// shifted as unsigned).  A pass:
//   1. ranks each element within its warp, items in order: radix_bits warp
//      ballots give every lane the lanes holding its digit; its rank is the
//      warp's count of that digit in earlier items (lane d keeps the count
//      of digit d in a register, read by a shuffle) plus the lanes of its
//      digit below it.  No shared memory and no atomics.
//   2. scans the per-warp digit counts exclusively in digit-major,
//      warp-minor order, giving each (digit, warp) its first destination.
//      That order, with (item, lane) order inside a warp, is element order:
//      the pass is stable, which is the whole contract (equal keys keep the
//      order they came in, so increasing payloads give K1's order).
//   3. moves every array to its destinations in place: each thread reads its
//      items into registers, a barrier, writes them, a barrier.  There is no
//      room for a second copy of the row: at T = 16384 with two key words the
//      row alone takes 192 KB of the 227 KB a block may have.
// Rows that share a CTA (T < 2048) carry their row index as one more array
// and are sorted on it after the key words, in ceil(log2(rows_per_cta) /
// radix_bits) more passes, so that every row ends sorted in its own place.
//
// Bound on the H100: as K1, the bytes bound is 2 * (nw + 1) * 4 * m * T over
// 3.35 TB/s.  The kernel makes nw * 32 / radix_bits passes over shared
// memory, each with radix_bits + 1 ballots and two shuffles per element and
// 2 * (nw + 2) barriers a CTA: this first version is bound by instruction
// issue and barrier latency in shared memory.  Fewer, wider passes (8-bit
// digits with shared-memory counters, as CUB's block radix sort) are later
// work; radix_bits stays the plan's, for the autotuner to search.

#include <cuda_runtime.h>

#include "tile_rows.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_DIGITS = 16;

__device__ __forceinline__ int canonical_digit(int biased, int shift,
                                               int mask) {
  return (int)(((unsigned)biased ^ 0x80000000u) >> shift) & mask;
}

// Moves this thread's items of array a (element first + i * 32) to dest[i],
// in place; every thread of the block calls it.
template <int ITEMS>
__device__ __forceinline__ void permute(int* a, const int (&dest)[ITEMS],
                                        int first, int E) {
  int tmp[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int idx = first + i * 32;
    tmp[i] = idx < E ? a[idx] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (first + i * 32 < E) a[dest[i]] = tmp[i];
  }
  __syncthreads();
}

template <int NW, int ITEMS, bool ROWS>
__global__ void __launch_bounds__(MAX_THREADS)
    radix_sort_kernel(const int* __restrict__ k0, const int* __restrict__ k1,
                      const int* __restrict__ v, int* __restrict__ ok0,
                      int* __restrict__ ok1, int* __restrict__ ov,
                      int* __restrict__ sk0, int* __restrict__ sk1,
                      int* __restrict__ sv, int T, int rows_per_cta,
                      int num_samples, int radix_bits) {
  extern __shared__ int smem[];
  __shared__ int wc[MAX_DIGITS * MAX_WARPS];
  const int E = T * rows_per_cta;
  int* s0 = smem;
  int* s1 = smem + E;  // used only when NW == 2
  int* sval = smem + NW * E;
  int* srow = smem + (NW + 1) * E;  // used only when ROWS
  const long long base = (long long)blockIdx.x * E;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1;
  const int first = warp * 32 * ITEMS + lane;
  const int D = 1 << radix_bits;
  const int mask = D - 1;

  repro::load_rows<NW>(s0, s1, sval, k0, k1, v, base, E);
  if (ROWS) {
    const int log_t = __ffs(T) - 1;
    for (int i = threadIdx.x; i < E; i += blockDim.x) srow[i] = i >> log_t;
  }
  __syncthreads();

  const int word_passes = 32 / radix_bits;
  const int key_passes = NW * word_passes;
  const int row_passes =
      ROWS ? (__ffs(rows_per_cta) - 1 + radix_bits - 1) / radix_bits : 0;

  for (int pass = 0; pass < key_passes + row_passes; ++pass) {
    // The array this pass takes its digit from, and the digit's place.
    const bool key = pass < key_passes;
    const int* src = !key ? srow
                     : NW == 2 && pass < word_passes ? s1
                                                     : s0;
    const int shift =
        (key ? pass % word_passes : pass - key_passes) * radix_bits;
    auto digit_of = [&](int idx) -> int {
      if (idx >= E) return 0;
      const int x = src[idx];
      return key ? canonical_digit(x, shift, mask) : (x >> shift) & mask;
    };

    // 1. Rank within the warp.
    int dest[ITEMS];
    unsigned count = 0;  // lane d < D: digit d in this warp's earlier items
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int idx = first + i * 32;
      const int d = digit_of(idx);
      unsigned same = __ballot_sync(FULL, idx < E);  // valid lanes
      unsigned mine = same;
      for (int b = 0; b < radix_bits; ++b) {
        const unsigned set = __ballot_sync(FULL, (d >> b) & 1);
        same &= ((d >> b) & 1) ? set : ~set;
        mine &= ((lane >> b) & 1) ? set : ~set;
      }
      dest[i] = (int)__shfl_sync(FULL, count, d) + __popc(same & below);
      count += __popc(mine);
    }

    // 2. Exclusive scan of the (digit, warp) counts, digit-major.
    if (lane < D) wc[lane * nwarps + warp] = (int)count;
    __syncthreads();
    if (warp == 0) {
      const int n = D * nwarps;
      const int per = (n + 31) / 32;
      int sum = 0;
      for (int j = 0; j < per; ++j) {
        const int q = lane * per + j;
        if (q < n) sum += wc[q];
      }
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      int run = incl - sum;
      for (int j = 0; j < per; ++j) {
        const int q = lane * per + j;
        if (q < n) {
          const int c = wc[q];
          wc[q] = run;
          run += c;
        }
      }
    }
    __syncthreads();
    const int offset = lane < D ? wc[lane * nwarps + warp] : 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      dest[i] += __shfl_sync(FULL, offset, digit_of(first + i * 32));
    }

    // 3. Every array to its destinations, in place.
    permute<ITEMS>(s0, dest, first, E);
    if (NW == 2) permute<ITEMS>(s1, dest, first, E);
    permute<ITEMS>(sval, dest, first, E);
    if (ROWS) permute<ITEMS>(srow, dest, first, E);
  }

  repro::store_rows<NW>(s0, s1, sval, ok0, ok1, ov, sk0, sk1, sv, base, E, T,
                        num_samples);
}

struct Args {
  const int *k0, *k1, *v;
  int *ok0, *ok1, *ov, *sk0, *sk1, *sv;
  long long m;
  int T, rows_per_cta, num_samples, radix_bits;
  cudaStream_t stream;
};

template <int NW, int ITEMS, bool ROWS>
cudaError_t launch_items(const Args& a, int threads) {
  const int E = a.T * a.rows_per_cta;
  const size_t smem = (size_t)(NW + 1 + ROWS) * E * sizeof(int);
  cudaError_t err = repro::allow_shared(radix_sort_kernel<NW, ITEMS, ROWS>, smem);
  if (err != cudaSuccess) return err;
  radix_sort_kernel<NW, ITEMS, ROWS>
      <<<(unsigned)(a.m / a.rows_per_cta), threads, smem, a.stream>>>(
          a.k0, a.k1, a.v, a.ok0, a.ok1, a.ov, a.sk0, a.sk1, a.sv, a.T,
          a.rows_per_cta, a.num_samples, a.radix_bits);
  return cudaGetLastError();
}

template <int NW>
cudaError_t launch(const Args& a) {
  // E / 8 threads, 32 to 512: ITEMS = E / threads is 1 to 32 (1 with
  // lanes past E idle when E < 32).
  const int E = a.T * a.rows_per_cta;
  int threads = E / 8;
  threads = threads < 32 ? 32 : threads > MAX_THREADS ? MAX_THREADS : threads;
  const int items = E <= threads ? 1 : E / threads;
  const bool rows = a.rows_per_cta > 1;
  switch (items) {
    case 1:
      return rows ? launch_items<NW, 1, true>(a, threads)
                  : launch_items<NW, 1, false>(a, threads);
    case 2:
      return rows ? launch_items<NW, 2, true>(a, threads)
                  : launch_items<NW, 2, false>(a, threads);
    case 4:
      return rows ? launch_items<NW, 4, true>(a, threads)
                  : launch_items<NW, 4, false>(a, threads);
    case 8:
      return rows ? launch_items<NW, 8, true>(a, threads)
                  : launch_items<NW, 8, false>(a, threads);
    case 16:  // E = 8192: one row a CTA
      return rows ? cudaErrorInvalidValue : launch_items<NW, 16, false>(a, threads);
    case 32:  // E = 16384
      return rows ? cudaErrorInvalidValue : launch_items<NW, 32, false>(a, threads);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Sorts m rows of T elements stably on their nw key words (m a multiple of
// rows_per_cta, T a power of two, T * rows_per_cta <= 16384), radix_bits in
// {1, 2, 4}.  k1/ok1/sk1 are ignored when nw == 1; sk0/sk1/sv when
// num_samples == 0.  Returns cudaGetLastError().
int repro_radix_sort(int nw, const void* k0, const void* k1, const void* v,
                     void* ok0, void* ok1, void* ov, void* sk0, void* sk1,
                     void* sv, long long m, int T, int rows_per_cta,
                     int num_samples, int radix_bits, void* stream) {
  if (radix_bits != 1 && radix_bits != 2 && radix_bits != 4) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{(const int*)k0, (const int*)k1, (const int*)v, (int*)ok0,
               (int*)ok1,      (int*)ov,       (int*)sk0,      (int*)sk1,
               (int*)sv,       m,              T,              rows_per_cta,
               num_samples,    radix_bits,     (cudaStream_t)stream};
  return (int)(nw == 1 ? launch<1>(a) : launch<2>(a));
}

}  // extern "C"
