// K5: stable LSD radix sort of (m, T) rows on the key words alone, the
// payload carried along, with the optional sample epilogue of K1.
//
// Replaces the TPU kernel src/repro/kernels/radix.py:radix_sort_rows
// (digit_rank + _hillis), launched through bitonic.py:tile_sort_call by
// radix.sort_tiles_kv and radix.sort_tiles_sample_kv.
//
// Layout: a CTA of `threads` threads sorts rows_per_cta rows of T elements
// (E = rows_per_cta * T), ITEMS elements a thread, held in registers from
// the load to the store; the launch geometry is radix.py:radix_geometry,
// passed in.  An element is one canonical 64-bit key u, each biased word
// ^ 0x80000000 so that unsigned order is the port's order: (w0, payload)
// with one key word, (w0, w1) with two and the payload beside it.  While
// it sorts, a thread holds its items warp-striped: item i of lane l in
// warp w is element w * 32 * ITEMS + i * 32 + l, so that a warp's items in
// (item, lane) order are its elements in order.
//
// Each pass sorts stably on one 8-bit digit, least significant first: four
// passes a key word.  The width is the kernel's own (digit_bits of the
// geometry): a stable sort on the key words has one result whatever its
// digit width, so the plan's radix_bits sets only the plain version's
// passes.  A pass:
//   1. ranks each element within its warp, items in order: __match_any_sync
//      gives the lanes whose item holds the same digit; the element's rank
//      is the warp's count of that digit in earlier items (the warp's own
//      histogram of 256 counters in shared memory, which the lowest of
//      those lanes then advances) plus the lanes below it among them.
//   2. scans the histograms exclusively in digit-major, warp-minor order
//      (each thread owns 256 / threads digits, or one), giving each
//      (digit, warp) its first destination.  That order, with (item, lane)
//      order inside a warp, is element order: the pass is stable, which is
//      the whole contract (equal keys keep the order they came in, random
//      payloads included).
//   3. writes every element to its destination in one shared exchange
//      array, and after a barrier each thread reads its next items.
// Four barriers a pass.  The exchange is swizzled (element p in slot
// p ^ ((p >> log2 ITEMS) & 15) of the 8-byte keys, & 31 of the 4-byte
// payloads) so that reading items warp-striped, or a thread's ITEMS
// consecutive elements, is free of bank conflicts.  After the last pass
// each thread reads ITEMS consecutive elements, and tile_rows.cuh's
// store_regs writes them with 16-byte stores and takes the samples.
// Rows that share a CTA (T < 2048) carry their row index through the
// exchange and are sorted on it after the key words, ceil(log2(rows_per_cta)
// / 8) passes more, so that every row ends sorted in its own place.
//
// Bound on the H100: as K1, the bytes bound is 2 * (nw + 1) * 4 * m * T over
// 3.35 TB/s (0.323 ms at 16,384 x 4096 with one word).  The kernel runs
// 4 * nw passes; an element's pass is a match, three shared histogram
// accesses, a scattered 8-byte shared store (12 bytes with two words), a
// conflict-free load and their address arithmetic.  It is bound by
// instruction issue, the bank conflicts of those random shared accesses
// and four barriers a pass.

#include <cuda_runtime.h>

#include "tile_rows.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 512;
constexpr int BITS = 8;
constexpr int DIGITS = 1 << BITS;
// Each word's bias: u ^ CANON is the loaded pair, u ^ HIGH the packed key
// of K1 (pack2: the high word biased, the low one canonical).
constexpr unsigned long long CANON = 0x8000000080000000ull;
constexpr unsigned long long HIGH = 0x8000000000000000ull;

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

// Exchange slot of element p: MASK 15 for the 8-byte keys, 31 for the
// 4-byte payloads and rows.
template <int ITEMS, int MASK>
__device__ __forceinline__ int slot(int p) {
  constexpr int SHIFT = log2i(ITEMS);
  return p ^ ((p >> SHIFT) & MASK);
}

template <int NW, int ITEMS, bool ROWS>
struct Items {
  unsigned long long u[ITEMS];
  int l[NW == 2 ? ITEMS : 1];    // payloads when NW == 2
  int row[ROWS ? ITEMS : 1];     // row within the CTA when ROWS
};

// The digit of a pass: the bytes of the least significant key word first
// (w1 with two words), then of w0, then of the row index.
template <int NW>
__device__ __forceinline__ unsigned digit(unsigned long long u, int row,
                                          int pass, int key_passes) {
  const unsigned x = pass >= key_passes         ? (unsigned)row
                     : NW == 2 && pass < 32 / BITS ? (unsigned)u
                                                   : (unsigned)(u >> 32);
  return __byte_perm(x, 0, 0x4440 | (pass & 3));  // byte pass % 4, zero-extended
}

// Exclusive sum of x over the block's threads in order; every thread calls
// it.  wsum holds one int a warp.  Synchronises the block.
__device__ __forceinline__ int block_exclusive_sum(int x, int* wsum,
                                                   unsigned mask, int lane,
                                                   int warp, int lanes) {
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(mask, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == lanes - 1) wsum[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  return before + incl - x;
}

// Shared bytes the kernel takes: the exchange (at least 32 slots, so that a
// swizzled slot stays inside it), 256 counters and one sum a warp.
__host__ __device__ inline int shared_bytes(int nw, bool rows, int threads,
                                            int items) {
  const int e = threads * items;
  const int slots = e < 32 ? 32 : e;
  const int warps = (threads + 31) / 32;
  return slots * (8 + (nw == 2 ? 4 : 0) + (rows ? 4 : 0)) +
         4 * warps * (DIGITS + 1);
}

// One key word, 16 items, one row a CTA (the main path's T = 4096 and
// 8192 tiles): at most 64 registers a thread, two CTAs of 512 threads
// an SM, which was faster at T = 4096 on the H100 than the compiler's own
// allocation.  The instances that carry rows or two words keep the
// compiler's choice, which was faster for them.
template <int NW, int ITEMS, bool ROWS>
__global__ void __launch_bounds__(MAX_THREADS,
                                  NW == 1 && ITEMS == 16 && !ROWS ? 2 : 1)
    radix_sort_kernel(const int* __restrict__ k0, const int* __restrict__ k1,
                      const int* __restrict__ v, int* __restrict__ ok0,
                      int* __restrict__ ok1, int* __restrict__ ov,
                      int* __restrict__ sk0, int* __restrict__ sk1,
                      int* __restrict__ sv, int T, int rows_per_cta,
                      int num_samples, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockDim.x;
  const int E = n * ITEMS;
  const int slots = E < 32 ? 32 : E;
  const int nwarps = (n + 31) >> 5;
  unsigned long long* xu = reinterpret_cast<unsigned long long*>(smem);
  int* xl = reinterpret_cast<int*>(xu + slots);  // used only when NW == 2
  int* xr = xl + (NW == 2 ? slots : 0);          // used only when ROWS
  int* hist = xr + (ROWS ? slots : 0);           // DIGITS counters a warp
  int* wsum = hist + nwarps * DIGITS;            // one a warp

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lanes = n < 32 ? n : 32;
  const unsigned mask = n < 32 ? (1u << n) - 1u : FULL;
  const unsigned below = (1u << lane) - 1u;
  const int first = warp * 32 * ITEMS + lane;  // item i: first + i * lanes
  const long long base = (long long)blockIdx.x * E;
  int* my_hist = hist + warp * DIGITS;

  Items<NW, ITEMS, ROWS> it{};
  const int log_t = __ffs(T) - 1;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int e = first + i * lanes;
    const long long g = base + e;
    const unsigned lo = (unsigned)(NW == 2 ? k1[g] : v[g]);
    it.u[i] = (((unsigned long long)(unsigned)k0[g] << 32) | lo) ^ CANON;
    if (NW == 2) it.l[i] = v[g];
    if (ROWS) it.row[i] = e >> log_t;
  }

  const int key_passes = NW * 32 / BITS;
  const int passes =
      key_passes + (ROWS ? (__ffs(rows_per_cta) - 1 + BITS - 1) / BITS : 0);
  // This thread's digits in the scan: [d0, d0 + dpt) when d0 < DIGITS.
  const int dpt = DIGITS > n ? DIGITS / n : 1;
  const int d0 = threadIdx.x * dpt;

  for (int pass = 0; pass < passes; ++pass) {
    // 1. Rank within the warp, items in order.
    for (int j = lane; j < DIGITS; j += lanes) my_hist[j] = 0;
    __syncwarp(mask);
    int rank[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const unsigned d =
          digit<NW>(it.u[i], it.row[ROWS ? i : 0], pass, key_passes);
      const unsigned peers = __match_any_sync(mask, d);
      const int prior = my_hist[d];
      const int lower = __popc(peers & below);
      rank[i] = prior + lower;
      __syncwarp(mask);  // every peer has read the count
      if (lower == 0) my_hist[d] = prior + __popc(peers);
      __syncwarp(mask);
    }
    __syncthreads();

    // 2. Exclusive scan of the (digit, warp) counts, digit-major.
    int total = 0;
    if (d0 < DIGITS) {
      for (int k = 0; k < dpt; ++k) {
        for (int w = 0; w < nwarps; ++w) total += hist[w * DIGITS + d0 + k];
      }
    }
    int run = block_exclusive_sum(total, wsum, mask, lane, warp, lanes);
    if (d0 < DIGITS) {
      for (int k = 0; k < dpt; ++k) {
        for (int w = 0; w < nwarps; ++w) {
          const int c = hist[w * DIGITS + d0 + k];
          hist[w * DIGITS + d0 + k] = run;
          run += c;
        }
      }
    }
    __syncthreads();

    // 3. Every element to its destination, then the next items back.
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const unsigned d =
          digit<NW>(it.u[i], it.row[ROWS ? i : 0], pass, key_passes);
      const int r = my_hist[d] + rank[i];
      xu[slot<ITEMS, 15>(r)] = it.u[i];
      if (NW == 2) xl[slot<ITEMS, 31>(r)] = it.l[i];
      if (ROWS) xr[slot<ITEMS, 31>(r)] = it.row[i];
    }
    __syncthreads();
    if (pass + 1 < passes) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int p = first + i * lanes;
        it.u[i] = xu[slot<ITEMS, 15>(p)];
        if (NW == 2) it.l[i] = xl[slot<ITEMS, 31>(p)];
        if (ROWS) it.row[i] = xr[slot<ITEMS, 31>(p)];
      }
    }
  }

  // This thread's ITEMS consecutive sorted elements, as K1's packed keys.
  repro::RegRows<NW, ITEMS> r;
  const int mine = threadIdx.x * ITEMS;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    r.h[i] = (long long)(xu[slot<ITEMS, 15>(mine + i)] ^ HIGH);
    if (NW == 2) r.l[i] = xl[slot<ITEMS, 31>(mine + i)];
  }
  repro::store_regs(r, ok0, ok1, ov, sk0, sk1, sv, base + mine, T,
                    num_samples, vec);
}

struct Args {
  const int *k0, *k1, *v;
  int *ok0, *ok1, *ov, *sk0, *sk1, *sv;
  long long m;
  int T, rows_per_cta, num_samples, threads, smem;
  cudaStream_t stream;
};

template <int NW, int ITEMS, bool ROWS>
cudaError_t launch_items(const Args& a) {
  cudaError_t err =
      repro::allow_shared(radix_sort_kernel<NW, ITEMS, ROWS>, a.smem);
  if (err != cudaSuccess) return err;
  const bool vec = repro::aligned16({a.ok0, a.ok1, a.ov});
  radix_sort_kernel<NW, ITEMS, ROWS>
      <<<(unsigned)(a.m / a.rows_per_cta), a.threads, a.smem, a.stream>>>(
          a.k0, a.k1, a.v, a.ok0, a.ok1, a.ov, a.sk0, a.sk1, a.sv, a.T,
          a.rows_per_cta, a.num_samples, vec);
  return cudaGetLastError();
}

// Rows share a CTA only when T < 2048, so at most 2048 elements and 16
// items a thread.
template <int NW>
cudaError_t launch(const Args& a, int items) {
  const bool rows = a.rows_per_cta > 1;
  switch (items) {
    case 2:
      return rows ? launch_items<NW, 2, true>(a) : launch_items<NW, 2, false>(a);
    case 4:
      return rows ? launch_items<NW, 4, true>(a) : launch_items<NW, 4, false>(a);
    case 8:
      return rows ? launch_items<NW, 8, true>(a) : launch_items<NW, 8, false>(a);
    case 16:
      return rows ? launch_items<NW, 16, true>(a)
                  : launch_items<NW, 16, false>(a);
    case 32:
      return rows ? cudaErrorInvalidValue : launch_items<NW, 32, false>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Sorts m rows of T elements stably on their nw key words (m a multiple of
// rows_per_cta, T a power of two) with the geometry of
// radix.py:radix_geometry: `threads` threads of `items` elements each
// (threads * items == rows_per_cta * T, threads <= 512, items in {2, 4, 8,
// 16, 32}), digit_bits 8 and `smem` bytes of dynamic shared memory.
// k1/ok1/sk1 are ignored when nw == 1; sk0/sk1/sv when num_samples == 0.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a geometry the
// kernel does not take.
int repro_radix_sort(int nw, const void* k0, const void* k1, const void* v,
                     void* ok0, void* ok1, void* ov, void* sk0, void* sk1,
                     void* sv, long long m, int T, int rows_per_cta,
                     int num_samples, int threads, int items, int digit_bits,
                     int smem, void* stream) {
  if (threads < 1 || threads > MAX_THREADS || digit_bits != BITS ||
      (long long)threads * items != (long long)T * rows_per_cta ||
      smem < shared_bytes(nw, rows_per_cta > 1, threads, items)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{(const int*)k0, (const int*)k1, (const int*)v, (int*)ok0,
               (int*)ok1,      (int*)ov,       (int*)sk0,      (int*)sk1,
               (int*)sv,       m,              T,              rows_per_cta,
               num_samples,    threads,        smem,           (cudaStream_t)stream};
  return (int)(nw == 1 ? launch<1>(a, items) : launch<2>(a, items));
}

}  // extern "C"
