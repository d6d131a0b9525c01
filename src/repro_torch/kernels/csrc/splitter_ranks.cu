// K3: splitter ranks (step 6 of GPU BUCKET SORT, unfused): for every tile
// and each of its S splitters, the count of tile elements
// lexicographically below the splitter on (*words, payload).
//
// Replaces the TPU kernel src/repro/kernels/splitter.py:splitter_ranks
// (_splitter_kernel + _lt_matrix), which builds a T x S comparison matrix
// and sums it.  It keeps that kernel's contract: tiles and splitters may be
// in any order and splitters may repeat (the partial sort, the unfused
// bucket round and, later, the distributed sort and the baselines call it).
//
// Design: each element searches the splitters, not the other way round.
// A CTA stages up to 1024 of its tile's splitters in shared memory, packed
// (packed_key.cuh), and, unless they arrive in order, orders them on (key,
// index) by counting.  It copies its tile into shared memory in slabs of 16
// elements a thread with cp.async (no registers held while the copy is in
// flight, so with one key word six CTAs fit an SM; the splitters' loads go
// first and the
// first slab travels while they are staged).  Each thread then reads a
// contiguous run of 16 elements, four 16-byte words (a swizzled layout
// keeps the copy and the reads free of bank conflicts), and
// binary-searches each among the sorted splitters: b(e), the number of
// splitters <= e, in floor(log2 S) + 1 steps.  A run that is in order (all
// of a sorted tile's are) has its buckets between those of its two ends:
// when they agree, which on a sorted tile they mostly do, two searches place
// all 16, and else each element searches only that range.  A histogram of b
// over the tile, scanned, gives each sorted splitter's rank (elements with
// b <= k are exactly those below splitter k); equal splitters get equal
// ranks, and each rank is written to its splitter's original place.  A
// thread adds a run of equal b to the histogram with one shared atomic, so
// a sorted tile, where neighbours share a bucket, costs about one atomic per
// thread.  More than 1024 splitters are staged and counted in chunks, each
// a pass over the tile.  When there are too few tiles to fill the card (the
// wrapper's ranks_geometry), a tile is cut into parts, one CTA each, whose
// partial ranks are summed into the zeroed output with integer atomics:
// order-free, so still exact.
//
// Bound on the H100: the bytes are the whole tile read once (the contract
// allows unsorted tiles), (nw + 1) * 4 * m * T, plus the splitters and the
// ranks; the operations are ceil(log2(S + 1)) compares per element.  At
// S = 63 that is 6 compares of one int64 (one word) against the bytes of
// 8 per element, so device memory bounds it, and the design keeps the
// copy streaming: cp.async into a bank-conflict-free layout, many CTAs an
// SM, and on sorted tiles two searches per 16 elements.  The splitters'
// S^2 counting sort per CTA, when they arrive out of order, costs about
// 7 % of a 4096-element tile's time at S = 63 (measured below).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "packed_key.cuh"

namespace {

using repro::key_lt;
using repro::PackedKey;

constexpr int kMaxThreads = 256;
constexpr int kChunk = 1024;  // splitters staged in shared memory at once
constexpr int kRun = 16;      // contiguous elements a thread takes per slab
constexpr int kQuads = kRun / 4;

// The staged splitters: packed keys (lo only when NW == 2), each one's
// index within the chunk, and the ns + 1 histogram bins.
template <int NW>
struct Staged {
  long long* hi;
  int* lo;
  int* idx;
  int* hist;

  __device__ Staged(long long* smem, int cap)
      : hi(smem),
        lo((int*)(smem + cap)),
        idx(lo + (NW == 2 ? cap : 0)),
        hist(idx + cap) {}

  __device__ PackedKey<NW> key(int i) const {
    PackedKey<NW> k;
    k.hi = hi[i];
    k.lo = NW == 2 ? lo[i] : 0;
    return k;
  }

  __device__ void put(int i, const PackedKey<NW>& k) {
    hi[i] = k.hi;
    if (NW == 2) lo[i] = k.lo;
  }
};

// The largest power of two <= n, or 0 for n = 0.
__device__ __forceinline__ int top_pow2(int n) {
  return n > 0 ? 1 << (31 - __clz(n)) : 0;
}

// The number of staged (sorted) splitters <= e, known to lie in [lo, hi].
template <int NW>
__device__ __forceinline__ int bucket(const Staged<NW>& st,
                                      const PackedKey<NW>& e, int lo, int hi) {
  int b = lo;
  for (int step = top_pow2(hi - lo); step > 0; step >>= 1) {
    if (b + step <= hi && !key_lt<NW>(e, st.key(b + step - 1))) b += step;
  }
  return b;
}

// A slab is blockDim.x * kRun consecutive elements of a part, thread x's run
// the kRun from x * kRun: quads (4 elements, 16 bytes) 4x to 4x + 3.  In
// shared memory quad c is stored at c ^ ((c >> 3) & 3): the quads of a run
// stay together, swizzled so that both the copy, where neighbouring lanes
// write neighbouring quads, and the reads, where neighbouring lanes read
// quad q of neighbouring runs, are free of bank conflicts.
__device__ __forceinline__ int slab_quad(int c) { return c ^ ((c >> 3) & 3); }

// Copies elements [0, n) of one word array's slab from `src` into shared
// memory: with VEC (n a multiple of 4, src 16-byte aligned) by cp.async,
// whose completion the caller waits for, else by plain loads.
template <bool VEC>
__device__ __forceinline__ void stage_slab(int* dst,
                                           const int* __restrict__ src, int n) {
  if (VEC) {
    for (int c = threadIdx.x; c < n / 4; c += blockDim.x) {
      __pipeline_memcpy_async(dst + 4 * slab_quad(c), src + 4 * c, 16);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      dst[4 * slab_quad(i / 4) + i % 4] = src[i];
    }
  }
}

template <int NW, bool VEC>
__device__ __forceinline__ void stage_slabs(int* s0, int* s1, int* sv,
                                            const int* __restrict__ k0,
                                            const int* __restrict__ k1,
                                            const int* __restrict__ v,
                                            long long at, int n) {
  stage_slab<VEC>(s0, k0 + at, n);
  if (NW == 2) stage_slab<VEC>(s1, k1 + at, n);
  stage_slab<VEC>(sv, v + at, n);
  if (VEC) __pipeline_commit();
}

// Quad q of this thread's run in the staged slab, as packed keys.
template <int NW>
__device__ __forceinline__ void run_quad(const int* s0, const int* s1,
                                         const int* sv, int q,
                                         PackedKey<NW> (&e)[4]) {
  const int at = slab_quad(threadIdx.x * kQuads + q);
  const int4 w0 = reinterpret_cast<const int4*>(s0)[at];
  const int4 w1 = NW == 2 ? reinterpret_cast<const int4*>(s1)[at]
                          : make_int4(0, 0, 0, 0);
  const int4 wv = reinterpret_cast<const int4*>(sv)[at];
  e[0] = repro::pack_key<NW>(w0.x, w1.x, wv.x);
  e[1] = repro::pack_key<NW>(w0.y, w1.y, wv.y);
  e[2] = repro::pack_key<NW>(w0.z, w1.z, wv.z);
  e[3] = repro::pack_key<NW>(w0.w, w1.w, wv.w);
}

// Adds a run of `count` elements of bucket b to the histogram, one shared
// atomic per change of bucket.
__device__ __forceinline__ void tally(int* hist, int b, int count, int& cur,
                                      int& run) {
  if (b != cur) {
    if (run) atomicAdd(&hist[cur], run);
    cur = b;
    run = 0;
  }
  run += count;
}

// Grid: m * split CTAs; CTA b takes part b % split, elements
// [part * part_len, min(T, (part + 1) * part_len)), of tile b / split, in
// slabs of blockDim.x * kRun elements.
template <int NW, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
    splitter_ranks_kernel(const int* __restrict__ k0,
                          const int* __restrict__ k1,
                          const int* __restrict__ v,
                          const int* __restrict__ p0,
                          const int* __restrict__ p1,
                          const int* __restrict__ pv, int* __restrict__ ranks,
                          int T, int S, int split, int part_len) {
  // The slab (16-byte aligned for cp.async), then the staged splitters.
  extern __shared__ __align__(16) int smem[];
  const int slab = blockDim.x * kRun;
  int* s0 = smem;
  int* s1 = s0 + slab;
  int* sv = s1 + (NW == 2 ? slab : 0);
  Staged<NW> st((long long*)(sv + slab), S < kChunk ? S : kChunk);
  const long long tile = blockIdx.x / split;
  const long long part = blockIdx.x % split;
  const long long sb = tile * S;
  const long long start = tile * T + part * part_len;
  const int len = (int)min((long long)part_len, T - part * part_len);

  for (int c0 = 0; c0 < S; c0 += kChunk) {
    const int ns = min(S - c0, kChunk);
    // The splitters' loads go first; the first slab's copy follows them
    // and travels while the splitters are staged.
    for (int j = threadIdx.x; j < ns; j += blockDim.x) {
      st.put(j, repro::load_key<NW>(p0, p1, pv, sb + c0 + j));
    }
    stage_slabs<NW, VEC>(s0, s1, sv, k0, k1, v, start, min(len, slab));
    __syncthreads();
    // Splitters already in order (the sort's callers pass them so) keep
    // their places; others are ordered on (key, index) by counting.  The
    // check saves the count on the sort's path: 0.129 -> 0.121 ms at
    // (9,728 x 4096, S = 63), one word, on an H100 80GB HBM3 at 700 W
    // (scripts/time_kernels.py, this file against the count alone).
    bool ordered = true;
    for (int j = threadIdx.x + 1; j < ns; j += blockDim.x) {
      ordered = ordered && !key_lt<NW>(st.key(j), st.key(j - 1));
    }
    if (__syncthreads_and(ordered)) {
      for (int j = threadIdx.x; j < ns; j += blockDim.x) st.idx[j] = j;
    } else {
      // Splitter j's place, into hist as scratch.
      for (int j = threadIdx.x; j < ns; j += blockDim.x) {
        const PackedKey<NW> kj = st.key(j);
        int pos = 0;
        for (int k = 0; k < ns; ++k) {
          const PackedKey<NW> kk = st.key(k);
          pos += k < j ? !key_lt<NW>(kj, kk) : key_lt<NW>(kk, kj);
        }
        st.hist[j] = pos;
      }
      __syncthreads();
      // Into that order; the keys come again from device memory (cached),
      // as the shared copy is overwritten.
      for (int j = threadIdx.x; j < ns; j += blockDim.x) {
        const int pos = st.hist[j];
        st.put(pos, repro::load_key<NW>(p0, p1, pv, sb + c0 + j));
        st.idx[pos] = j;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j <= ns; j += blockDim.x) st.hist[j] = 0;

    int cur = 0, run = 0;
    for (int s_at = 0; s_at < len; s_at += slab) {
      if (s_at > 0) {
        __syncthreads();  // every thread is done with the last slab
        stage_slabs<NW, VEC>(s0, s1, sv, k0, k1, v, start + s_at,
                             min(len - s_at, slab));
      }
      if (VEC) __pipeline_wait_prior(0);
      __syncthreads();
      const int n = max(0, min(kRun, len - s_at - (int)threadIdx.x * kRun));
      if (n == 0) continue;
      // Every element's bucket lies in [blo, bhi]: between those of the
      // run's ends when the run is in order (a sorted tile's are), else
      // anywhere.
      PackedKey<NW> first, last;
      bool in_order = true;
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        PackedKey<NW> e[4];
        run_quad<NW>(s0, s1, sv, q, e);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (q == 0 && r == 0) {
            first = last = e[0];
          } else if (4 * q + r < n) {
            in_order = in_order && !key_lt<NW>(e[r], last);
            last = e[r];
          }
        }
      }
      int blo = 0, bhi = ns;
      if (in_order) {
        blo = bucket(st, first, 0, ns);
        // Mostly the last element is still below the next splitter.
        bhi = blo == ns || key_lt<NW>(last, st.key(blo))
                  ? blo
                  : bucket(st, last, blo + 1, ns);
      }
      if (blo == bhi) {
        tally(st.hist, blo, n, cur, run);
        continue;
      }
      // Else each element searches [blo, bhi], a quad at a time in step.
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        PackedKey<NW> e[4];
        run_quad<NW>(s0, s1, sv, q, e);
        int b[4] = {blo, blo, blo, blo};
#pragma unroll 1
        for (int step = top_pow2(bhi - blo); step > 0; step >>= 1) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (b[r] + step <= bhi &&
                !key_lt<NW>(e[r], st.key(b[r] + step - 1))) {
              b[r] += step;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (4 * q + r < n) tally(st.hist, b[r], 1, cur, run);
        }
      }
    }
    if (run) atomicAdd(&st.hist[cur], run);
    __syncthreads();

    // Sorted splitter k's rank: bins 0..k summed.  One warp scans, each
    // lane a run of bins.
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int width = (ns + 32) / 32;  // ceil((ns + 1) / 32)
      const int b0 = min(lane * width, ns + 1);
      const int b1 = min(b0 + width, ns + 1);
      int sum = 0;
      for (int b = b0; b < b1; ++b) sum += st.hist[b];
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      int acc = incl - sum;
      for (int b = b0; b < min(b1, ns); ++b) {
        acc += st.hist[b];
        int* out = ranks + sb + c0 + st.idx[b];
        if (split == 1) {
          *out = acc;
        } else if (acc) {
          atomicAdd(out, acc);
        }
      }
    }
    __syncthreads();
  }
}

template <int NW, bool VEC>
cudaError_t launch(const int* k0, const int* k1, const int* v, const int* p0,
                   const int* p1, const int* pv, int* ranks, long long m,
                   int T, int S, int split, int part_len, int threads,
                   cudaStream_t stream) {
  const int cap = S < kChunk ? S : kChunk;
  const size_t smem =
      (size_t)(NW + 1) * threads * kRun * sizeof(int) +
      (size_t)cap * (sizeof(long long) + (NW == 2 ? 4 : 0) + 4) +
      (size_t)(cap + 1) * sizeof(int);
  if (smem > 48 * 1024) {  // above the default, only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        splitter_ranks_kernel<NW, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  splitter_ranks_kernel<NW, VEC>
      <<<(unsigned)(m * split), threads, smem, stream>>>(
          k0, k1, v, p0, p1, pv, ranks, T, S, split, part_len);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// m tiles of T >= 1 elements (any order), S >= 1 splitters per tile (any
// order); each tile in `split` parts of part_len elements (a multiple of
// 16), `threads` (32 to 256) threads a part.  With split > 1 the ranks must
// be zeroed: the parts add into them.  k1/p1 are ignored when nw == 1.
// Returns the first CUDA error, or 0.
int repro_splitter_ranks(int nw, const void* k0, const void* k1,
                         const void* v, const void* p0, const void* p1,
                         const void* pv, void* ranks, long long m, int T,
                         int S, int split, int part_len, int threads,
                         void* stream) {
  // cp.async of 16 bytes needs 16-byte aligned arrays and rows of a
  // multiple of 4 elements.
  const unsigned long long addr = (unsigned long long)k0 |
                                  (unsigned long long)v |
                                  (nw == 2 ? (unsigned long long)k1 : 0ull);
  const bool vec = T % 4 == 0 && addr % 16 == 0;
  auto f = nw == 1 ? (vec ? &launch<1, true> : &launch<1, false>)
                   : (vec ? &launch<2, true> : &launch<2, false>);
  return (int)f((const int*)k0, (const int*)k1, (const int*)v,
                (const int*)p0, (const int*)p1, (const int*)pv, (int*)ranks,
                m, T, S, split, part_len, threads, (cudaStream_t)stream);
}

}  // extern "C"
