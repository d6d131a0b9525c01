// K2: fused splitter partition (steps 6-7 of GPU BUCKET SORT): for every
// sorted tile and each of its S splitters, the splitter's rank (the count of
// tile elements lexicographically below it), and the tile's S + 1 bucket
// counts, counts[j] = ends[j] - starts[j].
//
// Replaces the TPU kernel src/repro/kernels/splitter.py:splitter_partition
// (_partition_kernel + _lt_matrix).  The TPU builds a T x S comparison matrix
// and reduces it, which suits its wide vector unit.  PRECONDITION here:
// every tile is sorted ascending on (*words, payload), which always holds on
// the sort's path (K1, K5 or K6 sorted it); on such tiles a search gives
// exactly the matrix's counts.  The kernel does not check it.
//
// Design: a lower-bound search in two dependent round trips to device
// memory.  A CTA takes `tiles` tiles and a warp eight splitters of one tile
// at a time.  The threads load a coarse index of each tile into shared
// memory, packed (packed_key.cuh): the last element of every window of W
// elements (W = min(32, T)), all loads independent, with each warp's
// splitters.  Then lane u < 8 of a warp binary-searches the coarse index
// for its splitter in shared memory: g, the number of windows whose last
// element is below the splitter, all of whose elements therefore are.  The
// warp then loads window g of each of its eight splitters, W elements at
// once (one 128-byte line per word array), all eight in flight; one compare
// a lane and a __ballot_sync / __popc count the window's elements below the
// splitter, and the rank is g * W plus that count (T when g is past the
// last window).  The ranks stay in shared memory for the counts, which
// follow one barrier later.
//
// Bound on the H100: the bytes this function must move are the splitters,
// the outputs and, as the script that measures it counts them, the
// log2(T) elements a binary search of each splitter probes: not the whole
// tile.  This design reads T / W coarse elements (one 32-byte sector each)
// and S windows per tile, about 24 KB of a 32 KB tile at T = 4096, S = 63,
// one word, in two dependent round trips per tile where the old design's
// twelve dependent probes per splitter were bound by latency.  What bounds
// it now is latency per CTA as much as device memory: a CTA takes one tile
// at S = 63, so the card runs 16,384 short CTAs at the 2^26 sort's top
// level.

#include <cuda_runtime.h>

#include "packed_key.cuh"

namespace {

using repro::key_lt;
using repro::PackedKey;

constexpr int kMaxThreads = 256;
constexpr int kBatch = 8;  // splitters a warp takes at once, one window each

// blockDim.x = 32 * warps * tiles: warp w serves tile w / warps of the CTA,
// splitters from kBatch * (w % warps) on, kBatch * warps apart.  Dynamic
// shared memory: the coarse index, hi then lo (lo only when NW == 2), of G
// entries a tile, then the tiles' ranks, S a tile.
template <int NW>
__global__ void __launch_bounds__(kMaxThreads)
    splitter_partition_kernel(const int* __restrict__ k0,
                              const int* __restrict__ k1,
                              const int* __restrict__ v,
                              const int* __restrict__ p0,
                              const int* __restrict__ p1,
                              const int* __restrict__ pv,
                              int* __restrict__ ranks,
                              int* __restrict__ counts, long long m, int T,
                              int S, int warps, int W, int G) {
  extern __shared__ long long smem[];
  const int tiles = blockDim.x / (32 * warps);
  long long* c_hi = smem;
  int* c_lo = (int*)(c_hi + tiles * G);
  int* r = c_lo + (NW == 2 ? tiles * G : 0);
  const long long first = (long long)blockIdx.x * tiles;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = warp / warps;
  const long long tile = first + t;
  const long long tb = tile * T;
  const long long sb = tile * S;
  const int base0 = warp % warps * kBatch;

  // Lane u < kBatch's first splitter is in flight with the coarse index.
  PackedKey<NW> q = {0, 0};
  if (tile < m && lane < kBatch && base0 + lane < S) {
    q = repro::load_key<NW>(p0, p1, pv, sb + base0 + lane);
  }
  for (int i = threadIdx.x; i < tiles * G; i += blockDim.x) {
    const int ti = i / G;
    if (first + ti < m) {
      const int g = i % G;
      const long long e = (first + ti) * T + min(g * W + W - 1, T - 1);
      const PackedKey<NW> key = repro::load_key<NW>(k0, k1, v, e);
      c_hi[i] = key.hi;
      if (NW == 2) c_lo[i] = key.lo;
    }
  }
  __syncthreads();

  if (tile < m) {
    int top = 1;  // the largest power of two <= G
    while (top * 2 <= G) top *= 2;
    for (int base = base0; base < S; base += warps * kBatch) {
      const int j = base + lane;
      const bool mine = lane < kBatch && j < S;
      if (base != base0 && mine) q = repro::load_key<NW>(p0, p1, pv, sb + j);
      // g: the windows whose last element is below q, all of whose
      // elements therefore are.
      int g = G;
      if (mine) {
        g = 0;
#pragma unroll 1
        for (int step = top; step > 0; step >>= 1) {
          if (g + step > G) continue;
          const int c = t * G + g + step - 1;
          PackedKey<NW> ck;
          ck.hi = c_hi[c];
          ck.lo = NW == 2 ? c_lo[c] : 0;
          if (key_lt<NW>(ck, q)) g += step;
        }
      }
      PackedKey<NW> e[kBatch];
      bool in[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int gs = __shfl_sync(0xffffffffu, g, u);
        const int idx = gs * W + lane;
        in[u] = gs < G && lane < W && idx < T;
        e[u] = in[u] ? repro::load_key<NW>(k0, k1, v, tb + idx)
                     : PackedKey<NW>{0, 0};
      }
      int rank = 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        PackedKey<NW> qs;
        qs.hi = __shfl_sync(0xffffffffu, q.hi, u);
        qs.lo = NW == 2 ? __shfl_sync(0xffffffffu, q.lo, u) : 0;
        const int gs = __shfl_sync(0xffffffffu, g, u);
        const unsigned below =
            __ballot_sync(0xffffffffu, in[u] && key_lt<NW>(e[u], qs));
        if (lane == u) rank = gs == G ? T : gs * W + __popc(below);
      }
      if (mine) {
        r[t * S + j] = rank;
        ranks[sb + j] = rank;
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < tiles * (S + 1); i += blockDim.x) {
    const int tt = i / (S + 1);
    const int j = i % (S + 1);
    if (first + tt < m) {
      const int end = j < S ? r[tt * S + j] : T;
      const int start = j > 0 ? r[tt * S + j - 1] : 0;
      counts[(first + tt) * (S + 1) + j] = end - start;
    }
  }
}

template <int NW>
cudaError_t launch(const int* k0, const int* k1, const int* v, const int* p0,
                   const int* p1, const int* pv, int* ranks, int* counts,
                   long long m, int T, int S, int tiles, int warps, int W,
                   int G, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {  // above the default, only by opting in
    const cudaError_t err = cudaFuncSetAttribute(
        splitter_partition_kernel<NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (m + tiles - 1) / tiles;
  splitter_partition_kernel<NW>
      <<<(unsigned)blocks, 32 * warps * tiles, smem, stream>>>(
          k0, k1, v, p0, p1, pv, ranks, counts, m, T, S, warps, W, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// m sorted tiles of T >= 1 elements, S >= 1 splitters per tile, in CTAs of
// `tiles` tiles and `warps` warps a tile (32 * warps * tiles <= 256
// threads), windows of W elements, G = ceil(T / W) a tile, and smem bytes
// of dynamic shared memory (the wrapper's partition_geometry).  k1/p1 are
// ignored when nw == 1.  Returns the first CUDA error, or 0.
int repro_splitter_partition(int nw, const void* k0, const void* k1,
                             const void* v, const void* p0, const void* p1,
                             const void* pv, void* ranks, void* counts,
                             long long m, int T, int S, int tiles, int warps,
                             int W, int G, int smem, void* stream) {
  auto f = nw == 1 ? &launch<1> : &launch<2>;
  return (int)f((const int*)k0, (const int*)k1, (const int*)v,
                (const int*)p0, (const int*)p1, (const int*)pv, (int*)ranks,
                (int*)counts, m, T, S, tiles, warps, W, G, smem,
                (cudaStream_t)stream);
}

}  // extern "C"
