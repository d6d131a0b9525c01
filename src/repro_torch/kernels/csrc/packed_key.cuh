// The lexicographic order on (*words, payload) as one or two integer
// compares, for the kernels that search sorted keys in shared memory, K2
// (splitter_partition.cu) and K3 (splitter_ranks.cu), and for the
// register-resident row sorts, K1 (tile_sort.cu) and K6 (merge_sort.cu),
// which hold their elements as packed keys (bitonic_network.cuh).
//
// Key words are the port's biased int32 words (core/key_codec.py), so the
// order is plain signed int32 order word by word.  Two signed words (a, b)
// pack into one int64 whose signed order is theirs: a in the high half, b
// with its sign bit flipped (signed order as unsigned) in the low half.  A
// one-word key packs (word, payload) into `hi`; a two-word key packs the
// words into `hi` and keeps the payload in `lo`.

#pragma once

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ long long pack2(int a, int b) {
  return (long long)(((unsigned long long)(unsigned)a << 32) |
                     (unsigned)(b ^ (int)0x80000000));
}

template <int NW>
struct PackedKey {
  long long hi;
  int lo;  // the payload when NW == 2, else unused
};

template <int NW>
__device__ __forceinline__ PackedKey<NW> pack_key(int w0, int w1, int v) {
  PackedKey<NW> k;
  if (NW == 1) {
    k.hi = pack2(w0, v);
    k.lo = 0;
  } else {
    k.hi = pack2(w0, w1);
    k.lo = v;
  }
  return k;
}

// a < b, lexicographically.
template <int NW>
__device__ __forceinline__ bool key_lt(const PackedKey<NW>& a,
                                       const PackedKey<NW>& b) {
  if (NW == 1) return a.hi < b.hi;
  return a.hi < b.hi || (a.hi == b.hi && a.lo < b.lo);
}

// Key i of a tile: words k0[i] (and k1[i] when NW == 2), payload v[i].
template <int NW>
__device__ __forceinline__ PackedKey<NW> load_key(const int* __restrict__ k0,
                                                  const int* __restrict__ k1,
                                                  const int* __restrict__ v,
                                                  long long i) {
  return pack_key<NW>(k0[i], NW == 2 ? k1[i] : 0, v[i]);
}

}  // namespace repro
