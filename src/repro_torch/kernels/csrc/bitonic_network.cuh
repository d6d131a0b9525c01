// The bitonic network of the row sorts, and the lexicographic order of
// (key words, payload) it sorts by.
//
// bitonic_sort_regs sorts the rows that the JAX package's
// kernels/bitonic.py:bitonic_network_rows sorts, held in registers as
// packed keys (packed_key.cuh), ITEMS consecutive elements a thread.  A
// stride d < ITEMS is a compare-exchange inside the thread, ITEMS <= d <
// 32 * ITEMS a warp shuffle, and only d >= 32 * ITEMS an exchange through
// shared memory.  Used by K1 (tile_sort.cu), by K6 (merge_sort.cu) for its
// runs and by K4 (topk.cu).  K2 and K3 search the same order on packed keys.
//
// Key words are the port's biased int32 words (core/key_codec.py), so the
// order on (*words, payload) is plain signed int32 order word by word.

#pragma once

#include <cuda_runtime.h>

#include "packed_key.cuh"

namespace repro {

// ---------------------------------------------------------------------
// The register-resident network (K1, K4, K6).
//
// A CTA of n threads sorts E = n * ITEMS consecutive elements: rows of T
// (a power of two) laid end to end.  Thread t holds elements t * ITEMS + i,
// i < ITEMS, as h[i] (and l[i]): with one key word h = pack2(word,
// payload); with two h = pack2(w0, w1) and l = payload.  Signed order on
// (h, l) is the order on (*words, payload).
//
// The network is bitonic sort in its "flip" form: stage `size` first
// compares element e with its mirror e ^ (size - 1), then with e ^ d for
// d = size / 4, ..., 1, every pair ascending (the lower index keeps the
// smaller).  It sorts like the reference's network with its alternating
// directions; since a row's elements are distinct on (words, payload), or
// identical and so indistinguishable, any correct sort gives the same bits.
//
// Where the partner of element t * ITEMS + i lives, for a stride d (or a
// mirror of a stage of 2d):
//   d < ITEMS:               item i ^ d of the same thread (registers);
//   ITEMS <= d < 32 * ITEMS: lane t ^ (d / ITEMS) of the same warp, whose
//                            same item (xor) or item ITEMS - 1 - i (mirror)
//                            comes by __shfl_xor_sync, no barrier;
//   d >= 32 * ITEMS:         another warp: every thread writes its items
//                            to shared memory (item-major, so a warp's
//                            writes and reads are contiguous), a barrier,
//                            and each reads its partners'.
// Whether thread t keeps the smaller or the larger of a pair across
// threads is the same for all its items: (t * ITEMS) & d == 0.

template <int NW, int ITEMS>
struct RegRows {
  long long h[ITEMS];
  int l[NW == 2 ? ITEMS : 1];  // payloads when NW == 2, else unused
};

// (ah, al) > (bh, bl); al/bl are read only when NW == 2.
template <int NW>
__device__ __forceinline__ bool packed_gt(long long ah, int al, long long bh,
                                          int bl) {
  if (NW == 1) return ah > bh;
  return ah > bh || (ah == bh && al > bl);
}

// Items i < j of one thread, ascending.
template <int NW, int ITEMS>
__device__ __forceinline__ void cex(RegRows<NW, ITEMS>& r, int i, int j) {
  const long long hi = r.h[i], hj = r.h[j];
  const int li = r.l[NW == 2 ? i : 0], lj = r.l[NW == 2 ? j : 0];
  const bool swap = packed_gt<NW>(hi, li, hj, lj);
  r.h[i] = swap ? hj : hi;
  r.h[j] = swap ? hi : hj;
  if (NW == 2) {
    r.l[i] = swap ? lj : li;
    r.l[j] = swap ? li : lj;
  }
}

// Item i takes the partner (ph, pl) when that is the one it keeps: the
// smaller unless keep_max.  Equal means identical, so either is right.
template <int NW, int ITEMS>
__device__ __forceinline__ void keep(RegRows<NW, ITEMS>& r, int i,
                                     long long ph, int pl, bool keep_max) {
  const bool take =
      packed_gt<NW>(r.h[i], NW == 2 ? r.l[i] : 0, ph, pl) != keep_max;
  r.h[i] = take ? ph : r.h[i];
  if (NW == 2) r.l[i] = take ? pl : r.l[i];
}

// The in-thread steps of a stage: strides D, D / 2, ..., 1.
template <int NW, int ITEMS, int D>
__device__ __forceinline__ void thread_merge(RegRows<NW, ITEMS>& r) {
  if constexpr (D >= 1) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if ((i & D) == 0) cex(r, i, i ^ D);
    }
    thread_merge<NW, ITEMS, D / 2>(r);
  }
}

// Stages 2, 4, ..., min(ITEMS, top): each thread sorts its items in runs of
// min(ITEMS, top).
template <int NW, int ITEMS, int S = 2>
__device__ __forceinline__ void thread_sort(RegRows<NW, ITEMS>& r, int top) {
  if constexpr (S <= ITEMS) {
    if (S > top) return;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if ((i & (S / 2)) == 0) cex(r, i, i ^ (S - 1));
    }
    thread_merge<NW, ITEMS, S / 4>(r);
    thread_sort<NW, ITEMS, 2 * S>(r, top);
  }
}

// One step across the lanes of a warp: lane ^ lanes is the partner.
template <bool MIRROR, int NW, int ITEMS>
__device__ __forceinline__ void warp_step(RegRows<NW, ITEMS>& r, int lanes,
                                          bool keep_max, unsigned mask) {
  if (MIRROR) {
    // My item i pairs with the partner's item ITEMS - 1 - i; both shuffles
    // of a pair go before either item changes.
#pragma unroll
    for (int i = 0; i < ITEMS / 2; ++i) {
      const int j = ITEMS - 1 - i;
      const long long pi = __shfl_xor_sync(mask, r.h[j], lanes);
      const long long pj = __shfl_xor_sync(mask, r.h[i], lanes);
      int li = 0, lj = 0;
      if (NW == 2) {
        li = __shfl_xor_sync(mask, r.l[j], lanes);
        lj = __shfl_xor_sync(mask, r.l[i], lanes);
      }
      keep(r, i, pi, li, keep_max);
      keep(r, j, pj, lj, keep_max);
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long p = __shfl_xor_sync(mask, r.h[i], lanes);
      const int pl = NW == 2 ? __shfl_xor_sync(mask, r.l[i], lanes) : 0;
      keep(r, i, p, pl, keep_max);
    }
  }
}

// One step across warps, through shared memory: sh holds blockDim.x *
// ITEMS packed keys (sl as many payloads when NW == 2), item-major.
// Thread `other` is the partner.
template <bool MIRROR, int NW, int ITEMS>
__device__ __forceinline__ void block_step(RegRows<NW, ITEMS>& r,
                                           long long* sh, int* sl, int other,
                                           bool keep_max) {
  const int n = blockDim.x;
  const int t = threadIdx.x;
  __syncthreads();  // the previous step's reads are done
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    sh[i * n + t] = r.h[i];
    if (NW == 2) sl[i * n + t] = r.l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int src = (MIRROR ? ITEMS - 1 - i : i) * n + other;
    keep(r, i, sh[src], NW == 2 ? sl[src] : 0, keep_max);
  }
}

// Sorts each run of min(top, T) elements of the CTA's rows ascending on
// (*words, payload); top a power of two >= 2 (T for K1, K6's run length).
// Every thread of the block calls it; sh/sl must hold blockDim.x * ITEMS
// entries when top > 32 * ITEMS, and are not touched otherwise.  Returns
// without a final barrier.
template <int NW, int ITEMS>
__device__ __forceinline__ void bitonic_sort_regs(RegRows<NW, ITEMS>& r,
                                                  long long* sh, int* sl,
                                                  int top) {
  thread_sort<NW, ITEMS>(r, top);
  const int t = threadIdx.x;
  const int e = t * ITEMS;
  const unsigned mask =
      blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1u;
  for (int size = 2 * ITEMS; size <= top; size <<= 1) {
    const int half = size >> 1;
    const int mirror = size / ITEMS - 1;  // partner thread offset (xor)
    if (half >= 32 * ITEMS) {
      block_step<true>(r, sh, sl, t ^ mirror, (e & half) != 0);
    } else {
      warp_step<true>(r, mirror, (e & half) != 0, mask);
    }
    for (int d = half >> 1; d >= ITEMS; d >>= 1) {
      if (d >= 32 * ITEMS) {
        block_step<false>(r, sh, sl, t ^ (d / ITEMS), (e & d) != 0);
      } else {
        warp_step<false>(r, d / ITEMS, (e & d) != 0, mask);
      }
    }
    thread_merge<NW, ITEMS, ITEMS / 2>(r);
  }
}

}  // namespace repro
