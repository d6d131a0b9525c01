// K4: row-wise top-k of (R, C) descending-codec key words (the MoE router's
// and ops.topk's kernel): each row is sorted ascending on (*words, column)
// and its first k words and column indices are written out.
//
// Replaces the TPU kernel src/repro/kernels/topk.py:topk_desc
// (_topk_kernel + bitonic_network_rows).  Keys arrive in the descending
// codec, so ascending canonical order is descending score order, and the
// column payload breaks ties toward the smaller index (jax.lax.top_k's
// order).
//
// Layout: K1's (tile_sort.cu).  A CTA of `threads` threads sorts
// rows_per_cta rows of C elements (about 2048 elements, no more rows than
// R needs), ITEMS consecutive elements a thread, in registers; the launch
// geometry is topk.py:topk_geometry, passed in.  An element is a packed key
// (packed_key.cuh): pack2(word, column) with one key word, pack2(w0, w1)
// and the column with two.  The words are read with 16-byte loads; the
// column is the element's index modulo C, made in registers and never
// read.  K1's register network (bitonic_network.cuh, bitonic_sort_regs)
// sorts every row: a router row of 64 or 128 experts lies in one warp
// (8 threads of 16 items at C = 128), so it takes no barrier and no shared
// memory; rows wider than 32 * ITEMS take K1's shared exchange.  Only the
// first k of each row are stored, by the threads that hold them.  Rows
// past R in the CTA sort pad words and are not written.
//
// Bound on the H100: the bytes are nw * 4 * R * C in and (nw + 1) * 4 * R * k
// out; the operations at least C - 1 compares per row.  At (65536, 128)
// with one word that is 0.0113 ms of bytes.  The network's 28 steps at
// C = 128 (log2 C * (log2 C + 1) / 2) are compares of packed keys in
// registers and shuffles: it is bound by integer issue, about 100
// instructions an element.

#include <climits>

#include <cuda_runtime.h>

#include "bitonic_network.cuh"
#include "tile_rows.cuh"

namespace {

constexpr int MAX_THREADS = 512;

template <int NW, int ITEMS>
__global__ void __launch_bounds__(MAX_THREADS)
    topk_kernel(const int* __restrict__ k0, const int* __restrict__ k1,
                int* __restrict__ ok0, int* __restrict__ ok1,
                int* __restrict__ oi, long long R, int C, int k, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = blockDim.x * ITEMS;
  long long* sh = reinterpret_cast<long long*>(smem);
  int* sl = reinterpret_cast<int*>(sh + E);  // used only when NW == 2
  const long long first =
      (long long)blockIdx.x * E + (long long)threadIdx.x * ITEMS;
  const long long avail = R * C;

  int w0[ITEMS], w1[ITEMS];
  if (first + ITEMS <= avail) {
    repro::load_ints(w0, k0 + first, vec);
    if (NW == 2) repro::load_ints(w1, k1 + first, vec);
  } else {  // rows past R (or, when ITEMS > C, some of them)
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const bool ok = first + i < avail;
      w0[i] = ok ? k0[first + i] : INT_MAX;
      if (NW == 2) w1[i] = ok ? k1[first + i] : INT_MAX;
    }
  }
  repro::RegRows<NW, ITEMS> r;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int col = (int)((first + i) & (C - 1));
    r.h[i] = repro::pack2(w0[i], NW == 2 ? w1[i] : col);
    if (NW == 2) r.l[i] = col;
  }

  repro::bitonic_sort_regs(r, sh, sl, C);

  const int log_c = __ffs(C) - 1;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long e = first + i;
    const int pos = (int)(e & (C - 1));
    if (pos < k && e < avail) {
      const long long q = (e >> log_c) * k + pos;
      const int low = (int)(unsigned)r.h[i] ^ (int)0x80000000;
      ok0[q] = (int)(r.h[i] >> 32);
      if (NW == 2) ok1[q] = low;
      oi[q] = NW == 2 ? r.l[i] : low;
    }
  }
}

struct Args {
  const int *k0, *k1;
  int *ok0, *ok1, *oi;
  long long R;
  int C, rows_per_cta, k, threads, smem;
  cudaStream_t stream;
};

template <int NW, int ITEMS>
cudaError_t launch_items(const Args& a) {
  cudaError_t err = repro::allow_shared(topk_kernel<NW, ITEMS>, a.smem);
  if (err != cudaSuccess) return err;
  const bool vec = repro::aligned16({a.k0, a.k1});
  const long long blocks = (a.R + a.rows_per_cta - 1) / a.rows_per_cta;
  topk_kernel<NW, ITEMS><<<(unsigned)blocks, a.threads, a.smem, a.stream>>>(
      a.k0, a.k1, a.ok0, a.ok1, a.oi, a.R, a.C, a.k, vec);
  return cudaGetLastError();
}

template <int NW>
cudaError_t launch(const Args& a, int items) {
  switch (items) {
    case 1: return launch_items<NW, 1>(a);  // one row of one column
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

// R rows of C key words (C a power of two <= 16384), 1 <= k <= C, with the
// geometry of topk.py:topk_geometry: rows_per_cta rows a CTA, `threads`
// threads of `items` elements each (threads * items == rows_per_cta * C,
// threads <= 512, items in {1, 2, 4, 8, 16, 32}) and `smem` bytes of
// dynamic shared memory.  k1/ok1 are ignored when nw == 1.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry the kernel
// does not take.
int repro_topk(int nw, const void* k0, const void* k1, void* ok0, void* ok1,
               void* oi, long long R, int C, int rows_per_cta, int k,
               int threads, int items, int smem, void* stream) {
  if (threads < 1 || threads > MAX_THREADS ||
      (long long)threads * items != (long long)C * rows_per_cta) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{(const int*)k0, (const int*)k1, (int*)ok0, (int*)ok1,
               (int*)oi,       R,              C,          rows_per_cta,
               k,              threads,        smem,       (cudaStream_t)stream};
  return (int)(nw == 1 ? launch<1>(a, items) : launch<2>(a, items));
}

}  // extern "C"
