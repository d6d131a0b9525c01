// K1: row-wise bitonic (key words, payload) sort of (m, T) tiles, with the
// optional fused sample epilogue.
//
// Replaces the TPU kernel src/repro/kernels/bitonic.py:tile_sort_call
// (_block_kernel + bitonic_network_rows), launched by sort_tiles_kv and
// sort_tiles_sample_kv.
//
// Layout: one CTA of `threads` threads sorts rows_per_cta consecutive rows
// of T elements (rows_per_cta > 1 only when T < 2048, so that a CTA still
// holds about 2048 elements), ITEMS = rows_per_cta * T / threads
// consecutive elements a thread, in registers from the load to the store.
// The launch geometry is bitonic.py:row_sort_geometry, passed in.  An
// element is a packed key (packed_key.cuh): pack2(word, payload) with one
// key word, pack2(w0, w1) and the payload with two, so a compare is one or
// two integer compares.  The network (bitonic_network.cuh,
// bitonic_sort_regs) runs strides below ITEMS inside the thread, strides
// below 32 * ITEMS by warp shuffles, and only the larger strides through
// shared memory (E packed keys, item-major), one barrier pair each: at
// T = 4096 with 256 threads of 16 items, 42 steps in registers, 30 by
// shuffles and 6 through shared memory, where a row of T <= 512 needs no
// barrier at all.  Rows are read and written once with 16-byte accesses
// (tile_rows.cuh, load_regs / store_regs), and sample j of a row, sorted
// element (j + 1) * T / s - 1, is stored by the thread that holds it.
//
// Bound on the H100: every element is read once and written once, so the
// bytes bound is 2 * (nw + 1) * 4 * m * T over 3.35 TB/s (0.323 ms at
// 16,384 x 4096 with one word); the network's log2(T) * (log2(T) + 1) / 2
// steps of compare-exchanges on packed keys make it bound by instruction
// issue (compares, selects and shuffles) well above that.
//
// Payloads are unique within a row in the pipeline, and elements equal on
// (words, payload) are identical, so the result is bit-identical to any
// correct sort on that order.

#include <cuda_runtime.h>

#include "bitonic_network.cuh"
#include "tile_rows.cuh"

namespace {

constexpr int MAX_THREADS = 512;

template <int NW, int ITEMS>
__global__ void __launch_bounds__(MAX_THREADS)
    tile_sort_kernel(const int* __restrict__ k0, const int* __restrict__ k1,
                     const int* __restrict__ v, int* __restrict__ ok0,
                     int* __restrict__ ok1, int* __restrict__ ov,
                     int* __restrict__ sk0, int* __restrict__ sk1,
                     int* __restrict__ sv, int T, int num_samples, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = blockDim.x * ITEMS;
  long long* sh = reinterpret_cast<long long*>(smem);
  int* sl = reinterpret_cast<int*>(sh + E);  // used only when NW == 2
  const long long off = (long long)blockIdx.x * E + threadIdx.x * ITEMS;

  repro::RegRows<NW, ITEMS> r;
  repro::load_regs(r, k0, k1, v, off, vec);
  repro::bitonic_sort_regs(r, sh, sl, T);
  repro::store_regs(r, ok0, ok1, ov, sk0, sk1, sv, off, T, num_samples, vec);
}

struct Args {
  const int *k0, *k1, *v;
  int *ok0, *ok1, *ov, *sk0, *sk1, *sv;
  long long m;
  int T, rows_per_cta, num_samples, threads, smem;
  cudaStream_t stream;
};

template <int NW, int ITEMS>
cudaError_t launch_items(const Args& a) {
  cudaError_t err = repro::allow_shared(tile_sort_kernel<NW, ITEMS>, a.smem);
  if (err != cudaSuccess) return err;
  const bool vec = repro::aligned16(
      {a.k0, a.k1, a.v, a.ok0, a.ok1, a.ov});
  tile_sort_kernel<NW, ITEMS>
      <<<(unsigned)(a.m / a.rows_per_cta), a.threads, a.smem, a.stream>>>(
          a.k0, a.k1, a.v, a.ok0, a.ok1, a.ov, a.sk0, a.sk1, a.sv, a.T,
          a.num_samples, vec);
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
// two) with the geometry of bitonic.py:row_sort_geometry: `threads`
// threads of `items` elements each (threads * items == rows_per_cta * T,
// threads <= 512, items in {2, 4, 8, 16, 32}) and `smem` bytes of dynamic
// shared memory.  k1/ok1/sk1 are ignored when nw == 1; sk0/sk1/sv when
// num_samples == 0.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a geometry the kernel does not take.
int repro_tile_sort(int nw, const void* k0, const void* k1, const void* v,
                    void* ok0, void* ok1, void* ov, void* sk0, void* sk1,
                    void* sv, long long m, int T, int rows_per_cta,
                    int num_samples, int threads, int items, int smem,
                    void* stream) {
  if (threads < 1 || threads > MAX_THREADS ||
      (long long)threads * items != (long long)T * rows_per_cta) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{(const int*)k0, (const int*)k1, (const int*)v, (int*)ok0,
               (int*)ok1,      (int*)ov,       (int*)sk0,      (int*)sk1,
               (int*)sv,       m,              T,              rows_per_cta,
               num_samples,    threads,        smem,           (cudaStream_t)stream};
  return (int)(nw == 1 ? launch<1>(a, items) : launch<2>(a, items));
}

}  // extern "C"
