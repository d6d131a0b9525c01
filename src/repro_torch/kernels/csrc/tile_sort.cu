// K1: row-wise bitonic (key words, payload) sort of (m, T) tiles, with the
// optional fused sample epilogue.
//
// Replaces the TPU kernel src/repro/kernels/bitonic.py:tile_sort_call
// (_block_kernel + bitonic_network_rows), launched by sort_tiles_kv and
// sort_tiles_sample_kv.
//
// Layout: one CTA sorts rows_per_cta consecutive rows of T elements held in
// dynamic shared memory, one int32 array per key word plus one for the
// payload (rows_per_cta > 1 only when T is small, so that a CTA still holds
// about 2048 elements); the row load, store and sample epilogue are in
// tile_rows.cuh (shared with K5 and K6).  Key words are the port's biased
// int32 words, so the lexicographic order on (*words, payload) is plain
// signed int32 order word by word.  The network is the reference's, in
// bitonic_network.cuh (shared with K4, topk.cu, and K6).
//
// Bound on the H100: every element is read once and written once, so the
// bytes bound is 2 * (nw + 1) * 4 * m * T over 3.35 TB/s.  The network does
// log2(T) * (log2(T) + 1) / 2 compare-exchange steps of T/2 pairs per row,
// each a __syncthreads() apart, all in shared memory: this simple first
// version is bound by shared-memory traffic and barrier latency, not by
// device memory.  Its design keeps device traffic at the minimum (one
// coalesced load, one coalesced store, samples emitted from shared memory
// while the row is resident); register-resident small strides and warp
// shuffles are later work.
//
// Payloads are unique within a row, so the result is bit-identical to any
// correct stable sort.

#include <cuda_runtime.h>

#include "bitonic_network.cuh"
#include "tile_rows.cuh"

namespace {

template <int NW>
__global__ void tile_sort_kernel(const int* __restrict__ k0,
                                 const int* __restrict__ k1,
                                 const int* __restrict__ v,
                                 int* __restrict__ ok0, int* __restrict__ ok1,
                                 int* __restrict__ ov, int* __restrict__ sk0,
                                 int* __restrict__ sk1, int* __restrict__ sv,
                                 int T, int rows_per_cta, int num_samples) {
  extern __shared__ int smem[];
  const int E = T * rows_per_cta;
  int* s0 = smem;
  int* s1 = smem + E;  // used only when NW == 2
  int* sval = smem + NW * E;
  const long long base = (long long)blockIdx.x * E;

  repro::load_rows<NW>(s0, s1, sval, k0, k1, v, base, E);
  __syncthreads();
  repro::bitonic_sort_rows<NW>(s0, s1, sval, E, T);
  repro::store_rows<NW>(s0, s1, sval, ok0, ok1, ov, sk0, sk1, sv, base, E, T,
                        num_samples);
}

template <int NW>
cudaError_t launch(const int* k0, const int* k1, const int* v, int* ok0,
                   int* ok1, int* ov, int* sk0, int* sk1, int* sv,
                   long long m, int T, int rows_per_cta, int num_samples,
                   cudaStream_t stream) {
  const int E = T * rows_per_cta;
  const size_t smem = (size_t)(NW + 1) * E * sizeof(int);
  cudaError_t err = repro::allow_shared(tile_sort_kernel<NW>, smem);
  if (err != cudaSuccess) return err;
  const int threads = E / 2 < 1024 ? E / 2 : 1024;
  const long long blocks = m / rows_per_cta;
  tile_sort_kernel<NW><<<(unsigned)blocks, threads, smem, stream>>>(
      k0, k1, v, ok0, ok1, ov, sk0, sk1, sv, T, rows_per_cta, num_samples);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Sorts m rows of T elements (m a multiple of rows_per_cta, T a power of
// two, T * rows_per_cta >= 2).  k1/ok1/sk1 are ignored when nw == 1;
// sk0/sk1/sv when num_samples == 0.  Returns cudaGetLastError().
int repro_tile_sort(int nw, const void* k0, const void* k1, const void* v,
                    void* ok0, void* ok1, void* ov, void* sk0, void* sk1,
                    void* sv, long long m, int T, int rows_per_cta,
                    int num_samples, void* stream) {
  auto f = nw == 1 ? &launch<1> : &launch<2>;
  return (int)f((const int*)k0, (const int*)k1, (const int*)v, (int*)ok0,
                (int*)ok1, (int*)ov, (int*)sk0, (int*)sk1, (int*)sv, m, T,
                rows_per_cta, num_samples, (cudaStream_t)stream);
}

}  // extern "C"
