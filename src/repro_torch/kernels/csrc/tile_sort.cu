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
// about 2048 elements).  Key words are the port's biased int32 words, so the
// lexicographic order on (*words, payload) is plain signed int32 order word
// by word.  The network is the reference's, in bitonic_network.cuh (shared
// with K4, topk.cu).
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

namespace {

template <int NW, bool SAMPLE>
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

  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    s0[i] = k0[base + i];
    if (NW == 2) s1[i] = k1[base + i];
    sval[i] = v[base + i];
  }
  __syncthreads();

  repro::bitonic_sort_rows<NW>(s0, s1, sval, E, T);

  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    ok0[base + i] = s0[i];
    if (NW == 2) ok1[base + i] = s1[i];
    ov[base + i] = sval[i];
  }
  if (SAMPLE) {
    // Sample j of a sorted row is its element (j + 1) * T / s - 1.
    const int chunk = T / num_samples;
    const int ns = rows_per_cta * num_samples;
    const long long sbase = (long long)blockIdx.x * ns;
    for (int q = threadIdx.x; q < ns; q += blockDim.x) {
      const int src = (q / num_samples) * T + (q % num_samples + 1) * chunk - 1;
      sk0[sbase + q] = s0[src];
      if (NW == 2) sk1[sbase + q] = s1[src];
      sv[sbase + q] = sval[src];
    }
  }
}

template <int NW, bool SAMPLE>
cudaError_t launch(const int* k0, const int* k1, const int* v, int* ok0,
                   int* ok1, int* ov, int* sk0, int* sk1, int* sv,
                   long long m, int T, int rows_per_cta, int num_samples,
                   cudaStream_t stream) {
  const int E = T * rows_per_cta;
  const size_t smem = (size_t)(NW + 1) * E * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort_kernel<NW, SAMPLE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = E / 2 < 1024 ? E / 2 : 1024;
  const long long blocks = m / rows_per_cta;
  tile_sort_kernel<NW, SAMPLE><<<(unsigned)blocks, threads, smem, stream>>>(
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
  const int* a = (const int*)k0;
  const int* b = (const int*)k1;
  const int* c = (const int*)v;
  int* o0 = (int*)ok0;
  int* o1 = (int*)ok1;
  int* ovv = (int*)ov;
  int* q0 = (int*)sk0;
  int* q1 = (int*)sk1;
  int* qv = (int*)sv;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (nw == 1) {
    err = num_samples
              ? launch<1, true>(a, b, c, o0, o1, ovv, q0, q1, qv, m, T,
                                rows_per_cta, num_samples, st)
              : launch<1, false>(a, b, c, o0, o1, ovv, q0, q1, qv, m, T,
                                 rows_per_cta, num_samples, st);
  } else {
    err = num_samples
              ? launch<2, true>(a, b, c, o0, o1, ovv, q0, q1, qv, m, T,
                                rows_per_cta, num_samples, st)
              : launch<2, false>(a, b, c, o0, o1, ovv, q0, q1, qv, m, T,
                                 rows_per_cta, num_samples, st);
  }
  return (int)err;
}

}  // extern "C"
