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
// Layout: as K1 (tile_sort.cu), with the same network (bitonic_network.cuh):
// one CTA sorts rows_per_cta rows of C elements in dynamic shared memory,
// rows_per_cta chosen by the wrapper so that a CTA holds about 2048
// elements (router rows are 16 to 128 experts wide).  The kernel writes
// the column iota itself, so the payload is never read from device
// memory, and the CTA's last rows past R are masked: they sort pad words
// and are not written.
//
// Bound on the H100: the bytes are nw * 4 * R * C in and (nw + 1) * 4 * R * k
// out; the operations at least C - 1 compares per row.  The network's
// log2(C) * (log2(C) + 1) / 2 shared-memory passes, a __syncthreads() apart,
// bound this simple version; selecting only k per row (a partial network or
// warp-level selection) is later work.

#include <climits>

#include <cuda_runtime.h>

#include "bitonic_network.cuh"

namespace {

template <int NW>
__global__ void topk_kernel(const int* __restrict__ k0,
                            const int* __restrict__ k1, int* __restrict__ ok0,
                            int* __restrict__ ok1, int* __restrict__ oi,
                            long long R, int C, int rows_per_cta, int k) {
  extern __shared__ int smem[];
  const int E = C * rows_per_cta;
  int* s0 = smem;
  int* s1 = smem + E;  // used only when NW == 2
  int* sval = smem + NW * E;
  const long long row0 = (long long)blockIdx.x * rows_per_cta;
  const long long base = row0 * C;
  const long long rows = R - row0 < rows_per_cta ? R - row0 : rows_per_cta;
  const long long avail = rows * C;

  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const bool ok = i < avail;
    s0[i] = ok ? k0[base + i] : INT_MAX;
    if (NW == 2) s1[i] = ok ? k1[base + i] : INT_MAX;
    sval[i] = i & (C - 1);
  }
  __syncthreads();

  repro::bitonic_sort_rows<NW>(s0, s1, sval, E, C);

  const long long obase = row0 * k;
  const int nk = (int)rows * k;
  for (int q = threadIdx.x; q < nk; q += blockDim.x) {
    const int src = (q / k) * C + q % k;
    ok0[obase + q] = s0[src];
    if (NW == 2) ok1[obase + q] = s1[src];
    oi[obase + q] = sval[src];
  }
}

template <int NW>
cudaError_t launch(const int* k0, const int* k1, int* ok0, int* ok1, int* oi,
                   long long R, int C, int rows_per_cta, int k,
                   cudaStream_t stream) {
  const int E = C * rows_per_cta;
  const size_t smem = (size_t)(NW + 1) * E * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int threads = E / 2 < 1024 ? E / 2 : 1024;
  if (threads < 32) threads = 32;
  const long long blocks = (R + rows_per_cta - 1) / rows_per_cta;
  topk_kernel<NW><<<(unsigned)blocks, threads, smem, stream>>>(
      k0, k1, ok0, ok1, oi, R, C, rows_per_cta, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// R rows of C key words (C a power of two, C * rows_per_cta <= 16384, so
// the (nw + 1) shared arrays fit 192 KB), 1 <= k <= C.  k1/ok1 are ignored
// when nw == 1.  Returns cudaGetLastError().
int repro_topk(int nw, const void* k0, const void* k1, void* ok0, void* ok1,
               void* oi, long long R, int C, int rows_per_cta, int k,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      nw == 1 ? launch<1>((const int*)k0, (const int*)k1, (int*)ok0,
                          (int*)ok1, (int*)oi, R, C, rows_per_cta, k, st)
              : launch<2>((const int*)k0, (const int*)k1, (int*)ok0,
                          (int*)ok1, (int*)oi, R, C, rows_per_cta, k, st);
  return (int)err;
}

}  // extern "C"
