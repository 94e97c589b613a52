// Fixed-degree neighbour aggregation (bucketed SpMM) for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/spmm.py:bucket_spmm:
//   out[i, :] = sum_k w[i, k] * x[nbr[i, k], :]
// with nbr int32 [N, K], w float32 [N, K], x [Nx, D] (float32/float16/
// bfloat16, multiplied and summed in float32) and out [N, D] in x's type.
// A padding neighbour is any in-bounds index with w == 0: it adds 0.  A
// neighbour outside [0, Nx) adds 0 as well (the TPU kernel's one-hot row is
// 0 there); it is skipped, never read.
//
// The TPU has no fast random gather from HBM, so its kernel keeps x resident
// in VMEM (Nx*D*4 <= 8 MiB) and gathers with a one-hot matmul.  The card
// gathers rows from device memory directly, so there is no envelope: one
// warp per output row, its lanes over D, so that each gathered row of x is
// read with coalesced loads; the K neighbours are folded in order (k = 0,
// 1, ...) with fused multiply-adds.
//
// Bound on this card: bytes, N*K*8 (nbr, w) + N*K*D*sizeof(x) (the rows of
// x the neighbours gather; a row gathered twice is counted twice, since the
// reference gathers it twice too) read and N*D*sizeof(x) written; two
// flops per gathered element are far below the card's rate.
#include <cuda_runtime.h>

#include <climits>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bucket_spmm_kernel(const int* __restrict__ nbr, const float* __restrict__ w,
                   const T* __restrict__ x, T* __restrict__ out, long long n,
                   long long nx, int k, int d) {
  const int lane = threadIdx.x & 31;
  const long long i =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;
  const int* nb = nbr + i * k;
  const float* wi = w + i * k;
  T* o = out + i * d;
  for (int c0 = 0; c0 < d; c0 += 128) {
    // four channels per lane in flight: c0 + lane + 32*u
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int j = 0; j < k; ++j) {
      const long long id = __ldg(nb + j);
      if (id < 0 || id >= nx) continue;       // the same for the whole warp
      const float wj = __ldg(wi + j);
      const T* xr = x + id * d;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + lane + 32 * u;
        if (c < d) acc[u] = fmaf(wj, to_f32(xr[c]), acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + lane + 32 * u;
      if (c < d) o[c] = from_f32<T>(acc[u]);
    }
  }
}

}  // namespace

// nbr: int32 [n, k]; w: float32 [n, k]; x: [nx, d] and out: [n, d], both of
// type `dtype` (FloatCode).  A nbr outside [0, nx) adds 0.  Returns 0 or a
// cudaError_t code.  Launches on `stream`; does not synchronise or allocate.
extern "C" int bucket_spmm(const int* nbr, const float* w, const void* x,
                           void* out, long long n, long long nx, int k, int d,
                           int dtype, void* stream) {
  if (n == 0 || d == 0) return 0;
  const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (k < 0 || d < 0 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLOAT_DISPATCH(dtype, T, {
    bucket_spmm_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        nbr, w, static_cast<const T*>(x), static_cast<T*>(out), n, nx, k, d);
  });
  return static_cast<int>(cudaGetLastError());
}
