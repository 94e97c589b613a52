// Fixed-degree neighbour aggregation (bucketed SpMM) for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/spmm.py:bucket_spmm:
//   out[i, :] = sum_k w[i, k] * x[nbr[i, k], :]
// with nbr int32 [N, K], w float32 [N, K], x [Nx, D] (float32/float16/
// bfloat16, multiplied and summed in float32) and out [N, D] in x's type.
// A padding neighbour is any in-bounds index with w == 0: it is gathered
// and multiplied like any other, so a NaN or inf in its row of x shows in
// the output as it does in the plain version's einsum.  A neighbour outside
// [0, Nx) adds 0 (the TPU kernel's one-hot row is 0 there); it is skipped,
// never read.
//
// The TPU has no fast random gather from HBM, so its kernel keeps x resident
// in VMEM (Nx*D*4 <= 8 MiB) and gathers with a one-hot matmul.  The card
// gathers rows from device memory directly, so there is no envelope.  One
// warp an output row:
//   * the row's ids and weights come in with one coalesced load, lane j
//     holding neighbour j (in chunks of 32 for K > 32), and go to the other
//     lanes by shuffle, so no gather waits on the load of its id;
//   * lane l takes channels c0 + l + 32 u, u < 4, one element each (a warp's
//     load of a row is coalesced), a pass of the channel loop covering 128;
//   * a group of 8 neighbours' gathers is issued before the first
//     multiply-add of the group, so 8 round trips to L2 or HBM overlap;
//   * the neighbours are folded in order, k = 0, 1, ..., with fused
//     multiply-adds: the same bits on every launch.
// Wider loads (8 or 16 bytes a lane) and evict-first output stores were
// measured side by side on the card and did not win (PERF.md).
//
// Bound on this card: bytes, N*K*8 (nbr, w) + the rows of x that some
// neighbour names, each counted once, + N*D*sizeof(x) written; two flops a
// gathered element are far below the card's rate.  What makes that bound
// hard to reach: every neighbour is a gather, N*K*D*sizeof(x) bytes in all
// (2.1 GB for N = 262,144, K = 16, D = 128 in float32, against an x of
// 8 MB), and each of them passes through L2, whose bandwidth, not HBM's,
// then sets the pace.
#include <cuda_runtime.h>

#include <climits>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kGroup = 8;        // gathers a lane issues before its FMAs
constexpr int kLaneElems = 4;    // channels a lane a pass
constexpr int kPass = 32 * kLaneElems;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bucket_spmm_kernel(const int* __restrict__ nbr, const float* __restrict__ w,
                   const T* __restrict__ x, T* __restrict__ out, long long n,
                   long long nx, int k, int d) {
  const int lane = threadIdx.x & 31;
  const long long i =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;                   // the same for the whole warp
  const int* nb = nbr + i * k;
  const float* wi = w + i * k;
  T* o = out + i * d;
  for (int c0 = 0; c0 < d; c0 += kPass) {
    float acc[kLaneElems];
#pragma unroll
    for (int u = 0; u < kLaneElems; ++u) acc[u] = 0.0f;
    for (int k0 = 0; k0 < k; k0 += 32) {
      const int kc = min(32, k - k0);
      int my_id = -1;
      float my_w = 0.0f;
      if (lane < kc) {
        my_id = __ldg(nb + k0 + lane);
        my_w = __ldg(wi + k0 + lane);
      }
      for (int g0 = 0; g0 < kc; g0 += kGroup) {
        float buf[kGroup][kLaneElems];
        bool in[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int id = __shfl_sync(kFull, my_id, (g0 + g) & 31);
          in[g] = g0 + g < kc && id >= 0 && id < nx;   // the same for the warp
          const T* xr = x + static_cast<long long>(id) * d;
#pragma unroll
          for (int u = 0; u < kLaneElems; ++u) {
            const int c = c0 + lane + 32 * u;
            buf[g][u] = in[g] && c < d ? to_f32(xr[c]) : 0.0f;
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const float wg = __shfl_sync(kFull, my_w, (g0 + g) & 31);
          if (in[g]) {
#pragma unroll
            for (int u = 0; u < kLaneElems; ++u)
              acc[u] = fmaf(wg, buf[g][u], acc[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kLaneElems; ++u) {
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
