// Inclusive prefix sum along axis 0 for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/segsum.py:cumsum_blocked (body
// _cumsum_kernel): out[i, c] = sum_{j <= i} x[j, c], float32 accumulation
// and output, for float32/float16/bfloat16 x of shape [M, D].
//
// The TPU walks its grid in order and carries the running sum from block to
// block in VMEM.  Blocks of a CUDA grid run in no order, so the carry becomes
// three passes (reduce, then scan of the block totals, then scan):
//   1. cumsum_totals: block (b, c) sums rows [b*R, (b+1)*R) of column c;
//   2. cumsum_carry:  one block per column turns the totals into their
//                     inclusive prefix (in place);
//   3. cumsum_scan:   block (b, c) scans its rows again, starting from the
//                     prefix of the blocks before it, and writes out.
// R = 256 threads x 16 steps = 4096 rows.  Each step scans 256 consecutive
// rows with warp shuffles and a scan of the 8 warp totals, so the loads and
// stores of a column with D = 1 coalesce.
//
// Bound on this card: bytes.  The least traffic is M*D*sizeof(x) read and
// M*D*4 written; this design reads x twice (passes 1 and 3) plus the small
// totals array, so it can reach at best about 2/3 of the byte bound for
// float32 input.  The arithmetic (one add per element and a log-depth
// scan) is far below the card's rate.
//
// Rounding: the longest chain of float32 roundings that feeds one output is
// at most 2*16 (the per-thread steps of passes 1 and 3) + 3*9 (three block
// scans) + ceil(M / 2^20) (the running carry of pass 2 over chunks of 256
// totals) + 2, so |out - exact| <= depth * 2^-24 * sum_{j<=i} |x[j, c]| to
// first order.
#include <cuda_runtime.h>

#include <climits>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 16;
constexpr int kRows = kThreads * kSteps;  // rows per block in passes 1 and 3

// Inclusive scan of one value per thread over the block; *total gets the
// block's sum.  All threads of the block must call it.
__device__ float block_scan(float x, float* total) {
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      float y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += warp_sums[warp - 1];
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return x;
}

template <typename T>
__global__ void cumsum_totals(const T* __restrict__ x, float* __restrict__ totals,
                              long long m, int d, long long nb) {
  const long long b = blockIdx.x;
  const int c = blockIdx.y;
  float sum = 0.0f;
#pragma unroll 4
  for (int j = 0; j < kSteps; ++j) {
    long long row = b * kRows + j * kThreads + threadIdx.x;
    if (row < m) sum += to_f32(x[row * d + c]);
  }
  float total;
  block_scan(sum, &total);
  if (threadIdx.x == 0) totals[c * nb + b] = total;
}

__global__ void cumsum_carry(float* __restrict__ totals, long long nb) {
  float* t = totals + blockIdx.x * nb;
  float carry = 0.0f;
  for (long long base = 0; base < nb; base += kThreads) {
    long long i = base + threadIdx.x;
    float x = i < nb ? t[i] : 0.0f;
    float total;
    float inc = block_scan(x, &total);
    if (i < nb) t[i] = carry + inc;
    carry += total;
  }
}

template <typename T>
__global__ void cumsum_scan(const T* __restrict__ x, const float* __restrict__ totals,
                            float* __restrict__ out, long long m, int d,
                            long long nb) {
  const long long b = blockIdx.x;
  const int c = blockIdx.y;
  float carry = b > 0 ? totals[c * nb + b - 1] : 0.0f;
  for (int j = 0; j < kSteps; ++j) {
    long long row = b * kRows + j * kThreads + threadIdx.x;
    if (b * kRows + j * kThreads >= m) break;  // uniform across the block
    float v = row < m ? to_f32(x[row * d + c]) : 0.0f;
    float total;
    float inc = block_scan(v, &total);
    if (row < m) out[row * d + c] = carry + inc;
    carry += total;
  }
}

template <typename T>
int launch(const void* x, void* out, void* totals, long long m, int d,
           cudaStream_t s) {
  long long nb = (m + kRows - 1) / kRows;
  dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(d));
  float* t = static_cast<float*>(totals);
  cumsum_totals<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), t, m, d, nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cumsum_carry<<<static_cast<unsigned>(d), kThreads, 0, s>>>(t, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cumsum_scan<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), t,
                                           static_cast<float*>(out), m, d, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows per block: the wrapper allocates ceil(m / rows) * d floats of totals.
extern "C" int cumsum_block_rows() { return kRows; }

// x: [m, d] of type `dtype` (FloatCode), row-major; out: float32 [m, d];
// totals: float32 scratch of ceil(m / cumsum_block_rows()) * d.  Returns 0
// or a cudaError_t code.  Launches on `stream`; does not synchronise or
// allocate.
extern "C" int cumsum_f32(const void* x, void* out, void* totals, long long m,
                          int d, int dtype, void* stream) {
  if (m == 0 || d == 0) return 0;
  if (d < 0 || d > 65535 || (m + kRows - 1) / kRows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLOAT_DISPATCH(dtype, T, return launch<T>(x, out, totals, m, d, s));
  return 0;
}
