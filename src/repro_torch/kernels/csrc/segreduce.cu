// Sorted segment reduce for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/segsum.py:_segscan_kernel
// (behind segscan_blocked and the boundary gather of ops.segreduce_sorted):
//
//   out[s, c] = fold(op, values[i, c] for offsets[s] <= i < offsets[s+1])
//
// folded strictly in index order, starting from the identity of `op`
// (sum: 0; max: -inf / INT32_MIN; min: +inf / INT32_MAX), so an empty
// segment gets the identity.  The in-order fold is the load-bearing
// contract: a one-ulp difference in an f32 run sum flips a delta-modularity
// tie-break and with it the partition.
//
// Design: one thread per (segment, channel) walks its rows from start to
// end.  That is exact for every op and dtype, uses no atomics and no tree
// reduction.  Unlike the TPU kernel it writes [nseg, D] directly; the
// running scan is never materialised.  Bound on this card: bytes, at least
// M*D*4 + (nseg+1)*4 read and nseg*D*4 written (plus the M*4 bytes of ids
// the wrapper's offset search reads).  Neighbouring threads read
// neighbouring rows while runs are short (the common case), so loads
// coalesce; the weak spot is a hub segment, which one thread walks alone.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

enum Op { kSum = 0, kMax = 1, kMin = 2 };
enum DType { kFloat32 = 0, kInt32 = 1 };

template <typename T, int OP>
struct Fold;

template <typename T>
struct Fold<T, kSum> {
  __device__ static T identity() { return T(0); }
  __device__ static T apply(T acc, T v) { return acc + v; }
};

template <>
struct Fold<float, kMax> {
  __device__ static float identity() { return -INFINITY; }
  __device__ static float apply(float acc, float v) { return v > acc ? v : acc; }
};

template <>
struct Fold<float, kMin> {
  __device__ static float identity() { return INFINITY; }
  __device__ static float apply(float acc, float v) { return v < acc ? v : acc; }
};

template <>
struct Fold<int, kMax> {
  __device__ static int identity() { return INT_MIN; }
  __device__ static int apply(int acc, int v) { return max(acc, v); }
};

template <>
struct Fold<int, kMin> {
  __device__ static int identity() { return INT_MAX; }
  __device__ static int apply(int acc, int v) { return min(acc, v); }
};

template <typename T, int OP>
__global__ void segreduce_sorted_kernel(const T* __restrict__ values,
                                        const int* __restrict__ offsets,
                                        T* __restrict__ out, long long nseg,
                                        int d) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= nseg * d) return;
  long long s = t / d;
  int c = static_cast<int>(t - s * d);
  int begin = offsets[s];
  int end = offsets[s + 1];
  const T* p = values + static_cast<long long>(begin) * d + c;
  T acc = Fold<T, OP>::identity();
#pragma unroll 4
  for (int i = begin; i < end; ++i, p += d) {
    acc = Fold<T, OP>::apply(acc, __ldg(p));
  }
  out[t] = acc;
}

template <typename T, int OP>
void launch(const void* values, const int* offsets, void* out, long long nseg,
            int d, unsigned blocks, int threads, cudaStream_t stream) {
  segreduce_sorted_kernel<T, OP><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(values), offsets, static_cast<T*>(out), nseg, d);
}

}  // namespace

// Returns 0 on success, else a cudaError_t code (launch refused, or bad
// op/dtype).  Launches on `stream`; does not synchronise or allocate.
extern "C" int segreduce_sorted(const void* values, const int* offsets,
                                void* out, long long nseg, int d, int op,
                                int dtype, void* stream) {
  long long n = nseg * d;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > INT_MAX || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned b = static_cast<unsigned>(blocks);
  if (dtype == kFloat32) {
    if (op == kSum) launch<float, kSum>(values, offsets, out, nseg, d, b, threads, s);
    else if (op == kMax) launch<float, kMax>(values, offsets, out, nseg, d, b, threads, s);
    else if (op == kMin) launch<float, kMin>(values, offsets, out, nseg, d, b, threads, s);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else if (dtype == kInt32) {
    if (op == kSum) launch<int, kSum>(values, offsets, out, nseg, d, b, threads, s);
    else if (op == kMax) launch<int, kMax>(values, offsets, out, nseg, d, b, threads, s);
    else if (op == kMin) launch<int, kMin>(values, offsets, out, nseg, d, b, threads, s);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
