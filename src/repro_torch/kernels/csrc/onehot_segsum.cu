// Unsorted segment sum for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/onehot_segsum.py:onehot_segsum:
//   out[s, c] = sum over rows i with ids[i] == s of values[i, c]
// for values [N, D] (float32/float16/bfloat16, summed in float32) and
// int32 ids in [0, C); empty segments get 0, and a row whose id lies
// outside [0, C) adds nothing (its one-hot row is 0 on the TPU).  Like the TPU kernel it is
// deterministic: the same inputs give the same bits on every run.
//
// The TPU kernel forms onehot(ids) and accumulates onehot^T @ values on the
// matrix unit, with the whole [C, D] output resident in VMEM.  That costs
// N*C*D multiply-adds, hopeless at large C, and CUDA has no in-order grid.
// Here instead:
//   pass 1 (segsum_tiles): block (t, s) owns the segment tile
//     [t*T, (t+1)*T) and row slice s.  Each of its 8 warps owns a tile of
//     T*D floats in shared memory and a contiguous sub-slice of rows.  A
//     warp reads 32 ids at a time, finds with a ballot the lanes whose id
//     falls in the tile, and applies those rows one after another in lane
//     order (the warp's lanes spread over the D channels of the row).  So
//     each (segment, channel) of a warp's tile is a left fold of its rows
//     in index order, with no atomics.  The 8 warp tiles are then summed in
//     warp order into partial[s].
//   pass 2 (segsum_slices): out = sum of partial[0..S) in slice order.
// Every order is fixed by the launch shape, never by timing.
//
// Bound on this card: bytes, N*(D*sizeof(value) + 4) read and
// C*D*sizeof(value) written.  This first design reads the ids once per
// segment tile (ceil(C*D / 3072) times; they stay in L2 for the sizes of
// interest) and serialises the rows that fall in a tile within each warp,
// so it is far from that bound when C*D is large; the partials add
// S*C*D*4 bytes each way.
#include <cuda_runtime.h>

#include <climits>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileFloats = 3072;  // per warp: 8 warps x 12 KB = 96 KB a block

template <typename T>
__global__ void __launch_bounds__(kThreads)
segsum_tiles(const T* __restrict__ values, const int* __restrict__ ids,
             float* __restrict__ partial, long long n, long long nseg, int d,
             int tile_segments, long long rows_per_slice) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile_floats = tile_segments * d;
  float* tile = smem + warp * tile_floats;
  for (int e = lane; e < tile_floats; e += 32) tile[e] = 0.0f;
  __syncwarp();

  const long long lo = static_cast<long long>(blockIdx.x) * tile_segments;
  const long long slice_lo = blockIdx.y * rows_per_slice;
  const long long slice_hi = min(n, slice_lo + rows_per_slice);
  const long long per_warp = (rows_per_slice + kWarps - 1) / kWarps;
  const long long r_lo = slice_lo + warp * per_warp;
  const long long r_hi = min(slice_hi, r_lo + per_warp);

  for (long long base = r_lo; base < r_hi; base += 32) {
    const long long row = base + lane;
    const bool live = row < r_hi;
    const long long local = live ? static_cast<long long>(ids[row]) - lo : -1;
    const bool in_tile = live && local >= 0 && local < tile_segments;
    // channel 0 is loaded by the row's own lane, ahead of the serial walk
    const float v0 = in_tile ? to_f32(values[row * d]) : 0.0f;
    unsigned mask = __ballot_sync(0xffffffffu, in_tile);
    while (mask) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1;
      const int s = __shfl_sync(0xffffffffu, static_cast<int>(local), j);
      const float x0 = __shfl_sync(0xffffffffu, v0, j);
      float* dst = tile + static_cast<long long>(s) * d;
      if (lane == 0) dst[0] += x0;
      const T* src = values + (base + j) * d;
      for (int c = 1 + lane; c < d; c += 32) dst[c] += to_f32(src[c]);
    }
  }
  __syncthreads();

  const long long width = min(static_cast<long long>(tile_segments), nseg - lo) * d;
  float* out = partial + (blockIdx.y * nseg + lo) * d;
  for (long long e = threadIdx.x; e < width; e += kThreads) {
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += smem[w * tile_floats + e];
    out[e] = acc;
  }
}

template <typename T>
__global__ void segsum_slices(const float* __restrict__ partial, T* __restrict__ out,
                              long long total, int slices) {
  long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float acc = 0.0f;
  for (int s = 0; s < slices; ++s) acc += partial[s * total + e];
  out[e] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* values, const int* ids, void* partial, void* out,
           long long n, long long nseg, int d, int tile_segments, int slices,
           cudaStream_t st) {
  const long long tiles = (nseg + tile_segments - 1) / tile_segments;
  const long long rows_per_slice = (n + slices - 1) / slices;
  const size_t shmem = sizeof(float) * kWarps * tile_segments * d;
  cudaError_t err = cudaFuncSetAttribute(
      segsum_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(slices));
  float* p = static_cast<float*>(partial);
  segsum_tiles<T><<<grid, kThreads, shmem, st>>>(
      static_cast<const T*>(values), ids, p, n, nseg, d, tile_segments,
      rows_per_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = nseg * d;
  const long long blocks = (total + kThreads - 1) / kThreads;
  segsum_slices<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      p, static_cast<T*>(out), total, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of shared memory each warp's tile holds: tile_segments * d must
// not exceed it.
extern "C" int onehot_segsum_tile_floats() { return kTileFloats; }

// values: [n, d] and out: [nseg, d], both of type `dtype` (FloatCode);
// ids: int32 [n]; partial: float32 scratch [slices, nseg, d].  Ids outside
// [0, nseg) fall in no tile and are dropped.  Returns 0 or a cudaError_t
// code.  Launches on `stream`; does not synchronise or allocate.
extern "C" int onehot_segsum(const void* values, const int* ids, void* partial,
                             void* out, long long n, long long nseg, int d,
                             int tile_segments, int slices, int dtype,
                             void* stream) {
  if (nseg == 0 || d == 0) return 0;
  if (d < 1 || tile_segments < 1 || slices < 1 || slices > 65535 ||
      static_cast<long long>(tile_segments) * d > kTileFloats ||
      (nseg + tile_segments - 1) / tile_segments > INT_MAX ||
      (nseg * d + kThreads - 1) / kThreads > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLOAT_DISPATCH(dtype, T, {
    return launch<T>(values, ids, partial, out, n, nseg, d, tile_segments,
                     slices, st);
  });
  return 0;
}
