// Inclusive prefix sum along axis 0 for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/segsum.py:cumsum_blocked (body
// _cumsum_kernel): out[i, c] = sum_{j <= i} x[j, c], float32 output, for
// float32/float16/bfloat16 x of shape [M, D].
//
// The TPU walks its grid in order and carries the running sum from block to
// block in VMEM.  Blocks of a CUDA grid run in no order, so the carry is
// handed on by a decoupled look-back (Merrill & Garland), in one launch that
// reads x once and writes out once.  Each block takes its tile by atomic
// ticket, so every tile before it has started.  It scans its tile,
// publishes the tile's total (its aggregate), adds the aggregates of the
// tiles before it back to the nearest one that has published its inclusive
// prefix, publishes its own inclusive prefix, and writes its outputs.  No
// tile waits on anything but a tile's aggregate, which that tile publishes
// as soon as its loads are in.
//
// Two layouts of a tile:
//   * D in {1, 2, 4} (cumsum_rows): 8192 consecutive elements of the flat
//     row-major [M*D] array, so a tile holds whole rows.  The block copies
//     its tile into shared memory with cp.async, 16 bytes a copy, every copy
//     issued before the first wait, then sweeps it twice.  First sweep: each
//     warp's total of its 1024 elements (lane l reads vectors j * 32 + l,
//     each holding whole rows), which make the tile's aggregate; warp 0
//     looks back, 32 tiles a step, one a lane.  Second sweep: a lane scans
//     each channel within its vector, the warp scans the vector totals with
//     shuffles and carries each round's total into the next, and every
//     output is written as 16-byte vectors.  The data wait out the
//     look-back in shared memory, not in registers, so an SM holds 6 tiles
//     of float32 (nearly all its shared memory) and keeps their loads in
//     flight: a tile can finish only once every tile before it has loaded,
//     so most resident blocks are waiting at any time.
//   * any other D (cumsum_cols): 128 rows by 32 columns, lane l on column
//     l (coalesced across lanes), warp w on 16 consecutive rows; one
//     look-back chain for each column, walked a tile at a time.  Correct
//     and coalesced, not tuned.
//
// Status (scratch, zeroed by the wrapper on the stream): the ticket, then
// for each tile and channel one 64-bit word, read and written whole with
// relaxed loads and stores: the float64 aggregate or inclusive prefix,
// whose two lowest mantissa bits are replaced by the flag (0 nothing yet,
// 1 aggregate, 2 inclusive prefix).  So a look-back step is one round trip
// to L2 and needs no fence: a value and its flag never come apart.
//
// Bound on this card: bytes, M*D*sizeof(x) read once and M*D*4 written
// once.  The arithmetic (a few adds and shuffles an element) and the
// look-back (a few status words a tile) are far below the card's rates.
//
// Rounding.  The sums across warps and tiles, and the carry, are float64;
// each output is rounded to float32 once, from the float64 carry plus warp
// prefix plus the element's float32 prefix within its warp.  In the rows
// layout that float32 prefix passes at most 7 adds within a vector (8
// 16-bit rows of one channel; 3 for float32), 5 of the warp scan, a chain
// of at most 7 round totals (3 for 16-bit inputs), 1 add making the
// round's offset and 1 adding it: with the final rounding, at most 18
// float32 roundings, whatever M; a warp total passes at most 15.  In the
// column layout a term passes at most 15 adds, and the final rounding.  A
// term meets at most one float64 add, and one cut of the two flag bits
// (relative 2^-51), a tile on its way: under one float32 rounding in all
// for fewer than 2^26 tiles.  So |out - exact| <= 19 * 2^-24 *
// sum_{j<=i} |x[j, c]| to first order; the tests hold it to the looser
// 64 + ceil(M / 2^20) of the earlier three-pass design.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileElems = 8192;                 // elements a tile (rows)
constexpr unsigned kMaxSleepNs = 512;            // longest pause between polls
constexpr int kGroupRows = 16;                   // rows a warp (cols)
constexpr int kTileRows = kWarps * kGroupRows;   // rows a tile (cols)
constexpr int kCols = 32;                        // columns a tile (cols)
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kFlags = 3;         // a status word's low bits
constexpr unsigned long long kAggregate = 1;
constexpr unsigned long long kPrefix = 2;

__host__ __device__ constexpr long long div_up(long long a, long long b) {
  return (a + b - 1) / b;
}

__host__ __device__ constexpr bool rows_layout(int d) {
  return d == 1 || d == 2 || d == 4;
}

__host__ __device__ constexpr long long tiles_of(long long m, int d) {
  return rows_layout(d) ? div_up(m * d, kTileElems)
                        : div_up(m, kTileRows) * div_up(d, kCols);
}

// status words of a tile: one a channel
__host__ __device__ constexpr int width_of(int d) {
  return rows_layout(d) ? d : kCols;
}

// A status word: the float64 value with its two lowest mantissa bits
// replaced by the flag (never 0 once written), read and written whole.
__device__ __forceinline__ unsigned long long status_word(double v,
                                                          unsigned long long flag) {
  return (static_cast<unsigned long long>(__double_as_longlong(v)) & ~kFlags) | flag;
}

__device__ __forceinline__ double status_value(unsigned long long w) {
  return __longlong_as_double(static_cast<long long>(w & ~kFlags));
}

__device__ __forceinline__ unsigned long long ld_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// w, loaded from p, once the tile of p (which has started) has published.
// Polls back off, so that warps waiting on the newest tiles' words do not
// crowd the L2 slice that holds them.
__device__ __forceinline__ unsigned long long wait_word(const unsigned long long* p,
                                                       unsigned long long w) {
  unsigned ns = 32;
  for (int spins = 0; (w & kFlags) == 0; ++spins) {
    if (spins > (1 << 22)) __trap();   // never: the tile's block runs
    __nanosleep(ns);
    ns = min(2 * ns, kMaxSleepNs);
    w = ld_word(p);
  }
  return w;
}

// 16 bytes from global to shared memory, not through registers.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

// The VE elements of a 16-byte vector in shared memory, as float32.
template <typename T, int VE>
__device__ __forceinline__ void smem_vec(const T* p, float (&f)[VE]) {
  static_assert(VE * sizeof(T) == 16, "a 16-byte vector");
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) unpack_word<T>(w[q], f + q * (4 / static_cast<int>(sizeof(T))));
}

// The rows layout: kTileElems consecutive elements a tile, D channels (see
// the note at the top).  n = M * D; word[t * D + c]: tile t's status,
// channel c.
template <typename T, int D, bool kAligned>
__global__ void __launch_bounds__(kThreads)
cumsum_rows(const T* __restrict__ x, float* __restrict__ out,
            unsigned long long* __restrict__ scratch, long long n) {
  constexpr int VE = 16 / static_cast<int>(sizeof(T));  // elements a vector
  constexpr int kWarpElems = kTileElems / kWarps;       // elements a warp
  constexpr int NV = kWarpElems / (32 * VE);            // vectors a lane
  static_assert(VE % D == 0, "a vector holds whole rows");
  __shared__ __align__(16) T s_x[kTileElems];
  __shared__ float s_warp[kWarps][D];
  __shared__ double s_carry[D];
  __shared__ unsigned long long s_tile;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long* const word = scratch + 1;
  if (threadIdx.x == 0) s_tile = atomicAdd(scratch, 1ull);
  __syncthreads();
  const long long tile = static_cast<long long>(s_tile);
  const long long t0 = tile * kTileElems;
  const int len = static_cast<int>(min(static_cast<long long>(kTileElems), n - t0));

  // the tile into shared memory, every copy issued before the first wait
  if (kAligned && len == kTileElems) {
#pragma unroll
    for (int i = 0; i < kTileElems / VE / kThreads; ++i) {
      const int q = (threadIdx.x + i * kThreads) * VE;
      cp_async16(s_x + q, x + t0 + q);
    }
    cp_async_wait_all();
  } else {
    for (int i = threadIdx.x; i < kTileElems; i += kThreads)
      s_x[i] = i < len ? x[t0 + i] : from_f32<T>(0.0f);
  }
  __syncthreads();

  // lane l of warp w reads vectors j * 32 + l of the warp's elements
  const T* const xw = s_x + warp * kWarpElems + lane * VE;

  // first sweep: the warps' totals
  float sum[D];
#pragma unroll
  for (int c = 0; c < D; ++c) sum[c] = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float f[VE];
    smem_vec<T, VE>(xw + j * 32 * VE, f);
#pragma unroll
    for (int h = VE / 2; h >= D; h >>= 1)
#pragma unroll
      for (int e = 0; e < h; ++e) f[e] += f[e + h];
#pragma unroll
    for (int c = 0; c < D; ++c) sum[c] += f[c];
  }
#pragma unroll
  for (int c = 0; c < D; ++c) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum[c] += __shfl_xor_sync(kFull, sum[c], o);
    if (lane == 0) s_warp[warp][c] = sum[c];
  }
  __syncthreads();
  double pre[D], total[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    pre[c] = 0.0;
    total[c] = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const double t = s_warp[w][c];
      if (w < warp) pre[c] += t;
      total[c] += t;
    }
  }

  // the look-back: lane l looks at tile top - l, all 32 loads issued
  // together; each channel stops at its nearest inclusive prefix
  if (warp == 0) {
    double carry[D];
#pragma unroll
    for (int c = 0; c < D; ++c) carry[c] = 0.0;
    if (tile > 0) {
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < D; ++c)
          st_word(word + tile * D + c, status_word(total[c], kAggregate));
      }
      unsigned open = (1u << D) - 1;   // channels still looking back
      for (long long top = tile - 1; open; top -= 32) {
        const long long p = top - lane;
        unsigned long long w[D];
#pragma unroll
        for (int c = 0; c < D; ++c)      // before tile 0: a prefix of 0
          w[c] = p >= 0 ? ld_word(word + p * D + c) : kPrefix;
#pragma unroll
        for (int c = 0; c < D; ++c)
          if (p >= 0) w[c] = wait_word(word + p * D + c, w[c]);
#pragma unroll
        for (int c = 0; c < D; ++c) {
          if (!(open >> c & 1)) continue;   // the same for the whole warp
          const unsigned prefixes = __ballot_sync(kFull, (w[c] & kFlags) == kPrefix);
          const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
          double v = lane <= stop ? status_value(w[c]) : 0.0;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
          carry[c] += v;
          if (prefixes) open &= ~(1u << c);
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        st_word(word + tile * D + c, status_word(carry[c] + total[c], kPrefix));
        s_carry[c] = carry[c];
      }
    }
  }
  __syncthreads();

  // second sweep: each element's prefix within its warp, in float32, then
  // the float64 carry and warp prefix, rounded once
  double base[D];
  float run[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    base[c] = s_carry[c] + pre[c];
    run[c] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float v[VE];
    smem_vec<T, VE>(xw + j * 32 * VE, v);
#pragma unroll
    for (int e = D; e < VE; ++e) v[e] += v[e - D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float inc = v[VE - D + c];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += y;
      }
      const float excl = __shfl_up_sync(kFull, inc, 1);
      const float off = lane ? run[c] + excl : run[c];
#pragma unroll
      for (int e = c; e < VE; e += D) v[e] += off;
      run[c] += __shfl_sync(kFull, inc, 31);
    }
    float o[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e)
      o[e] = __double2float_rn(base[e % D] + static_cast<double>(v[e]));
    const long long p = t0 + warp * kWarpElems + (j * 32 + lane) * VE;
    if (p + VE <= n) {                 // out is 16-byte aligned, p a multiple of 4
#pragma unroll
      for (int q = 0; q < VE; q += 4)
        *reinterpret_cast<float4*>(out + p + q) =
            make_float4(o[q], o[q + 1], o[q + 2], o[q + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e)
        if (p + e < n) out[p + e] = o[e];
    }
  }
}

// The column layout: 128 rows by 32 columns a tile, for any D.  Tickets go
// row tile by row tile, each over its `chunks` column chunks, so the tile
// above a tile (ticket t - chunks) has started.  word[t * 32 + l]: tile
// t's status, its column l.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cumsum_cols(const T* __restrict__ x, float* __restrict__ out,
            unsigned long long* __restrict__ scratch, long long m, int d,
            int chunks) {
  __shared__ float s_grp[kWarps][kCols];
  __shared__ double s_carry[kCols];
  __shared__ unsigned long long s_tile;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long* const word = scratch + 1;
  if (threadIdx.x == 0) s_tile = atomicAdd(scratch, 1ull);
  __syncthreads();
  const long long t = static_cast<long long>(s_tile);
  const long long row_tile = t / chunks;
  const int c = static_cast<int>(t % chunks) * kCols + lane;
  const bool active = c < d;
  const long long r0 = row_tile * kTileRows + warp * kGroupRows;

  float v[kGroupRows];
#pragma unroll
  for (int i = 0; i < kGroupRows; ++i)
    v[i] = active && r0 + i < m ? to_f32(x[(r0 + i) * d + c]) : 0.0f;
#pragma unroll
  for (int i = 1; i < kGroupRows; ++i) v[i] += v[i - 1];
  s_grp[warp][lane] = v[kGroupRows - 1];
  __syncthreads();
  double pre = 0.0, total = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const double g = s_grp[w][lane];
    if (w < warp) pre += g;
    total += g;
  }

  if (warp == 0) {
    double carry = 0.0;
    if (row_tile > 0) {
      st_word(word + t * kCols + lane, status_word(total, kAggregate));
      for (long long j = t - chunks;; j -= chunks) {
        const unsigned long long* p = word + j * kCols + lane;
        const unsigned long long w = wait_word(p, ld_word(p));
        carry += status_value(w);
        if ((w & kFlags) == kPrefix) break;
      }
    }
    st_word(word + t * kCols + lane, status_word(carry + total, kPrefix));
    s_carry[lane] = carry;
  }
  __syncthreads();

  const double base = s_carry[lane] + pre;
#pragma unroll
  for (int i = 0; i < kGroupRows; ++i)
    if (active && r0 + i < m)
      out[(r0 + i) * d + c] = __double2float_rn(base + static_cast<double>(v[i]));
}

// The most blocks an SM holds are those its shared memory fits (6 of 32 KB
// for float32): the carveout asks for all of it.  Setting it on every
// launch costs no host time that could be measured (PERF.md).
template <typename T, int D, bool kAligned>
void launch_rows_as(const T* x, float* out, unsigned long long* s, long long n,
                    long long tiles, cudaStream_t stream) {
  cudaFuncSetAttribute(cumsum_rows<T, D, kAligned>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  cumsum_rows<T, D, kAligned><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      x, out, s, n);
}

template <typename T, int D>
void launch_rows(const T* x, float* out, unsigned long long* s, long long n,
                 long long tiles, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0)
    launch_rows_as<T, D, true>(x, out, s, n, tiles, stream);
  else
    launch_rows_as<T, D, false>(x, out, s, n, tiles, stream);
}

template <typename T>
int launch(const void* xv, void* outv, void* scratch, long long m, int d,
           cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  float* out = static_cast<float*>(outv);
  auto* s = static_cast<unsigned long long*>(scratch);
  const long long tiles = tiles_of(m, d);
  switch (d) {
    case 1: launch_rows<T, 1>(x, out, s, m, tiles, stream); break;
    case 2: launch_rows<T, 2>(x, out, s, m * 2, tiles, stream); break;
    case 4: launch_rows<T, 4>(x, out, s, m * 4, tiles, stream); break;
    default:
      cumsum_cols<T><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
          x, out, s, m, d, static_cast<int>(div_up(d, kCols)));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of zeroed scratch that cumsum_f32 needs for x [m, d]: the ticket
// and a status word a tile and channel.
extern "C" long long cumsum_scratch_bytes(long long m, int d) {
  if (m <= 0 || d <= 0) return 0;
  return 8 * (1 + tiles_of(m, d) * width_of(d));
}

// x: [m, d] of type `dtype` (FloatCode), row-major; out: float32 [m, d];
// scratch: cumsum_scratch_bytes(m, d) bytes, all zero, used by this one
// launch.  Returns 0 or a cudaError_t code.  One launch on `stream`; does
// not synchronise or allocate.
extern "C" int cumsum_f32(const void* x, void* out, void* scratch, long long m,
                          int d, int dtype, void* stream) {
  if (m == 0 || d == 0) return 0;
  if (m < 0 || d < 0 || d > 65535 || m > LLONG_MAX / 65535 ||
      tiles_of(m, d) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLOAT_DISPATCH(dtype, T, return launch<T>(x, out, scratch, m, d, s));
  return 0;
}
