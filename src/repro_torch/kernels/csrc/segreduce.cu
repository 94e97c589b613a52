// Sorted segment reduce for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/segsum.py:_segscan_kernel
// (behind segscan_blocked and the boundary gather of ops.segreduce_sorted):
//
//   out[s, c] = fold(op, values[i, c] for the rows i with ids[i] == s)
//
// over nondecreasing int32 ids; an empty segment gets the identity of `op`
// (sum: 0; max: -inf / INT32_MIN; min: +inf / INT32_MAX).  Two routes,
// chosen by (op, dtype) before launch:
//
// * f32 sum, in order (segreduce_inorder_kernel).  Float addition is not
//   associative, and a one-ulp difference in a run sum flips a
//   delta-modularity tie-break and with it the partition, so each segment
//   is folded strictly in index order: one thread per (segment, channel)
//   walks its rows between the offsets the wrapper finds.  A hub segment
//   is walked by one thread.
//
// * max and min over f32 and int32, sum over int32: order-free, tiled
//   (segreduce_prefill + segreduce_tiled).  The reference's f32 max/min are
//   IEEE maximum/minimum (jnp.maximum): -0 < +0 and a NaN absorbs.  Mapped
//   to the int32 key  b ^ ((b >> 31) & 0x7fffffff)  of the float bits b,
//   with every NaN sent to the key that wins (INT32_MAX for max, INT32_MIN
//   for min), they become integer max/min; with int32 sum, which wraps,
//   every one of these folds is commutative and associative bit for bit.
//   So any tree gives the reference's bits, and the work is cut by rows:
//
//   - segreduce_tiled: each block takes a fixed tile of kTile rows, reads
//     its values and ids once, all loads issued first (16 bytes a thread
//     where aligned), folds kItems consecutive rows a thread in registers,
//     then runs a segmented scan across the block (head flags ids[i] !=
//     ids[i-1], warp shuffles, one shared-memory pass over the warps'
//     totals).  The segments that start and end inside the tile, and the
//     empty ones between its ids, are one contiguous range of `out`: they
//     are staged in shared memory (identity first) and copied out
//     coalesced.  A segment that crosses a tile edge is combined into
//     `out` with an integer atomic (add, or max/min; on f32 bits the
//     max/min in key order is atomicMax/Min on the int bits for b >= 0 and
//     atomicMin/Max on the unsigned bits for b < 0).  These atomics are
//     exact and order-free, so the result is deterministic and
//     bit-identical to any in-order fold.  No float arithmetic is done at
//     all.  Work per block is fixed whatever the skew: a hub of R rows is
//     split over R / kTile blocks, at most two atomics each per channel.
//     (An interior gap of G empty segments is written by the one block
//     that owns it, G / kThreads stores a thread.)
//     The empty head (segments before ids[0]) and tail (after ids[m-1]),
//     which can be tens of millions of segments, are filled grid-stride by
//     all the blocks, 16 bytes a store, with blocks past the rows where
//     the tiles are too few.
//   - segreduce_prefill, launched first: the identity into each segment
//     that crosses a tile edge, so that its atomics start from it.
//
// Bound on this card: bytes.  The tiled route reads values and ids once and
// writes each output once (crossing segments: a few atomics each), with no
// offset search; the in-order route reads values and the nseg + 1 offsets
// (the wrapper's searchsorted reads the ids log2(m) times a segment).
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

enum Op { kSum = 0, kMax = 1, kMin = 2 };
enum DType { kFloat32 = 0, kInt32 = 1 };

constexpr int kThreads = 256;              // tiled route: threads a block
constexpr int kItems = 8;                  // consecutive rows a thread
constexpr int kTile = kThreads * kItems;   // rows a block: 2048
constexpr int kWarps = kThreads / 32;
constexpr int kBuf = 8192;                 // segment elements staged in shared memory
constexpr int kBlocksPerSM = 4;            // tiled blocks resident an SM (<= 64 registers)
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- in order

__global__ void segreduce_inorder_kernel(const float* __restrict__ values,
                                         const int* __restrict__ offsets,
                                         float* __restrict__ out,
                                         long long nseg, int d) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= nseg * d) return;
  long long s = t / d;
  int c = static_cast<int>(t - s * d);
  int begin = offsets[s];
  int end = offsets[s + 1];
  const float* p = values + static_cast<long long>(begin) * d + c;
  float acc = 0.0f;
#pragma unroll 4
  for (int i = begin; i < end; ++i, p += d) {
    acc = acc + __ldg(p);
  }
  out[t] = acc;
}

// --------------------------------------------------------------- order-free

// The fold on int32 keys: sum wraps (two's complement), max/min are exact.
template <int OP>
__device__ __forceinline__ int combine(int a, int b) {
  if (OP == kSum) return static_cast<int>(static_cast<unsigned>(a) +
                                          static_cast<unsigned>(b));
  if (OP == kMax) return max(a, b);
  return min(a, b);
}

// Float bits -> a key whose int32 order is the float order with -0 < +0;
// NaN -> the key that wins the fold.  The map is its own inverse on keys
// that are not NaN keys, and sends the NaN keys back to NaN bits
// (0x7fffffff for max, 0xffffffff for min).
template <int OP>
__device__ __forceinline__ int to_key(int b) {
  if ((b & 0x7fffffff) > 0x7f800000) return OP == kMax ? INT_MAX : INT_MIN;
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ int from_key(int k) {
  return k ^ ((k >> 31) & 0x7fffffff);
}

// Combine `bits` (an output value) into *p, exactly and in any order.
template <int OP, bool FKEY>
__device__ __forceinline__ void atomic_combine(int* p, int bits) {
  if (OP == kSum) {
    atomicAdd(p, bits);
  } else if (!FKEY) {
    if (OP == kMax) atomicMax(p, bits); else atomicMin(p, bits);
  } else {
    // float bits: b >= 0 orders as int, b < 0 in reverse as unsigned
    unsigned* u = reinterpret_cast<unsigned*>(p);
    if (OP == kMax) {
      if (bits >= 0) atomicMax(p, bits);
      else atomicMin(u, static_cast<unsigned>(bits));
    } else {
      if (bits >= 0) atomicMin(p, bits);
      else atomicMax(u, static_cast<unsigned>(bits));
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The identity into each segment that crosses a tile edge, so that the
// tiles' atomics start from it.  One thread a tile edge.
__global__ void segreduce_prefill(const int* __restrict__ ids,
                                  int* __restrict__ out, long long m,
                                  long long nseg, int d, int ident) {
  const long long k =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x + 1;
  if (k >= (m + kTile - 1) / kTile) return;
  const int s = __ldg(ids + k * kTile);
  if (s == __ldg(ids + k * kTile - 1) && s >= 0 && s < nseg) {
    for (int c = 0; c < d; ++c) out[static_cast<long long>(s) * d + c] = ident;
  }
}

// Elements [e0, e1) of `out` (16-byte aligned) get `ident`: thread t of
// `threads` in the grid, 16 bytes a store between the aligned ends.
__device__ __forceinline__ void fill_identity(int* __restrict__ out,
                                              long long e0, long long e1,
                                              int ident, long long t,
                                              long long threads) {
  if (e1 <= e0) return;
  const long long a0 = min((e0 + 3) & ~3LL, e1);
  const long long a1 = max(e1 & ~3LL, a0);
  if (t < a0 - e0) out[e0 + t] = ident;
  if (t < e1 - a1) out[a1 + t] = ident;
  int4* o = reinterpret_cast<int4*>(out + a0);
  const int4 q = make_int4(ident, ident, ident, ident);
  for (long long x = t; x < (a1 - a0) / 4; x += threads) o[x] = q;
}

// This block's share of the head [0, ids[0]) and the tail (ids[m-1], nseg)
// (all of [0, nseg) when m == 0), which no tile writes and which can be
// tens of millions of segments: a grid-stride fill over every block.
__device__ __forceinline__ void fill_head_tail(const int* __restrict__ ids,
                                               int* __restrict__ out,
                                               long long m, long long nseg,
                                               int d, int ident) {
  long long head = nseg, tail = nseg;      // head: [0, head); tail: [tail, nseg)
  if (m > 0) {
    head = min(max(static_cast<long long>(__ldg(ids)), 0LL), nseg);
    tail = max(min(static_cast<long long>(__ldg(ids + m - 1)) + 1, nseg), head);
  }
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  fill_identity(out, 0, head * d, ident, t, threads);
  fill_identity(out, tail * d, nseg * d, ident, t, threads);
}

// Loads rows [r0, r0 + kItems) of channels [c0, c0 + DC) of `values`
// (16 bytes a load where the rows are whole, d == DC and the pointer is
// aligned); rows past m get `ident`.  With FKEY, float bits become keys.
template <int OP, bool FKEY, int DC>
__device__ __forceinline__ void load_values(int (&v)[kItems][DC],
                                            const int* __restrict__ values,
                                            long long r0, long long m, int d,
                                            int c0, int ident) {
  if (r0 + kItems <= m && d == DC && aligned16(values)) {
    const int4* p = reinterpret_cast<const int4*>(values + r0 * DC);
#pragma unroll
    for (int q = 0; q < kItems * DC / 4; ++q) {
      int4 t = __ldg(p + q);
      int* f = &v[0][0] + 4 * q;
      f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        v[i][j] = r0 + i < m ? __ldg(values + (r0 + i) * d + c0 + j) : ident;
      }
    }
  }
  if (FKEY) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
#pragma unroll
      for (int j = 0; j < DC; ++j) v[i][j] = to_key<OP>(v[i][j]);
    }
  }
}

// One tile of kTile rows a block; DC channels a pass (DC == d for d = 1, 2;
// DC = 1, looped over the channels, otherwise).  `ident_key` is the
// identity as a key, `ident` as an output value.
//
// The tile writes the segments [lo, hi): those after the id of the row
// before it (from ids[0] for the first tile) up to the id of its last row,
// less a last segment that goes on into the next tile.  Each of them lies
// wholly in the tile or is empty, so it is written once, here: into a
// shared buffer first, prefilled with the identity, and copied out whole
// (coalesced) when [lo, hi) fits in kBuf elements; else the identity goes
// straight to `out` and the block's stores follow it.  The other segments
// of the tile (one going on from the previous tile, one going on into the
// next) are combined with atomics.
template <int OP, bool FKEY, int DC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
segreduce_tiled(const int* __restrict__ values, const int* __restrict__ ids,
                int* __restrict__ out, long long m, long long nseg, int d,
                int ident_key, int ident) {
  __shared__ int s_first[kThreads];
  __shared__ int s_last[kThreads];
  __shared__ int s_wflag[kWarps];
  __shared__ int s_wval[kWarps][DC];
  __shared__ int s_edge[3];   // ids before and after the tile (-1: none), of its last row
  __shared__ int s_buf[kBuf];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long r0 = base + static_cast<long long>(tid) * kItems;
  if (base >= m) {                 // a block past the rows: its share of
    fill_head_tail(ids, out, m, nseg, d, ident);   // the head and tail only
    return;
  }

  // every load first: ids, the values of the first channels, the edges.
  // Rows past m get the id INT_MAX, never a real one (the wrapper keeps
  // nseg below 2^31 - 1), and are neither stored nor filled.
  int id[kItems];
  if (r0 + kItems <= m && aligned16(ids)) {
    const int4* p = reinterpret_cast<const int4*>(ids + r0);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      int4 t = __ldg(p + q);
      id[4 * q] = t.x; id[4 * q + 1] = t.y; id[4 * q + 2] = t.z; id[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      id[i] = r0 + i < m ? __ldg(ids + r0 + i) : INT_MAX;
    }
  }
  int v[kItems][DC];
  load_values<OP, FKEY, DC>(v, values, r0, m, d, 0, ident);
  const long long rlast = min(base + kTile, m) - 1;
  if (tid == 0) s_edge[0] = base > 0 ? __ldg(ids + base - 1) : -1;
  if (tid == kThreads - 1) s_edge[1] = base + kTile < m ? __ldg(ids + base + kTile) : -1;
  if (r0 <= rlast && rlast < r0 + kItems) s_edge[2] = id[rlast - r0];
  s_first[tid] = id[0];
  s_last[tid] = id[kItems - 1];
  __syncthreads();

  const int prev = tid > 0 ? s_last[tid - 1] : s_edge[0];
  const int next = tid < kThreads - 1 ? s_first[tid + 1] : s_edge[1];
  unsigned heads = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (id[i] != (i > 0 ? id[i - 1] : prev)) heads |= 1u << i;
  }
  const long long lo = max(base > 0 ? static_cast<long long>(s_edge[0]) + 1
                                    : static_cast<long long>(s_first[0]), 0LL);
  const long long hi = min(static_cast<long long>(s_edge[2]) +
                               (s_edge[1] == s_edge[2] ? 0 : 1), nseg);
  const long long n = max(hi - lo, 0LL) * d;
  const bool staged = n <= kBuf;
  if (staged) {
    for (int x = tid; x < n; x += kThreads) s_buf[x] = ident;
  } else {
    for (long long x = tid; x < n; x += kThreads) out[lo * d + x] = ident;
  }
  __syncthreads();

  for (int c0 = 0; c0 < d; c0 += DC) {
    if (c0 > 0) load_values<OP, FKEY, DC>(v, values, r0, m, d, c0, ident);

    // this thread's part of the run open at its last row
    int acc[DC];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        acc[j] = (i == 0 || ((heads >> i) & 1)) ? v[i][j]
                                                 : combine<OP>(acc[j], v[i][j]);
      }
    }

    // exclusive segmented scan over the block's threads of (has a head,
    // part): (f1, v1) + (f2, v2) = (f1 | f2, f2 ? v2 : v1 op v2)
    int f = heads != 0;
    int val[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) val[j] = acc[j];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int fu = __shfl_up_sync(kFull, f, off);
      int vu[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) vu[j] = __shfl_up_sync(kFull, val[j], off);
      if (lane >= off) {
        if (!f) {
#pragma unroll
          for (int j = 0; j < DC; ++j) val[j] = combine<OP>(vu[j], val[j]);
        }
        f |= fu;
      }
    }
    int fe = __shfl_up_sync(kFull, f, 1);
    int ve[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) ve[j] = __shfl_up_sync(kFull, val[j], 1);
    if (lane == 0) {
      fe = 0;
#pragma unroll
      for (int j = 0; j < DC; ++j) ve[j] = ident_key;
    }
    if (lane == 31) {
      s_wflag[warp] = f;
#pragma unroll
      for (int j = 0; j < DC; ++j) s_wval[warp][j] = val[j];
    }
    __syncthreads();
    int fw = 0;
    int vw[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) vw[j] = ident_key;
    for (int w = 0; w < warp; ++w) {
      const int fx = s_wflag[w];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        vw[j] = fx ? s_wval[w][j] : combine<OP>(vw[j], s_wval[w][j]);
      }
      fw |= fx;
    }
    __syncthreads();   // s_w* are rewritten by the next channel pass
    // carry: the fold of the open run's rows before this thread, and
    // whether that run's head lies in this tile
    bool in_tile = fw | fe;
    int carry[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) carry[j] = fe ? ve[j] : combine<OP>(vw[j], ve[j]);

#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const bool head = (heads >> i) & 1;
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        acc[j] = head ? v[i][j]
                      : combine<OP>(i == 0 ? carry[j] : acc[j], v[i][j]);
      }
      in_tile |= head;
      const int nxt = i < kItems - 1 ? id[i + 1] : next;
      const bool last_row = tid == kThreads - 1 && i == kItems - 1;
      if (nxt == id[i] && !last_row) continue;       // the run goes on
      if (r0 + i >= m || id[i] < 0 || id[i] >= nseg) continue;
      int bits[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) bits[j] = FKEY ? from_key(acc[j]) : acc[j];
      const long long at = (static_cast<long long>(id[i]) - lo) * d + c0;
      if (in_tile && nxt != id[i]) {                 // whole in this tile
        if (at < 0 || at >= n) continue;             // (ids out of order)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          if (staged) s_buf[at + j] = bits[j]; else out[lo * d + at + j] = bits[j];
        }
      } else {                                       // crosses a tile edge
        int* p = out + static_cast<long long>(id[i]) * d + c0;
#pragma unroll
        for (int j = 0; j < DC; ++j) atomic_combine<OP, FKEY>(p + j, bits[j]);
      }
    }
  }
  if (staged) {
    __syncthreads();
    for (int x = tid; x < n; x += kThreads) out[lo * d + x] = s_buf[x];
  }
  fill_head_tail(ids, out, m, nseg, d, ident);
}

template <int OP, bool FKEY>
int launch_tiled(const void* values, const int* ids, void* out, long long m,
                 long long nseg, int d, int ident_key, int ident,
                 cudaStream_t stream) {
  const long long tiles = (m + kTile - 1) / kTile;
  int* o = static_cast<int*>(out);
  const int* v = static_cast<const int*>(values);
  if (tiles > 1) {
    segreduce_prefill<<<static_cast<unsigned>((tiles + kThreads - 2) / kThreads),
                        kThreads, 0, stream>>>(ids, o, m, nseg, d, ident);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // one block a tile, and at least enough blocks for the head and tail
  // fill to take some 32 elements a thread, up to 16 blocks an SM's worth
  const long long fill_blocks =
      std::min((nseg * d + 32 * kThreads - 1) / (32 * kThreads), 2112LL);
  const unsigned grid = static_cast<unsigned>(std::max(tiles, fill_blocks));
  if (d == 2) {
    segreduce_tiled<OP, FKEY, 2><<<grid, kThreads, 0, stream>>>(
        v, ids, o, m, nseg, d, ident_key, ident);
  } else {
    segreduce_tiled<OP, FKEY, 1><<<grid, kThreads, 0, stream>>>(
        v, ids, o, m, nseg, d, ident_key, ident);
  }
  return static_cast<int>(cudaGetLastError());
}

int bits_of(float x) {
  int b;
  std::memcpy(&b, &x, sizeof b);
  return b;
}

int key_of(int b) { return b ^ ((b >> 31) & 0x7fffffff); }

}  // namespace

// Rows a block of the tiled route takes (tests build layouts at its edges).
extern "C" int segreduce_tile_rows() { return kTile; }

// values: [m, d] float32 or int32, row-major; ids: int32 [m], nondecreasing,
// in [0, nseg); out: [nseg, d] of the values' type.  `offsets` (int32
// [nseg + 1], the first row of each segment and m) is read by the f32 sum
// alone and may be null otherwise.  Returns 0 on success, else a
// cudaError_t code (launch refused, or a bad op/dtype/size).  Launches on
// `stream`; does not synchronise or allocate.
extern "C" int segreduce_sorted(const void* values, const int* ids,
                                const int* offsets, void* out, long long m,
                                long long nseg, int d, int op, int dtype,
                                void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (nseg == 0) return 0;
  if (d < 1 || m < 0 || nseg < 0 || m >= INT_MAX || nseg >= INT_MAX) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && op == kSum) {
    if (offsets == nullptr) return invalid;
    const int threads = 256;
    const long long blocks = (nseg * d + threads - 1) / threads;
    if (blocks > INT_MAX) return invalid;
    segreduce_inorder_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
            static_cast<const float*>(values), offsets,
            static_cast<float*>(out), nseg, d);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == kFloat32) {
    const int inf = bits_of(INFINITY), ninf = bits_of(-INFINITY);
    if (op == kMax) return launch_tiled<kMax, true>(values, ids, out, m, nseg, d, key_of(ninf), ninf, s);
    if (op == kMin) return launch_tiled<kMin, true>(values, ids, out, m, nseg, d, key_of(inf), inf, s);
    return invalid;
  }
  if (dtype == kInt32) {
    if (op == kSum) return launch_tiled<kSum, false>(values, ids, out, m, nseg, d, 0, 0, s);
    if (op == kMax) return launch_tiled<kMax, false>(values, ids, out, m, nseg, d, INT_MIN, INT_MIN, s);
    if (op == kMin) return launch_tiled<kMin, false>(values, ids, out, m, nseg, d, INT_MAX, INT_MAX, s);
  }
  return invalid;
}
