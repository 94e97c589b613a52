// Sorted segment reduce for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/segsum.py:_segscan_kernel
// (behind segscan_blocked and the boundary gather of ops.segreduce_sorted):
//
//   out[s, c] = fold(op, values[i, c] for the rows i with ids[i] == s)
//
// over nondecreasing int32 ids; an empty segment gets the identity of `op`
// (sum: 0; max: -inf / INT32_MIN; min: +inf / INT32_MAX).  Two routes,
// chosen by (op, dtype) before launch.  Both take fixed tiles of kTile
// rows, one block a tile, so no hub segment lands on one thread or block
// whole, and neither searches for offsets:
//
// * f32 sum, in order (segreduce_inorder).  Float addition is not
//   associative, and a one-ulp difference in a run sum flips a
//   delta-modularity tie-break and with it the partition, so each segment
//   is the strict left fold ((0.0f + v[b]) + v[b+1]) + ... of its rows in
//   index order, one chain a channel: no tree, no float atomic, no
//   reassociation (__fadd_rn, and no -ftz or fast math in the build).
//   A block takes its tile by an atomic ticket, so the tile before it has
//   always started, and stages the tile's values in shared memory (16-byte
//   loads spread over the block).  A thread folds the segments whose first
//   row (head) lies among its kItems rows, from +0.0, up to the next head
//   in the tile, with the shared-memory loads of the rows running three
//   steps ahead of the adds.  A segment that goes on into the next tile
//   hands its fold on as a carry: one 64-bit word, ready flag high and
//   float bits low, in one store.  The tile's first segment, when it goes
//   on from the tile before, is folded by one thread from that tile's
//   carry (polled with __nanosleep back-off), after the thread's own work;
//   it is handed on at once when the tile lies wholly inside the segment,
//   so carries wait on each other only along a segment that crosses
//   tiles, never across unrelated tiles.  The segments that end in the
//   tile and the empty ones between its ids are staged in shared memory
//   (+0.0 first) and copied out coalesced; all blocks fill the empty head
//   and tail.  Bound: the bytes, or the FADD chain of the longest
//   segment (its rows x the add's latency), whichever is longer.
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
// Bound on this card: bytes, for both routes (values and ids read once,
// each output written once); for the in-order route also the FADD chain
// of the longest segment, which no order-keeping design can shorten.
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

enum Op { kSum = 0, kMax = 1, kMin = 2 };
enum DType { kFloat32 = 0, kInt32 = 1 };

constexpr int kThreads = 256;              // threads a block
constexpr int kItems = 8;                  // consecutive rows a thread
constexpr int kTile = kThreads * kItems;   // rows a block: 2048
constexpr int kWarps = kThreads / 32;
constexpr int kBuf = 8192;                 // tiled route: outputs staged in shared memory
constexpr int kBlocksPerSM = 4;            // blocks resident an SM (<= 64 registers)
constexpr unsigned kFull = 0xffffffffu;

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

// ------------------------------------------------------------- in order

// in-order route: outputs staged in shared memory (fewer than kBuf, so that
// with the staged values the block stays within 48 KB of static shared memory)
constexpr int kInBuf = 6144;
constexpr unsigned long long kReady = 1ull << 32;   // a carry word's flag

// A carry: the ready flag above the float bits, in one 64-bit store, so a
// reader never sees the flag without the value.  The word is all that
// passes between the blocks (each output has one writer), so strong
// relaxed accesses at gpu scope are enough: coherence on the one word
// orders flag and value together, and no other memory is published
// through it.  (Release/acquire would add a fence to every handoff on a
// hub's chain, and measured slower on the H100.)
__device__ __forceinline__ void publish_carry(unsigned long long* p, float x) {
  const unsigned long long w = kReady | __float_as_uint(x);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

// The DC carries of tile t - 1 from p[0 .. DC), polled together (one
// round trip a poll, not one a channel).
template <int DC>
__device__ __forceinline__ void await_carry(float (&acc)[DC], const unsigned long long* p) {
  unsigned long long w[DC];
  unsigned ns = 32;
  for (;;) {
    bool ready = true;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w[j]) : "l"(p + j) : "memory");
    }
#pragma unroll
    for (int j = 0; j < DC; ++j) ready = ready && (w[j] & kReady);
    if (ready) break;
    __nanosleep(ns);
    ns = min(2 * ns, 128u);
  }
#pragma unroll
  for (int j = 0; j < DC; ++j) acc[j] = __uint_as_float(static_cast<unsigned>(w[j]));
}

// acc += rows [r, min(r + N, e)) of the staged tile s (DC floats a row),
// every load issued before the first add.
template <int DC, int N>
__device__ __forceinline__ void fold_few(float (&acc)[DC], const float* s,
                                         int r, int e) {
  float x[N][DC];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < DC; ++j) x[i][j] = r + i < e ? s[(r + i) * DC + j] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (r + i < e) {
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[j] = __fadd_rn(acc[j], x[i][j]);
    }
  }
}

// Two 16-byte loads of the staged tile: 8 / DC rows from row r.
template <int DC>
__device__ __forceinline__ void load_step(float4 (&x)[2], const float* s, int r) {
  const float4* p = reinterpret_cast<const float4*>(s + r * DC);
  x[0] = p[0];
  x[1] = p[1];
}

// Their adds, row by row; channel j of a row is element k % DC.
template <int DC>
__device__ __forceinline__ void add_step(float (&acc)[DC], const float4 (&x)[2]) {
  const float f[8] = {x[0].x, x[0].y, x[0].z, x[0].w,
                      x[1].x, x[1].y, x[1].z, x[1].w};
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k % DC] = __fadd_rn(acc[k % DC], f[k]);
}

// acc += rows [r, e) of the staged tile, in index order; r is a multiple
// of 4 (a 16-byte row).  A ring of four steps: each step's rows are loaded
// three steps ahead of their adds (48 cycles of adds at DC = 2, 96 at
// DC = 1), so the chain waits on the adds and not on shared memory.
template <int DC>
__device__ __forceinline__ void fold_staged(float (&acc)[DC], const float* s,
                                            int r, int e) {
  constexpr int S = 8 / DC;                      // rows a step
  float4 x0[2], x1[2], x2[2], x3[2];
  if (r + 4 * S <= e) {
    load_step<DC>(x0, s, r);
    load_step<DC>(x1, s, r + S);
    load_step<DC>(x2, s, r + 2 * S);
    load_step<DC>(x3, s, r + 3 * S);
    for (; r + 8 * S <= e; r += 4 * S) {
      add_step<DC>(acc, x0);
      load_step<DC>(x0, s, r + 4 * S);
      add_step<DC>(acc, x1);
      load_step<DC>(x1, s, r + 5 * S);
      add_step<DC>(acc, x2);
      load_step<DC>(x2, s, r + 6 * S);
      add_step<DC>(acc, x3);
      load_step<DC>(x3, s, r + 7 * S);
    }
    add_step<DC>(acc, x0);
    add_step<DC>(acc, x1);
    add_step<DC>(acc, x2);
    add_step<DC>(acc, x3);
    r += 4 * S;
  }
  for (; r + S <= e; r += S) {
    load_step<DC>(x0, s, r);
    add_step<DC>(acc, x0);
  }
  fold_few<DC, S - 1>(acc, s, r, e);
}

// Rows [base, base + len) of channels [c0, c0 + DC) into s (DC floats a
// row): 16-byte loads spread over the block where the rows are contiguous
// (d == DC) and aligned, every load issued before the first store.
template <int DC>
__device__ __forceinline__ void stage_values(float* s, const float* __restrict__ values,
                                             long long base, int len, int d, int c0) {
  const int tid = threadIdx.x;
  const int n = len * DC;
  if (d == DC && aligned16(values)) {
    const float4* src = reinterpret_cast<const float4*>(values + base * DC);
    float4* dst = reinterpret_cast<float4*>(s);
    constexpr int kVec = kTile * DC / 4 / kThreads;
    float4 t[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int q = tid + k * kThreads;
      if (q < n / 4) t[k] = __ldg(src + q);
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int q = tid + k * kThreads;
      if (q < n / 4) dst[q] = t[k];
    }
    for (int q = (n & ~3) + tid; q < n; q += kThreads) s[q] = __ldg(values + base * DC + q);
  } else {
    for (int q = tid; q < n; q += kThreads) {
      s[q] = __ldg(values + (base + q / DC) * d + c0 + q % DC);
    }
  }
}

// One tile of kTile rows a block, the tile taken by ticket; DC channels a
// pass: one pass when d == DC (d = 1, 2), else (MULTI) DC = 1 and a pass a
// channel.  scratch[0] is the ticket and scratch[1 + t * d + c] tile t's
// carry of channel c, all zero at launch.
//
// The tile writes the segments [lo, hi), as segreduce_tiled does: those
// after the id of the row before it (from ids[0] for the first tile) up to
// the id of its last row, less a last segment that goes on into the next
// tile.  Each of them ends in the tile or is empty.  Besides, when the
// tile's first segment goes on from the tile before and ends here, the
// thread that takes the carry writes it.  So each output is written once.
template <int DC, bool MULTI>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
segreduce_inorder(const float* __restrict__ values, const int* __restrict__ ids,
                  unsigned long long* __restrict__ scratch,
                  float* __restrict__ out, long long m, long long nseg, int d) {
  __shared__ __align__(16) float s_val[kTile * DC];
  __shared__ __align__(16) float s_buf[kInBuf];
  __shared__ int s_first[kThreads];
  __shared__ int s_last[kThreads];
  __shared__ int s_wmin[kWarps];
  __shared__ int s_edge[3];   // ids before and after the tile, of its last row
  __shared__ unsigned long long s_ticket;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_ticket = atomicAdd(scratch, 1ull);
  __syncthreads();
  // tickets go out in launch order: the tile before this one has started,
  // so waiting on its carry cannot wait on a block that is not resident
  const long long tile = static_cast<long long>(s_ticket);
  const long long base = tile * kTile;
  int* const out_bits = reinterpret_cast<int*>(out);
  if (base >= m) {                 // a block past the rows: its share of
    fill_head_tail(ids, out_bits, m, nseg, d, 0);   // the head and tail only
    return;
  }
  const int len = static_cast<int>(min(static_cast<long long>(kTile), m - base));
  const long long r0 = base + static_cast<long long>(tid) * kItems;

  // every load first: ids, the edges, the values of the first channels
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
  const long long rlast = base + len - 1;
  if (tid == 0) s_edge[0] = base > 0 ? __ldg(ids + base - 1) : 0;
  if (tid == kThreads - 1) s_edge[1] = base + kTile < m ? __ldg(ids + base + kTile) : 0;
  if (r0 <= rlast && rlast < r0 + kItems) s_edge[2] = id[rlast - r0];
  s_first[tid] = id[0];
  s_last[tid] = id[kItems - 1];
  stage_values<DC>(s_val, values, base, len, d, 0);
  __syncthreads();

  const int first_id = s_first[0];
  const int last_id = s_edge[2];
  const bool cont_in = base > 0 && s_edge[0] == first_id;
  const bool cont_out = base + kTile < m && s_edge[1] == last_id;
  unsigned heads = 0;               // rows of mine where a segment starts
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool head = i > 0 ? id[i] != id[i - 1]
                            : (tid > 0 ? id[0] != s_last[tid - 1] : !cont_in);
    if (r0 + i < m && head) heads |= 1u << i;
  }

  // the first head after my rows (a suffix min over the threads), and the
  // tile's first head; the tile's length where there is none
  int x = heads ? tid * kItems + __ffs(heads) - 1 : kTile;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_down_sync(kFull, x, off);
    if (lane + off < 32) x = min(x, y);
  }
  int after = __shfl_down_sync(kFull, x, 1);
  if (lane == 31) after = kTile;
  if (lane == 0) s_wmin[warp] = x;

  const long long lo = max(base > 0 ? static_cast<long long>(s_edge[0]) + 1
                                    : static_cast<long long>(first_id), 0LL);
  const long long hi = min(static_cast<long long>(last_id) + (cont_out ? 0 : 1), nseg);
  const long long n = max(hi - lo, 0LL) * d;
  const bool staged = n <= kInBuf;
  if (staged) {
    for (int q = tid; q < n; q += kThreads) s_buf[q] = 0.0f;
  } else {
    for (long long q = tid; q < n; q += kThreads) out[lo * d + q] = 0.0f;
  }
  __syncthreads();
  int first_head = kTile;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    first_head = min(first_head, s_wmin[w]);
    if (w > warp) after = min(after, s_wmin[w]);
  }
  first_head = min(first_head, len);
  const int next_head = min(after, len);
  const int mine = min(kItems, max(len - tid * kItems, 0));   // my rows in the tile

  // a segment that ends in the tile: into its place in [lo, hi)
  auto emit = [&](long long s, const float (&acc)[DC], int c0) {
    if (s < lo || s >= hi) return;               // (ids out of order)
    const long long at = (s - lo) * d + c0;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      if (staged) s_buf[at + j] = acc[j]; else out[lo * d + at + j] = acc[j];
    }
  };
  unsigned long long* const carry = scratch + 1;

  for (int c0 = 0; c0 < (MULTI ? d : DC); c0 += DC) {
    if (MULTI && c0 > 0) {
      __syncthreads();             // the last pass's rows are folded
      stage_values<DC>(s_val, values, base, len, d, c0);
      __syncthreads();
    }

    // the segments whose heads are mine, each from +0.0: over my rows,
    // the last one on to the next head after them
    if (heads) {
      float v[kItems][DC];
      const float4* sv = reinterpret_cast<const float4*>(s_val + tid * kItems * DC);
#pragma unroll
      for (int q = 0; q < kItems * DC / 4; ++q) {
        const float4 t = sv[q];
        float* f = &v[0][0] + 4 * q;
        f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
      }
      float acc[DC] = {};
      long long open = 0;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if ((heads >> i) & 1) {
          if (i > 0 && (heads & ((1u << i) - 1))) emit(id[i - 1], acc, c0);
          open = id[i];
#pragma unroll
          for (int j = 0; j < DC; ++j) acc[j] = 0.0f;
        }
        if ((heads & ((2u << i) - 1)) && i < mine) {
#pragma unroll
          for (int j = 0; j < DC; ++j) acc[j] = __fadd_rn(acc[j], v[i][j]);
        }
      }
      fold_staged<DC>(acc, s_val, (tid + 1) * kItems, next_head);
      if (next_head == len && cont_out) {        // goes on into the next tile
#pragma unroll
        for (int j = 0; j < DC; ++j) publish_carry(carry + tile * d + c0 + j, acc[j]);
      } else {
        emit(open, acc, c0);
      }
    }

    // the first segment, going on from the tile before: its carry, then its
    // rows here; handed on at once if the tile lies wholly inside it
    if (tid == 0 && cont_in) {
      float acc[DC];
      await_carry<DC>(acc, carry + (tile - 1) * d + c0);
      fold_staged<DC>(acc, s_val, 0, first_head);
      if (first_head == len && cont_out) {
#pragma unroll
        for (int j = 0; j < DC; ++j) publish_carry(carry + tile * d + c0 + j, acc[j]);
      } else if (first_id >= 0 && first_id < nseg) {
#pragma unroll
        for (int j = 0; j < DC; ++j) out[static_cast<long long>(first_id) * d + c0 + j] = acc[j];
      }
    }
  }
  __syncthreads();
  if (staged) {
    for (int q = tid; q < n; q += kThreads) out[lo * d + q] = s_buf[q];
  }
  fill_head_tail(ids, out_bits, m, nseg, d, 0);
}

// (1 + tiles * d) 8-byte words of `scratch`, zeroed here on the stream.
int launch_inorder(const void* values, const int* ids, void* scratch,
                   void* out, long long m, long long nseg, int d,
                   cudaStream_t stream) {
  const long long tiles = (m + kTile - 1) / kTile;
  auto* st = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(
      st, 0, static_cast<size_t>(1 + tiles * d) * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long fill_blocks =
      std::min((nseg * d + 32 * kThreads - 1) / (32 * kThreads), 2112LL);
  const unsigned grid = static_cast<unsigned>(std::max({tiles, fill_blocks, 1LL}));
  const float* v = static_cast<const float*>(values);
  float* o = static_cast<float*>(out);
  if (d == 2) {
    segreduce_inorder<2, false><<<grid, kThreads, 0, stream>>>(v, ids, st, o, m, nseg, d);
  } else if (d == 1) {
    segreduce_inorder<1, false><<<grid, kThreads, 0, stream>>>(v, ids, st, o, m, nseg, d);
  } else {
    segreduce_inorder<1, true><<<grid, kThreads, 0, stream>>>(v, ids, st, o, m, nseg, d);
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

// Rows a block of either route takes (tests build layouts at its edges).
extern "C" int segreduce_tile_rows() { return kTile; }

// values: [m, d] float32 or int32, row-major; ids: int32 [m], nondecreasing,
// in [0, nseg); out: [nseg, d] of the values' type.  `scratch` is read by
// the f32 sum alone and may be null otherwise: (1 + ceil(m / kTile) * d)
// 8-byte words, 8-byte aligned, which the launch zeroes on `stream`.
// Returns 0 on success, else a cudaError_t code (launch refused, or a bad
// op/dtype/size).  Launches on `stream`; does not synchronise or allocate.
extern "C" int segreduce_sorted(const void* values, const int* ids,
                                void* scratch, void* out, long long m,
                                long long nseg, int d, int op, int dtype,
                                void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (nseg == 0) return 0;
  if (d < 1 || m < 0 || nseg < 0 || m >= INT_MAX || nseg >= INT_MAX) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && op == kSum) {
    if (scratch == nullptr) return invalid;
    return launch_inorder(values, ids, scratch, out, m, nseg, d, s);
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
