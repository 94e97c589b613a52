// Unsorted segment sum for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/onehot_segsum.py:onehot_segsum:
//   out[s, c] = sum over rows i with ids[i] == s of values[i, c]
// for values [N, D] (float32/float16/bfloat16, summed in float32, D <= 3072)
// and int32 ids; empty segments get 0, and a row whose id lies outside
// [0, C) adds nothing and is never used to address memory (its one-hot row
// is 0 on the TPU).  Like the TPU kernel it is deterministic, here more
// strictly: the order in which each (segment, channel) is summed depends on
// the ids, N, C, D and this file's constants only, never on the card's SM
// count or on timing, so kernels/onehot_segsum.py:emulate gives the same
// bits on the CPU.  No float atomics; integer atomics only to count a
// chunk's rows per bucket and to take the scan's tiles in order, where the
// order of the operations changes no result.
//
// The TPU kernel forms onehot(ids) and accumulates onehot^T @ values on the
// matrix unit, with the whole [C, D] output in VMEM: N*C*D multiply-adds,
// hopeless at large C, and CUDA has no in-order grid.  Here a stable counting
// sort by bucket comes first, so that each id is read twice whatever C is.
// A bucket is T = tile_segments consecutive segments, T*D <= 4096 floats
// (16 KB).  The plan (T, the chunk of R rows counted together, the piece of
// at most P rows folded by one block, the bucket and chunk counts) is
// kernels/onehot_segsum.py:plan_for; it takes N, C and D alone, so the
// wrapper sizes grids and scratch without reading anything back from the
// card.  The wrapper's one call launches these five kernels:
//   1. segsum_histogram: counts[bucket][chunk].  Up to kSharedBuckets
//      buckets ("shared" plans) block j counts chunk j, R = 8 * 1024 rows,
//      each warp its 1024 rows into its own shared-memory counters, kept
//      as wcounts[chunk][warp][bucket]; past that, warp j counts chunk j
//      (R >= buckets) into its column of `counts`.
//   2. segsum_scan: incl = the inclusive scan of counts in bucket-major
//      order, in int64, in one pass (a decoupled look-back; integer sums,
//      exact in any order).  The rows of (bucket b, chunk j) go to
//      [incl - counts, incl) at [b][j].
//   3. Shared plans, segsum_sort_block: block j ranks chunk j's rows by
//      bucket into shared memory, stably (a warp's 32-row group finds each
//      row's peers in its bucket with one ballot a key bit, and a lane's
//      rank is the count of lower peers, after the warp's running count for
//      the bucket), then writes each bucket's rows of the chunk as one run.
//      Global plans, segsum_scatter: each warp ranks its chunk the same way
//      and sends each row straight to its place.  Either way each bucket's
//      rows lie together in index order, as (local segment, value row); for
//      D = 1 as one 8-byte record (local segment, value in float32).
//   4. segsum_fold: a bucket's range [s, e) of the permuted rows is cut at
//      the multiples of P, one block per piece.  Block b < buckets takes the
//      first piece [s, min(e, (s/P + 1)*P)) of bucket b; block buckets + k
//      takes [kP, min(e, (k+1)P)) of the bucket holding row kP, if that
//      bucket began before kP.  So a grid of buckets + ceil(N/P) blocks
//      covers every piece, and a skewed bucket (one giant community) is
//      walked by many blocks.  Each of the block's 4 warps folds a
//      contiguous sub-range of the piece, in index order, into its own tile
//      of T*D floats in shared memory (D <= 4: lanes over rows, the lowest
//      lane of each segment's group adding the group's rows in lane order;
//      D > 4: lanes over channels, rows one after another).  The block then
//      sums the 4 tiles in warp order.  A bucket of one piece writes `out`;
//      the pieces of a longer one write float32 partial tiles.
//   5. segsum_pieces: each bucket of several pieces is the sum of its
//      partial tiles in piece order.
// Every (segment, channel) is thus: a left fold from 0 of each warp's rows,
// those warp sums added in warp order, those piece sums in piece order.
// The kernels load a warp's ids (and D = 1 values) for all of its 32-row
// groups before they work through them, so that loads overlap the serial
// work.
//
// Reads of each id: 2 (histogram, sort or scatter), whatever C.  Bound on
// this card: bytes, N*(4 + D*sizeof(value)) read and C*D*sizeof(value)
// written.  The design moves besides, per call: the ids once more (4N), the
// permuted rows written and read once (2*N*(4 + D*sizeof(value)), or 16N
// for D = 1), the counters (buckets * chunks of them: 4 bytes written, 4 + 8
// scanned, read twice; the warps' counts, 8 times as many, written and read
// once) and, for buckets of several pieces, their partial tiles (4*T*D
// bytes a piece, written and read once).
#include <cuda_runtime.h>

#include <climits>

#include "dtypes.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunkThreads = 256;   // histogram and scatter: a chunk a warp
constexpr int kChunkWarps = kChunkThreads / 32;
constexpr int kFoldWarps = 4;        // a fold block: one tile a warp
constexpr int kFoldThreads = kFoldWarps * 32;
constexpr int kPieceThreads = 256;   // segsum_pieces: one float a thread
constexpr int kTileFloats = 4096;    // T * D of a bucket's tile
constexpr int kMaxChannels = 3072;
constexpr int kSharedBuckets = 1024; // counters in shared memory up to this
constexpr int kSmallD = 32;          // sort: a thread a row up to this D
constexpr int kStagedD = 4;          // fold: lanes over rows up to this D
constexpr int kGroups = 32;          // 32-row groups a chunk (or warp) loads
constexpr int kScanThreads = 1024;   // the scan: 4 counters a thread
constexpr int kScanItems = 4 * kScanThreads;
constexpr long long kAlign = 256;    // scratch regions start at multiples

// The plan of kernels/onehot_segsum.py:plan_for, as the wrapper passes it.
struct Plan {
  long long n, nseg;
  int d, tile;                  // channels; segments of a bucket (T)
  long long buckets, chunks, chunk_rows, piece_rows;
  int shared;                   // counters in shared memory
};

__device__ __forceinline__ long long bucket_start(const int* counts,
                                                  const long long* incl,
                                                  const Plan& p, long long b) {
  return incl[b * p.chunks] - counts[b * p.chunks];
}

__device__ __forceinline__ long long bucket_end(const long long* incl,
                                                const Plan& p, long long b) {
  return incl[(b + 1) * p.chunks - 1];
}

// The bucket of an id, or -1 for an id outside [0, C).
__device__ __forceinline__ int bucket_of(int id, const Plan& p) {
  return (id >= 0 && id < p.nseg) ? id / p.tile : -1;
}

// The lanes whose key equals this lane's, for keys below 2^bits: one ballot
// a bit (a warp-level multisplit), cheaper than __match_any_sync when a
// group holds many distinct keys.
__device__ __forceinline__ unsigned peers_of(unsigned key, int bits) {
  unsigned peers = kFull;
  for (int i = 0; i < bits; ++i) {
    const unsigned bit = (key >> i) & 1u;
    const unsigned ones = __ballot_sync(kFull, bit);
    peers &= bit ? ones : ~ones;
  }
  return peers;
}

__host__ __device__ __forceinline__ long long div_up(long long a, long long b) {
  return (a + b - 1) / b;
}

// Bits of the keys b + 1 (b in [-1, n)) that peers_of compares.
__device__ __forceinline__ int key_bits(long long n) { return 64 - __clzll(n); }

// peers_of for the kGroups groups at once, bit by bit, so that the ballots
// of different groups are in flight together: keys[k] in, peers out.
__device__ __forceinline__ void peers_of_groups(unsigned (&keys)[kGroups],
                                                int bits) {
  unsigned peers[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) peers[k] = kFull;
  for (int i = 0; i < bits; ++i) {
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const unsigned bit = (keys[k] >> i) & 1u;
      const unsigned ones = __ballot_sync(kFull, bit);
      peers[k] &= bit ? ones : ~ones;
    }
  }
#pragma unroll
  for (int k = 0; k < kGroups; ++k) keys[k] = peers[k];
}

// The ids of the 32-row groups of [blk, blk + 32*kGroups), -1 past hi.
__device__ __forceinline__ void load_ids(const int* ids, long long blk,
                                         long long hi, int lane,
                                         int (&idv)[kGroups]) {
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const long long row = blk + 32 * k + lane;
    idv[k] = row < hi ? ids[row] : -1;
  }
}

// Counters in shared memory: block j counts chunk j (kChunkWarps * 32 *
// kGroups rows), one array a warp; in global memory: warp w counts chunk w
// into its column of `counts`.  Integer atomics among the lanes of a warp:
// their sums do not depend on their order.
__global__ void __launch_bounds__(kChunkThreads)
segsum_histogram(const int* __restrict__ ids, int* __restrict__ counts,
                 int* __restrict__ wcounts, unsigned long long* __restrict__ status,
                 long long status_words, Plan p) {
  extern __shared__ int hist_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long e = static_cast<long long>(blockIdx.x) * kChunkThreads + threadIdx.x;
       e < status_words; e += static_cast<long long>(gridDim.x) * kChunkThreads)
    status[e] = 0;                      // the scan's status words and ticket
  int idv[kGroups];
  if (p.shared) {
    // warp w counts the chunk's w-th 32*kGroups rows: wcounts[chunk][w][b];
    // the chunk's counts are their sums
    const long long chunk = blockIdx.x;
    const long long wb = kChunkWarps * p.buckets;
    for (long long e = threadIdx.x; e < wb; e += kChunkThreads) hist_smem[e] = 0;
    __syncthreads();
    int* cnt = hist_smem + warp * p.buckets;
    const long long lo = chunk * p.chunk_rows + warp * 32 * kGroups;
    load_ids(ids, lo, min(p.n, lo + 32 * kGroups), lane, idv);
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int b = bucket_of(idv[k], p);
      if (b >= 0) atomicAdd(cnt + b, 1);
    }
    __syncthreads();
    for (long long e = threadIdx.x; e < wb; e += kChunkThreads)
      wcounts[chunk * wb + e] = hist_smem[e];
    for (long long b = threadIdx.x; b < p.buckets; b += kChunkThreads) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < kChunkWarps; ++w) c += hist_smem[w * p.buckets + b];
      counts[b * p.chunks + chunk] = c;
    }
    return;
  }
  const long long chunk = static_cast<long long>(blockIdx.x) * kChunkWarps + warp;
  if (chunk >= p.chunks) return;
  for (long long b = lane; b < p.buckets; b += 32) counts[b * p.chunks + chunk] = 0;
  __syncwarp();
  const long long lo = chunk * p.chunk_rows;
  const long long hi = min(p.n, lo + p.chunk_rows);
  for (long long blk = lo; blk < hi; blk += 32 * kGroups) {
    load_ids(ids, blk, hi, lane, idv);
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int b = bucket_of(idv[k], p);
      if (b >= 0) atomicAdd(counts + b * p.chunks + chunk, 1);
    }
  }
}

// An inclusive scan of one value a thread over a block of kWarps warps;
// `sums` ends holding the warps' inclusive totals (sums[kWarps - 1]: the
// block's).
template <int kWarps>
__device__ __forceinline__ long long block_scan(long long x, long long* sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kWarps ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) sums[lane] = w;
  }
  __syncthreads();
  return warp ? x + sums[warp - 1] : x;
}

constexpr unsigned long long kAggregate = 1ULL << 62;  // a tile's own total
constexpr unsigned long long kPrefix = 1ULL << 63;     // ... with all before it
constexpr unsigned long long kValue = kAggregate - 1;

// incl = the inclusive scan of counts, in one pass (a decoupled look-back):
// blocks take tiles of kScanItems counters in launch order from a ticket,
// publish each tile's total, then its inclusive prefix once the totals of
// the tiles before it are added, looking back to the nearest prefix.  The
// status words hold a flag in the top two bits and the value below; the
// last one is the ticket; segsum_histogram zeroes them.  A tile waits only
// on tiles that were taken, so by blocks that run, before it.  Integer
// sums: exact in any order.
__global__ void __launch_bounds__(kScanThreads)
segsum_scan(const int* __restrict__ counts, long long m,
            unsigned long long* __restrict__ status,
            long long* __restrict__ incl) {
  __shared__ long long sums[kScanThreads / 32];
  __shared__ long long tile_s, carry_s;
  const long long tiles = div_up(m, kScanItems);
  if (threadIdx.x == 0)
    tile_s = static_cast<long long>(atomicAdd(status + tiles, 1ULL));
  __syncthreads();
  const long long tile = tile_s;
  const long long i0 = tile * kScanItems + 4 * threadIdx.x;
  int c[4];
  long long x = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[j] = i0 + j < m ? counts[i0 + j] : 0;
    x += c[j];
  }
  const long long inc = block_scan<kScanThreads / 32>(x, sums);
  if (threadIdx.x == 0) {
    const long long total = sums[kScanThreads / 32 - 1];
    long long carry = 0;
    if (tile > 0) {
      atomicExch(status + tile, kAggregate | static_cast<unsigned long long>(total));
      for (long long j = tile - 1;; --j) {
        unsigned long long w;
        for (int spins = 0;
             !((w = *reinterpret_cast<volatile unsigned long long*>(status + j)) >> 62);
             ++spins)
          if (spins > (1 << 22)) __trap();   // never: tile j's block runs
        carry += static_cast<long long>(w & kValue);
        if (w & kPrefix) break;
      }
    }
    atomicExch(status + tile,
               kPrefix | static_cast<unsigned long long>(carry + total));
    carry_s = carry;
  }
  __syncthreads();
  long long run = carry_s + inc - x;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    run += c[j];
    if (i0 + j < m) incl[i0 + j] = run;
  }
}

// Shared memory of segsum_sort_block: the chunk's records, then per bucket
// its int64 base and, per warp, its int32 count, then start.
__host__ __device__ __forceinline__ long long sort_block_bytes(long long buckets) {
  return 8LL * kChunkWarps * 32 * kGroups + 8 * buckets +
         4LL * kChunkWarps * buckets;
}

// Counters in shared memory: block j sorts chunk j by bucket in shared
// memory, stably (warp w ranks the chunk's w-th 32*kGroups rows, after the
// rows of the earlier warps, from the warps' counts), then writes each
// bucket's rows of the chunk as one run to its range.  A record is (id,
// value bits in float32) for D = 1, to be written as it is, else (id, row
// within the chunk).
template <typename T>
__global__ void __launch_bounds__(kChunkThreads)
segsum_sort_block(const T* __restrict__ values, const int* __restrict__ ids,
                  const int* __restrict__ counts,
                  const int* __restrict__ wcounts,
                  const long long* __restrict__ incl, int* __restrict__ perm_seg,
                  T* __restrict__ perm_val, int2* __restrict__ pairs, Plan p,
                  int row16) {
  extern __shared__ long long sort_smem[];
  __shared__ long long sums[kChunkWarps];
  constexpr int kRows = 32 * kGroups;          // rows of a warp
  int2* stage = reinterpret_cast<int2*>(sort_smem);
  long long* gbase = sort_smem + kChunkWarps * kRows;
  int* wcur = reinterpret_cast<int*>(gbase + p.buckets);   // [warp][bucket]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long chunk = blockIdx.x;
  const long long c_lo = chunk * p.chunk_rows;
  int* cur = wcur + warp * p.buckets;
  const long long wb = kChunkWarps * p.buckets;
  for (long long e = threadIdx.x; e < wb; e += kChunkThreads)
    wcur[e] = wcounts[chunk * wb + e];

  // the warp's rows, ids and payloads in registers
  const long long lo = c_lo + warp * kRows;
  const long long hi = min(p.n, lo + kRows);
  int idv[kGroups];
  load_ids(ids, lo, hi, lane, idv);
  int pay[kGroups];                     // D = 1: the values, loaded ahead too
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const long long row = lo + 32 * k + lane;
    pay[k] = p.d != 1 ? warp * kRows + 32 * k + lane
                      : (row < hi ? __float_as_int(to_f32(values[row])) : 0);
  }
  __syncthreads();

  // each thread takes `per` consecutive buckets: the chunk's count of each,
  // scanned in bucket order, gives where its run starts in the chunk; the
  // warps' starts follow in warp order
  const int per = static_cast<int>(div_up(p.buckets, kChunkThreads));
  const long long b0 = static_cast<long long>(threadIdx.x) * per;
  long long mine = 0;
  for (long long b = b0; b < min(b0 + per, p.buckets); ++b)
    for (int w = 0; w < kChunkWarps; ++w) mine += wcur[w * p.buckets + b];
  long long at = block_scan<kChunkWarps>(mine, sums) - mine;
  const int kept = static_cast<int>(sums[kChunkWarps - 1]);
  for (long long b = b0; b < min(b0 + per, p.buckets); ++b) {
    const long long i = b * p.chunks + chunk;
    gbase[b] = incl[i] - counts[i] - at;
    for (int w = 0; w < kChunkWarps; ++w) {
      const int c = wcur[w * p.buckets + b];
      wcur[w * p.buckets + b] = static_cast<int>(at);
      at += c;
    }
  }
  __syncthreads();

  // rank the warp's rows into the chunk's order
  const int bits = key_bits(p.buckets);
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    if (lo + 32 * k >= hi) break;
    const int b = bucket_of(idv[k], p);
    const unsigned peers = peers_of(static_cast<unsigned>(b + 1), bits);
    const unsigned lower = peers & ((1u << lane) - 1u);
    int pos = 0;
    if (b >= 0) pos = cur[b] + __popc(lower);
    __syncwarp();
    if (b >= 0) {
      if (lower == 0) cur[b] = pos + __popc(peers);
      stage[pos] = make_int2(idv[k], pay[k]);
    }
    __syncwarp();
  }
  __syncthreads();

  // write the chunk's rows out, bucket by bucket
  if (p.d <= kSmallD) {
    for (int i = threadIdx.x; i < kept; i += kChunkThreads) {
      const int2 r = stage[i];
      const int b = r.x / p.tile;
      const long long dst = gbase[b] + i;
      if (p.d == 1) {
        pairs[dst] = make_int2(r.x - b * p.tile, r.y);
      } else {
        perm_seg[dst] = r.x - b * p.tile;
        const T* src = values + (c_lo + r.y) * p.d;
        if (row16) {                    // the row in 16-byte pieces
          const int4* from = reinterpret_cast<const int4*>(src);
          int4* to = reinterpret_cast<int4*>(perm_val + dst * p.d);
          for (int j = 0; j < row16; ++j) to[j] = from[j];
        } else {
          for (int c = 0; c < p.d; ++c) perm_val[dst * p.d + c] = src[c];
        }
      }
    }
  } else {
    for (int i = warp; i < kept; i += kChunkWarps) {
      const int2 r = stage[i];
      const int b = r.x / p.tile;
      const long long dst = gbase[b] + i;
      if (lane == 0) perm_seg[dst] = r.x - b * p.tile;
      const T* src = values + (c_lo + r.y) * p.d;
      for (int c = lane; c < p.d; c += 32) perm_val[dst * p.d + c] = src[c];
    }
  }
}

// Counters in global memory: each warp walks its chunk and sends each row
// straight to its place; the cursor of (b, chunk) is incl[b][chunk] itself,
// set to the range's start here, which ends at the range's end, incl's own
// value again, so the fold reads incl unchanged.  D = 1 writes records.
template <typename T>
__global__ void __launch_bounds__(kChunkThreads)
segsum_scatter(const T* __restrict__ values, const int* __restrict__ ids,
               const int* __restrict__ counts, long long* __restrict__ incl,
               int* __restrict__ perm_seg, T* __restrict__ perm_val,
               int2* __restrict__ pairs, Plan p) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long chunk = static_cast<long long>(blockIdx.x) * kChunkWarps + warp;
  if (chunk >= p.chunks) return;
  long long* cur = incl + chunk;
  for (long long b = lane; b < p.buckets; b += 32) {
    const long long i = b * p.chunks + chunk;
    incl[i] -= counts[i];
  }
  __syncwarp();
  const long long lo = chunk * p.chunk_rows;
  const long long hi = min(p.n, lo + p.chunk_rows);
  const int bits = key_bits(p.buckets);
  for (long long blk = lo; blk < hi; blk += 32 * kGroups) {
    int idv[kGroups];
    load_ids(ids, blk, hi, lane, idv);
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const long long base = blk + 32 * k;
      if (base >= hi) break;
      const int id = idv[k];
      const int b = bucket_of(id, p);
      const unsigned peers = peers_of(static_cast<unsigned>(b + 1), bits);
      const unsigned lower = peers & ((1u << lane) - 1u);
      long long dst = 0;
      if (b >= 0) dst = cur[b * p.chunks] + __popc(lower);
      __syncwarp();
      if (b >= 0 && lower == 0) cur[b * p.chunks] = dst + __popc(peers);
      if (p.d == 1) {
        if (b >= 0)
          pairs[dst] = make_int2(id - b * p.tile,
                                 __float_as_int(to_f32(values[base + lane])));
      } else {
        if (b >= 0) perm_seg[dst] = id - b * p.tile;
        // the group's 32 rows are 32*D contiguous values: lane-strided
        // loads, each to its row's place
        for (int j = 0; j < p.d; ++j) {
          const int e = 32 * j + lane;
          const int r = e / p.d;
          const long long dr = __shfl_sync(kFull, dst, r);
          if (__shfl_sync(kFull, b, r) >= 0)
            perm_val[dr * p.d + (e - r * p.d)] = values[base * p.d + e];
        }
      }
      __syncwarp();
    }
  }
}

// Elements 32*j + lane, j < d <= 4, of the group of rows [base, hi) of
// perm_val (at most 32 rows), in float32.
template <typename T>
__device__ __forceinline__ void load_group(const T* perm_val, long long base,
                                           long long hi, int d, int lane,
                                           float (&x)[4]) {
  const long long n = min(32LL, hi - base) * d;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < d && 32 * j + lane < n) x[j] = to_f32(perm_val[base * d + 32 * j + lane]);
}

template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
segsum_fold(const int* __restrict__ perm_seg, const T* __restrict__ perm_val,
            const int2* __restrict__ pairs,
            const int* __restrict__ counts, const long long* __restrict__ incl,
            float* __restrict__ partial, T* __restrict__ out, Plan p) {
  extern __shared__ float fold_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long P = p.piece_rows;
  long long b, lo, hi, slot;
  bool single = false;
  if (blockIdx.x < p.buckets) {              // the bucket's first piece
    b = blockIdx.x;
    const long long s = bucket_start(counts, incl, p, b);
    const long long e = bucket_end(incl, p, b);
    const long long cut = (s / P + 1) * P;
    lo = s;
    hi = min(e, cut);
    single = e <= cut;
    slot = 2 * (s / P) + 1;
  } else {                                   // a piece that starts at kP
    const long long k = blockIdx.x - p.buckets;
    lo = k * P;
    long long l = 0, r = p.buckets;          // first bucket ending past lo
    while (l < r) {
      const long long m = (l + r) / 2;
      if (bucket_end(incl, p, m) > lo) r = m; else l = m + 1;
    }
    if (l == p.buckets) return;              // past the last kept row
    b = l;
    if (bucket_start(counts, incl, p, b) == lo) return;  // its first piece
    hi = min(bucket_end(incl, p, b), lo + P);
    slot = 2 * k;
  }
  const int tf = p.tile * p.d;               // floats of a full tile
  const int wf = static_cast<int>(min(static_cast<long long>(p.tile),
                                      p.nseg - b * p.tile)) * p.d;
  T* o = out + b * tf;
  if (lo == hi) {                            // an empty bucket
    for (int e = threadIdx.x; e < wf; e += kFoldThreads) o[e] = from_f32<T>(0.0f);
    return;
  }
  for (int e = threadIdx.x; e < kFoldWarps * tf; e += kFoldThreads)
    fold_smem[e] = 0.0f;
  __syncthreads();

  // the warp's sub-range: kernels/onehot_segsum.py:warp_ranges
  const long long q = ((hi - lo + kFoldWarps - 1) / kFoldWarps + 31) / 32 * 32;
  const long long r_lo = min(hi, lo + warp * q);
  const long long r_hi = min(hi, r_lo + q);
  float* tile = fold_smem + warp * tf;
  // lanes over rows, D <= 4: a piece's warp has at most kGroups groups
  // (P <= kFoldWarps * 32 * kGroups), whose segments are loaded at once and
  // whose peers are found together.  In each group the lowest lane of each
  // segment's peers adds their rows in lane order; a row alone of its
  // segment in its group is added by its own lane.
  if (p.d <= kStagedD) {
    int sv[kGroups];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const long long row = r_lo + 32 * k + lane;
      sv[k] = row < r_hi ? (p.d == 1 ? pairs[row].x : perm_seg[row]) : -1;
    }
    unsigned pm[kGroups];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) pm[k] = static_cast<unsigned>(sv[k] + 1);
    peers_of_groups(pm, key_bits(p.tile));
    if (p.d == 1) {
      float vv[kGroups];
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        const long long row = r_lo + 32 * k + lane;
        vv[k] = row < r_hi ? __int_as_float(pairs[row].y) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        if (r_lo + 32 * k >= r_hi) break;
        const int s = sv[k];
        const unsigned peers = pm[k];
        const bool alone = peers == 1u << lane;
        if (s >= 0 && alone) tile[s] += vv[k];
        // the other rows' values come by shuffle, lane by lane in order
        const unsigned shared = __ballot_sync(kFull, s >= 0 && !alone);
        if (shared) {
          const bool lead = s >= 0 && !alone && lane == __ffs(peers) - 1;
          float acc = lead ? tile[s] : 0.0f;
          for (unsigned m = shared; m;) {    // 4 lanes a round, in order
            int j[4];
            float x[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              j[u] = m ? __ffs(m) - 1 : -1;
              m &= m - 1;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) x[u] = __shfl_sync(kFull, vv[k], j[u] & 31);
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (lead && j[u] >= 0 && (peers >> j[u] & 1u)) acc += x[u];
          }
          if (lead) tile[s] = acc;
        }
        // the next group's lanes may read or write what this one wrote
        __syncwarp();
      }
    } else {
      // the group's values staged in shared memory, the next group's loaded
      // while this one is added
      float* stage = fold_smem + kFoldWarps * tf + warp * 32 * p.d;
      float nx[4];
      load_group(perm_val, r_lo, r_hi, p.d, lane, nx);
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        const long long base = r_lo + 32 * k;
        if (base >= r_hi) break;
        const int rows = static_cast<int>(min(32LL, r_hi - base));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < p.d && 32 * j + lane < rows * p.d) stage[32 * j + lane] = nx[j];
        load_group(perm_val, base + 32, r_hi, p.d, lane, nx);
        const int s = sv[k];
        const unsigned peers = pm[k];
        __syncwarp();
        if (s >= 0 && lane == __ffs(peers) - 1) {
          float* dst = tile + s * p.d;
          for (int c = 0; c < p.d; ++c) {
            float acc = dst[c];
            for (unsigned m = peers; m; m &= m - 1)
              acc += stage[(__ffs(m) - 1) * p.d + c];
            dst[c] = acc;
          }
        }
        __syncwarp();
      }
    }
  } else {
    // lanes over channels, rows one after another
    for (long long row = r_lo; row < r_hi; ++row) {
      const T* src = perm_val + row * p.d;
      float* dst = tile + perm_seg[row] * p.d;
      for (int c = lane; c < p.d; c += 32) dst[c] += to_f32(src[c]);
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < wf; e += kFoldThreads) {
    float acc = fold_smem[e];
#pragma unroll
    for (int w = 1; w < kFoldWarps; ++w) acc += fold_smem[w * tf + e];
    if (single) o[e] = from_f32<T>(acc);
    else partial[slot * tf + e] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kPieceThreads)
segsum_pieces(const int* __restrict__ counts, const long long* __restrict__ incl,
              const float* __restrict__ partial, T* __restrict__ out, Plan p,
              int eblocks) {
  const long long b = blockIdx.x / eblocks;
  const int e = (blockIdx.x % eblocks) * kPieceThreads + threadIdx.x;
  const long long P = p.piece_rows;
  const long long s = bucket_start(counts, incl, p, b);
  const long long end = bucket_end(incl, p, b);
  const long long k0 = s / P;
  if (end <= (k0 + 1) * P) return;           // one piece: the fold wrote it
  const int tf = p.tile * p.d;
  const int wf = static_cast<int>(min(static_cast<long long>(p.tile),
                                      p.nseg - b * p.tile)) * p.d;
  if (e >= wf) return;
  // in piece order, 8 loads in flight
  float acc = partial[(2 * k0 + 1) * tf + e];
  long long k = k0 + 1;
  for (; (k + 7) * P < end; k += 8) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = partial[2 * (k + j) * tf + e];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += x[j];
  }
  for (; k * P < end; ++k) acc += partial[2 * k * tf + e];
  out[b * tf + e] = from_f32<T>(acc);
}

// Lets `Kernel` take `bytes` of dynamic shared memory: the attribute is
// raised past the default 48 KB once per card, to the largest size asked.
template <auto Kernel>
int set_smem(size_t bytes) {
  static size_t raised[64] = {};
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && raised[dev] >= bytes) return 0;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) raised[dev] = bytes;
  return static_cast<int>(err);
}

// 0 when the plan keeps every access in bounds, else cudaErrorInvalidValue.
int check_plan(const Plan& p) {
  const bool ok =
      p.n >= 0 && p.nseg >= 1 && p.d >= 1 && p.d <= kMaxChannels &&
      p.tile >= 1 && static_cast<long long>(p.tile) * p.d <= kTileFloats &&
      p.buckets == div_up(p.nseg, p.tile) && p.chunk_rows >= 1 &&
      p.chunks >= 1 && p.chunks * p.chunk_rows >= p.n &&
      p.piece_rows >= 1 && p.piece_rows <= kFoldWarps * 32 * kGroups &&
      (!p.shared || (p.buckets <= kSharedBuckets &&
                     p.chunk_rows == kChunkWarps * 32 * kGroups)) &&
      div_up(p.buckets * p.chunks, kScanItems) <= INT_MAX &&
      div_up(p.chunks, kChunkWarps) <= INT_MAX &&
      p.buckets + div_up(p.n, p.piece_rows) <= INT_MAX &&
      p.buckets * div_up(p.tile * p.d, kPieceThreads) <= INT_MAX;
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The scratch regions of one call, carved from one buffer in this order:
// counts int32 [M], incl int64 [M], the scan's status words uint64
// [ceil(M / kScanItems) + 1] (the last one its ticket), with counters in
// shared memory the warps' counts int32 [chunks, kChunkWarps, buckets],
// perm_seg int32 [N] and perm_val [N, D] of the values' type (for D = 1
// instead the records int2 [N]: local segment, value bits in float32),
// partial float32 [2 * ceil(N / P), T * D]; M = buckets * chunks.  This is
// the only statement of the layout: the wrapper asks
// onehot_segsum_scratch_bytes for the size.
struct Scratch {
  int* counts;
  long long* incl;
  unsigned long long* status;
  int* wcounts;
  int* perm_seg;
  void* perm_val;
  float* partial;
};

constexpr int kRegions = 7;

long long round_up(long long x) { return (x + kAlign - 1) / kAlign * kAlign; }

// The regions' offsets from the buffer's start; returns the bytes.
long long layout(const Plan& p, int itemsize, long long (&at)[kRegions]) {
  const long long m = p.buckets * p.chunks;
  const bool pairs = p.d == 1;               // 8-byte records instead
  const long long sizes[kRegions] = {
      4 * m, 8 * m, 8 * (div_up(m, kScanItems) + 1), p.shared ? 4 * kChunkWarps * m : 0,
      (pairs ? 8 : 4) * p.n,
      pairs ? 0 : static_cast<long long>(itemsize) * p.n * p.d,
      4 * 2 * div_up(p.n, p.piece_rows) * p.tile * p.d};
  long long off = 0;
  for (int i = 0; i < kRegions; ++i) {
    at[i] = off;
    off += round_up(sizes[i]);
  }
  return off;
}

Scratch carve(const Plan& p, int itemsize, char* base) {
  long long at[kRegions];
  layout(p, itemsize, at);
  return Scratch{reinterpret_cast<int*>(base + at[0]),
                 reinterpret_cast<long long*>(base + at[1]),
                 reinterpret_cast<unsigned long long*>(base + at[2]),
                 reinterpret_cast<int*>(base + at[3]),
                 reinterpret_cast<int*>(base + at[4]), base + at[5],
                 reinterpret_cast<float*>(base + at[6])};
}

template <typename T>
int launch(const void* values, const int* ids, const Scratch& sc, void* out,
           const Plan& p, cudaStream_t st) {
  // a block a chunk (counters in shared memory), else a warp a chunk
  const unsigned chunk_blocks = static_cast<unsigned>(
      p.shared ? p.chunks : div_up(p.chunks, kChunkWarps));
  const size_t hist_bytes = p.shared ? sizeof(int) * kChunkWarps * p.buckets : 0;
  int err = set_smem<segsum_histogram>(hist_bytes);
  if (err) return err;
  const long long m = p.buckets * p.chunks;
  const long long tiles = div_up(m, kScanItems);
  segsum_histogram<<<chunk_blocks, kChunkThreads, hist_bytes, st>>>(
      ids, sc.counts, sc.wcounts, sc.status, tiles + 1, p);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  segsum_scan<<<static_cast<unsigned>(tiles), kScanThreads, 0, st>>>(
      sc.counts, m, sc.status, sc.incl);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  const T* v = static_cast<const T*>(values);
  T* pv = static_cast<T*>(sc.perm_val);
  int2* pairs = reinterpret_cast<int2*>(sc.perm_seg);
  T* o = static_cast<T*>(out);
  if (p.shared) {
    // rows copied in 16-byte pieces where the values allow it (perm_val is
    // aligned, being scratch)
    const long long row_bytes = sizeof(T) * static_cast<long long>(p.d);
    const int row16 = row_bytes % 16 == 0 &&
        reinterpret_cast<unsigned long long>(values) % 16 == 0
        ? static_cast<int>(row_bytes / 16) : 0;
    const size_t bytes = sort_block_bytes(p.buckets);
    if ((err = set_smem<segsum_sort_block<T>>(bytes))) return err;
    segsum_sort_block<T><<<chunk_blocks, kChunkThreads, bytes, st>>>(
        v, ids, sc.counts, sc.wcounts, sc.incl, sc.perm_seg, pv, pairs, p,
        row16);
  } else {
    segsum_scatter<T><<<chunk_blocks, kChunkThreads, 0, st>>>(
        v, ids, sc.counts, sc.incl, sc.perm_seg, pv, pairs, p);
  }
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  const int tf = p.tile * p.d;
  const size_t fold_bytes =
      sizeof(float) * kFoldWarps * (tf + (p.d <= kStagedD ? 32 * p.d : 0));
  if ((err = set_smem<segsum_fold<T>>(fold_bytes))) return err;
  const long long pieces = p.buckets + div_up(p.n, p.piece_rows);
  segsum_fold<T><<<static_cast<unsigned>(pieces), kFoldThreads, fold_bytes, st>>>(
      sc.perm_seg, pv, pairs, sc.counts, sc.incl, sc.partial, o, p);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  const int eblocks = static_cast<int>(div_up(tf, kPieceThreads));
  segsum_pieces<T><<<static_cast<unsigned>(p.buckets * eblocks), kPieceThreads,
                     0, st>>>(sc.counts, sc.incl, sc.partial, o, p, eblocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan's constants, which kernels/onehot_segsum.py holds its own to
// when it binds this library: floats of a tile, channels at most, rows of a
// chunk (counters in shared memory), rows of a warp's 32-row groups, rows
// of a piece at most, warps of a fold block, buckets of shared counters.
extern "C" void onehot_segsum_constants(long long* out) {
  const long long c[7] = {kTileFloats, kMaxChannels, kChunkWarps * 32 * kGroups,
                          32 * kGroups, kFoldWarps * 32 * kGroups, kFoldWarps,
                          kSharedBuckets};
  for (int i = 0; i < 7; ++i) out[i] = c[i];
}

// The plan's fields are those of kernels/onehot_segsum.py:Plan, in order.
// Returns the bytes of scratch the call needs, or -1 for a plan the kernels
// do not take.
extern "C" long long onehot_segsum_scratch_bytes(
    long long n, long long nseg, int d, int tile, long long buckets,
    long long chunk_rows, long long chunks, long long piece_rows, int shared,
    int itemsize) {
  const Plan p{n, nseg, d, tile, buckets, chunks, chunk_rows, piece_rows,
               shared != 0};
  long long at[kRegions];
  return check_plan(p) ? -1 : layout(p, itemsize, at);
}

// values: [n, d] and out: [nseg, d], both of type `dtype` (FloatCode);
// ids: int32 [n]; scratch: `scratch_bytes` bytes, 256-byte aligned, at
// least what onehot_segsum_scratch_bytes gives.  Returns 0 or a
// cudaError_t code.  Launches on `stream`; does not synchronise or
// allocate.
extern "C" int onehot_segsum(const void* values, const int* ids, void* scratch,
                             long long scratch_bytes, void* out, long long n,
                             long long nseg, int d, int tile, long long buckets,
                             long long chunk_rows, long long chunks,
                             long long piece_rows, int shared, int dtype,
                             void* stream) {
  const Plan p{n, nseg, d, tile, buckets, chunks, chunk_rows, piece_rows,
               shared != 0};
  int err = check_plan(p);
  if (err) return err;
  const int itemsize = dtype == kF32 ? 4 : 2;
  long long at[kRegions];
  if (layout(p, itemsize, at) > scratch_bytes ||
      reinterpret_cast<unsigned long long>(scratch) % kAlign)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch sc = carve(p, itemsize, static_cast<char*>(scratch));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLOAT_DISPATCH(dtype, T, {
    return launch<T>(values, ids, sc, out, p, st);
  });
  return 0;
}
