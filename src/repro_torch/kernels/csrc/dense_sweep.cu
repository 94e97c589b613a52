// The dense scan's half-sweep and realized modularity on the card, bit for
// bit their plain versions (repro_torch/core/local_move.py:
// _half_sweep_dense_plain and realized_modularity).  Neither replaces a TPU
// kernel: the reference runs both as XLA code (src/repro/core/local_move.py:
// _half_sweep_dense at :361, realized_modularity at :124).  The plain
// versions take dozens of PyTorch launches each, and on a small graph every
// launch costs more host time than the work (ROADMAP C.12).
//
// What bounds them on this card.  At the dense scan's sizes (nv <= 1025,
// m <= 16,384) the bytes take well under a microsecond, so each kernel is
// bound by its longest chain of dependent steps and by launch latency.  The
// contract fixes the chains: every float sum is a fold in index order from
// +0.0 with __fadd_rn, no float atomics, no contraction, so the longest fold
// (4 cycles an add) is a floor no design can go under.  The design keeps
// every other step off that chain:
//
// dense_half_sweep, two launches.
//   dense_rows: a warp a vertex row (kWarps rows a block).  The lanes gather
//     a tile of 32 of the row's edges at once (order -> dst -> C, w,
//     movable), stage (a, f) in shared memory, and group the tile by
//     community with __match_any_sync; the group's first lane folds the
//     group's values in lane (= index) order onto the community's
//     accumulators.  So each fold is the plain version's run sum of that
//     cell, from +0.0, and its chain is the cell's edge count.  The
//     accumulators are direct-mapped by community ([nv] floats twice, in a
//     slice of shared memory a warp, or past MAX_NV of a global scratch), with
//     a tag a community: 2i marks a cell row i has reached, 2i + 1 a cell it
//     has scored, so no row zeroes or walks all nv columns; a warp sets its
//     tags to -1 once.  A second pass over the row's edges scores each
//     reached community once (the lane that turns its tag from 2i to 2i + 1)
//     by paper Eq. 2 in the plain version's float32 operations one by one,
//     and warp shuffles reduce want (some score > 0 and no NaN), best (a
//     NaN-propagating max) and c_star (the smallest community reaching best).
//     The ghost row is not folded: no cell of it is ever scored.
//   dense_sigma: one block recomputes Sigma without a sort.  Its warps
//     group every 32-vertex window by community at once (__match_any_sync)
//     and stage C_new and K in shared memory; then one warp walks the
//     windows in increasing id, and each group's first lane folds its
//     members' K in id order onto the community's accumulator (from +0.0):
//     the plain version's stable sort by C_new and in-order segment sum.
//     Its chain: the largest community's adds, over nv / 32 windows of one
//     accumulator read and write each.  (A walk that grouped each window
//     on its way, by __match_any_sync or by integer lane masks, and a
//     bitonic sort of (C_new, id) keys were slower on the card: their
//     matches, atomics and barriers sat on the chain.)
// dense_modularity, one launch: both ops.sum_inorder trees at once, a block
//   a 1,024-value leaf chunk of either tree.  A block's threads compute its
//   chunk's values with coalesced loads (the masked weight C[src] == C[dst]
//   ? w : 0, or Sigma * Sigma), stage them in shared memory, and one thread
//   folds them in order.  The last block to finish, found by an integer
//   ticket in the launch's own scratch (zeroed on the stream by its
//   launcher), folds the upper levels and writes internal / 2m - sig2 /
//   (2m * 2m).  Its chain: the leaf fold's 1,024 adds and the upper levels'.
//
// The graph axis (the batched engine's tile): every kernel takes graphs >= 1
// graphs of nv vertex slots each, laid out as one union (graph g's vertex i
// is slot g * nv + i, its community ids in its own slots, its ghost at its
// local nv - 1).  dense_rows runs a warp a row over the union's graphs * nv
// rows, each row reading its own graph's 2m and Sigma and folding onto its
// local community columns; dense_sigma is a block a graph; the modularity
// takes each graph's leaf chunks of both trees (a 2-D grid, a row a graph)
// and a ticket a graph.  The fold order inside each graph is the one above,
// so each graph's outputs are the bits of its launch alone.  graphs = 1
// takes the rows and modularity kernels' instances compiled without the
// graph axis (kTile false): the single-graph code.
//
// Every float result equals the plain version's bit for bit; the ±0 of best
// and want never matters (both are read only by > 0 and >=).
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kWarps = 4;                 // rows in flight a block
constexpr int kRowThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// --- dense_rows: a warp a vertex row ------------------------------------

// kTile: rows of graphs > 1 (each its graph's 2m, base and ghost); else
// one graph's, with its 2m read once
template <bool kTile>
__global__ void __launch_bounds__(kRowThreads)
dense_rows(const int* __restrict__ order, const int* __restrict__ row_ptr,
           const int* __restrict__ dst, const float* __restrict__ w,
           const int* __restrict__ C, const float* __restrict__ K,
           const float* __restrict__ Sigma, const float* __restrict__ two_m_p,
           const unsigned char* __restrict__ movable,
           const unsigned char* __restrict__ target_ok, int anchored, int nv,
           int graphs, int* __restrict__ C_new,
           unsigned char* __restrict__ move,
           unsigned char* __restrict__ want, float* __restrict__ best_out,
           float* __restrict__ scratch) {
  extern __shared__ float smem[];
  __shared__ float s_a[kWarps][32];
  __shared__ float s_f[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + warp;
  const int nwarps = gridDim.x * kWarps;
  // this warp's accumulators: true and anchored K_{i->c}, and the tags
  float* wa = scratch == nullptr
                  ? smem + 3 * static_cast<size_t>(nv) * warp
                  : scratch + 3 * static_cast<size_t>(nv) * gwarp;
  float* wf = wa + nv;
  int* tag = reinterpret_cast<int*>(wf + nv);
  for (int c = lane; c < nv; c += 32) tag[c] = -1;
  __syncwarp();

  const float two_m0 = *two_m_p;
  const int rows = kTile ? nv * graphs : nv;
  for (int i = gwarp; i < rows; i += nwarps) {
    // row i of graph g: its own 2m, ghost and local community columns
    const int g = kTile ? i / nv : 0;
    const int base = g * nv;
    const float two_m = kTile ? two_m_p[g] : two_m0;
    const float two_m2 = __fmul_rn(two_m, two_m);
    const int ghost = base + nv - 1;
    if (i == ghost) {            // no cell of the ghost row is scored
      if (lane == 0) {
        move[i] = 0;
        C_new[i] = ghost;
        want[i] = 0;
        best_out[i] = -INFINITY;
      }
      continue;
    }
    const int e0 = row_ptr[i];
    const int e1 = row_ptr[i + 1];
    const int reached = 2 * i;
    const int scored = 2 * i + 1;

    // pass 1: fold the row's edges, a tile of 32 at a time, onto their
    // communities in index order
    for (int k0 = e0; k0 < e1; k0 += 32) {
      const int k = k0 + lane;
      int c = -1;
      float a = 0.0f, f = 0.0f;
      if (k < e1) {
        const int e = order[k];
        const int d = dst[e];
        const float we = w[e];
        const bool not_self = d != i;
        c = C[d] - base;
        a = not_self ? we : 0.0f;
        f = anchored ? ((not_self && !movable[d]) ? we : 0.0f) : a;
      }
      s_a[warp][lane] = a;
      s_f[warp][lane] = f;
      const unsigned peers = __match_any_sync(kFull, c);
      __syncwarp();
      if (c >= 0 && (peers & ((1u << lane) - 1u)) == 0) {
        float acc_a = 0.0f, acc_f = 0.0f;   // a cell first reached: +0.0
        if (tag[c] == reached) {
          acc_a = wa[c];
          acc_f = wf[c];
        } else {
          tag[c] = reached;
        }
        for (unsigned p = peers; p != 0; p &= p - 1) {
          const int l = __ffs(p) - 1;
          acc_a = __fadd_rn(acc_a, s_a[warp][l]);
          acc_f = __fadd_rn(acc_f, s_f[warp][l]);
        }
        wa[c] = acc_a;
        wf[c] = acc_f;
      }
      __syncwarp();
    }

    const int ci = C[i];
    const float k_own = tag[ci - base] == reached ? wa[ci - base] : 0.0f;
    __syncwarp();                // before any tag turns to `scored`

    // pass 2: score each reached community once (paper Eq. 2)
    const float ki = K[i];
    const float ki2 = __fmul_rn(2.0f, ki);
    const float sig_d = Sigma[ci];
    const bool row_ok = movable[i] != 0;
    bool want_pos = false, want_nan = false, best_nan = false;
    float bv = -INFINITY;
    int bc = INT_MAX;
    for (int k = e0 + lane; k < e1; k += 32) {
      const int c = C[dst[order[k]]];
      const int cl = c - base;
      if (atomicCAS(&tag[cl], reached, scored) != reached) continue;
      if (c >= ghost || c == ci) continue;
      const float W = wa[cl];
      // 2.0 * (W - K_own) / two_m - 2.0 * Ki * (Ki + Sigma_c - Sigma_d)
      //   / (two_m * two_m), one rounding an operation, as the plain version
      const float t = __fdiv_rn(__fmul_rn(2.0f, __fsub_rn(W, k_own)), two_m);
      const float u = __fdiv_rn(
          __fmul_rn(ki2, __fsub_rn(__fadd_rn(ki, Sigma[c]), sig_d)), two_m2);
      const float dq = __fsub_rn(t, u);
      if (W > 0.0f) {
        want_nan |= isnan(dq);
        want_pos |= dq > 0.0f;
      }
      if (row_ok && wf[cl] > 0.0f && (target_ok == nullptr || target_ok[c])) {
        if (isnan(dq)) {
          best_nan = true;
        } else if (dq > bv || (dq == bv && c < bc)) {
          bv = dq;
          bc = c;
        }
      }
    }
    // (best, c_star): the largest score, then the smallest community
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oc = __shfl_xor_sync(kFull, bc, o);
      if (ov > bv || (ov == bv && oc < bc)) {
        bv = ov;
        bc = oc;
      }
    }
    want_pos = __any_sync(kFull, want_pos);
    want_nan = __any_sync(kFull, want_nan);
    best_nan = __any_sync(kFull, best_nan);
    if (lane == 0) {
      const float best = best_nan ? __int_as_float(0x7fc00000) : bv;
      const int c_star = best_nan ? INT_MAX : bc;
      const bool mv = best > 0.0f && c_star < ghost;
      move[i] = mv;
      C_new[i] = mv ? c_star : ci;
      want[i] = want_pos && !want_nan;
      best_out[i] = best;
    }
    __syncwarp();
  }
}

// --- dense_sigma: Sigma by community, each folded in vertex order --------

constexpr int kSigmaThreads = 1024;

// kShared: everything in shared memory (the pointers are known to be
// shared, so the walk's loads and stores are shared-memory instructions);
// else acc and grp in the global scratch
template <bool kShared>
__global__ void __launch_bounds__(kSigmaThreads)
dense_sigma(const int* __restrict__ C_new, const float* __restrict__ K,
            int nv, float* __restrict__ Sigma_new, float* scratch) {
  // block g: graph g's slots, its communities by local id
  const int base = blockIdx.x * nv;
  C_new += base;
  K += base;
  Sigma_new += base;
  if (scratch != nullptr) scratch += 2 * static_cast<size_t>(nv) * blockIdx.x;
  // acc[c]: Sigma_new[c] so far; grp[i]: for the first vertex of each
  // community in its 32-vertex window, the window's lanes in that
  // community (0 for the others); cs, ks: C_new and K staged (in shared
  // memory only: past MAX_NV the walk reads them where they are)
  extern __shared__ float s_sig[];
  constexpr bool shared = kShared;
  float* acc = shared ? s_sig : scratch;
  unsigned* grp = reinterpret_cast<unsigned*>(acc + nv);
  int* cs_s = reinterpret_cast<int*>(s_sig + 2 * nv);
  float* ks_s = s_sig + 3 * nv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // every window's groups at once, a warp a window
  for (int i0 = warp * 32; i0 < nv; i0 += kSigmaThreads) {
    const int i = i0 + lane;
    const int c = i < nv ? C_new[i] - base : -1;
    const unsigned peers = __match_any_sync(kFull, c);
    if (i < nv) {
      acc[i] = 0.0f;
      grp[i] = (peers & ((1u << lane) - 1u)) == 0 ? peers : 0u;
      if (shared) {
        cs_s[i] = c;
        ks_s[i] = K[i];
      }
    }
  }
  __syncthreads();
  const float* ks = shared ? ks_s : K;
  // one warp walks the windows in increasing id: each group's first lane
  // folds its members in id order onto its community's accumulator, so
  // each Sigma folds its members in id order from +0.0; only the
  // accumulator's read, adds and write are on the chain
  if (warp == 0) {
    // past MAX_NV the walk reads C_new where it is, less the graph's base
    auto comm = [&](int j) { return shared ? cs_s[j] : C_new[j] - base; };
    unsigned peers = lane < nv ? grp[lane] : 0u;
    int c = peers != 0 ? comm(lane) : -1;
    for (int i0 = 0; i0 < nv; i0 += 32) {
      const int j = i0 + 32 + lane;       // the next window, read ahead
      const unsigned next_peers = j < nv ? grp[j] : 0u;
      const int next_c = next_peers != 0 ? comm(j) : -1;
      if (peers != 0) {
        float a = acc[c];
        for (unsigned p = peers; p != 0; p &= p - 1)
          a = __fadd_rn(a, ks[i0 + __ffs(p) - 1]);
        acc[c] = a;
      }
      __syncwarp();
      peers = next_peers;
      c = next_c;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nv; c += kSigmaThreads) Sigma_new[c] = acc[c];
}

// --- dense_modularity_kernel: both sum_inorder trees in one launch -------

constexpr int kFlat = 1024;              // ops.FLAT_CHUNK
constexpr int kQThreads = 256;

// The levels above the leaves: buf[0, n) holds the level below; each level
// folds chunks of kFlat values in order from +0.0 into the free part of
// buf, until one value is left.  Every thread of the block calls it.
__device__ float fold_levels(float* buf, long long n) {
  float* cur = buf;
  float* nxt = buf + n;
  while (n > 1) {
    const long long mn = (n + kFlat - 1) / kFlat;
    for (long long j = threadIdx.x; j < mn; j += blockDim.x) {
      float acc = 0.0f;
      const long long e1 = min(n, (j + 1) * kFlat);
      for (long long e = j * kFlat; e < e1; ++e)
        acc = __fadd_rn(acc, __ldcg(cur + e));
      nxt[j] = acc;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    n = mn;
  }
  return __ldcg(cur);
}

// Graph g is grid row blockIdx.y: its edges are [eptr[g], eptr[g + 1])
// (all m when eptr is null, one graph), its Sigma the nv values from g * nv,
// its leaf chunks of the masked weights blocks [0, n_int_g) of the row (the
// row has room for n_int, the largest graph's; the blocks past its own
// return at once and take no ticket), those of Sigma^2 the last n_sig
// blocks.  scratch: the graphs' trees (2 * scratch_half floats each), then
// a ticket a graph; q_out[g] its value.
template <bool kTile>
__global__ void __launch_bounds__(kQThreads)
dense_modularity_kernel(const int* __restrict__ src,
                        const int* __restrict__ dst,
                        const float* __restrict__ w,
                        const int* __restrict__ C,
                        const float* __restrict__ Sigma,
                        const float* __restrict__ two_m_p,
                        const int* __restrict__ eptr, long long m,
                        int nv, long long n_int, float* scratch,
                        long long scratch_half, unsigned int* tickets,
                        float* q_out) {
  __shared__ __align__(16) float vals[kFlat];
  __shared__ bool s_last;
  const int g = kTile ? blockIdx.y : 0;
  const long long e_lo = kTile ? eptr[g] : 0;
  const long long m_g = kTile ? eptr[g + 1] - e_lo : m;
  const long long n_int_g = kTile ? max((m_g + kFlat - 1) / kFlat, 1LL)
                                  : n_int;
  const bool internal = blockIdx.x < n_int;
  if (kTile && internal && blockIdx.x >= n_int_g) return;   // past its own
  const long long chunk = internal ? blockIdx.x : blockIdx.x - n_int;
  const long long n = internal ? m_g : nv;
  const long long e0 = chunk * kFlat;
  const int len = static_cast<int>(max(0LL, min(n - e0, (long long)kFlat)));
  const float* sig = Sigma + static_cast<long long>(g) * nv;
  src += e_lo;
  dst += e_lo;
  w += e_lo;
  scratch += 2 * scratch_half * g;
  for (int j = threadIdx.x; j < len; j += kQThreads) {
    const long long e = e0 + j;
    vals[j] = internal ? (C[src[e]] == C[dst[e]] ? w[e] : 0.0f)
                       : __fmul_rn(sig[e], sig[e]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // 32 values loaded ahead of their adds: only the adds are a chain
    float acc = 0.0f;
    int j = 0;
    for (; j + 32 <= len; j += 32) {
      float v[32];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 t = *reinterpret_cast<const float4*>(vals + j + 4 * q);
        v[4 * q] = t.x;
        v[4 * q + 1] = t.y;
        v[4 * q + 2] = t.z;
        v[4 * q + 3] = t.w;
      }
#pragma unroll
      for (int q = 0; q < 32; ++q) acc = __fadd_rn(acc, v[q]);
    }
    for (; j < len; ++j) acc = __fadd_rn(acc, vals[j]);
    (internal ? scratch : scratch + scratch_half)[chunk] = acc;
    __threadfence();
    const long long n_sig = gridDim.x - n_int;
    s_last = atomicAdd(&tickets[g], 1u) == n_int_g + n_sig - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long n_sig = gridDim.x - n_int;
  const float in_sum = fold_levels(scratch, n_int_g);
  const float sig2 = fold_levels(scratch + scratch_half, n_sig);
  if (threadIdx.x == 0) {
    const float two_m = two_m_p[g];
    q_out[g] = __fsub_rn(__fdiv_rn(in_sum, two_m),
                         __fdiv_rn(sig2, __fmul_rn(two_m, two_m)));
  }
}

__global__ void dense_noop() {}

// the rows kernel's dynamic shared memory above 48 KB, set once a device
int rows_smem_ready(size_t smem) {
  static size_t done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem <= 48 * 1024 || (dev < 64 && done[dev] >= smem)) return 0;
  err = cudaFuncSetAttribute(dense_rows<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dense_rows<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done[dev] = smem;
  return 0;
}

// kernels launched, counted on the host: dense_rows, dense_sigma,
// dense_modularity_kernel (the tests read them: launches a call)
long long launched[3] = {};

}  // namespace

// The launch plans come from the wrapper (kernels/dense_sweep.py:
// modularity_plan, sweep_plan), the one place that knows them.
// scratch: graphs * (2 * scratch_half + 2) floats, scratch_half at least
// twice the level-0 chunks of max(m, nv) of the largest graph: each graph's
// two trees, then a ticket a graph (zeroed here on the stream), then q_out
// may be the last graphs floats; a grid row a graph of blocks = n_int leaf
// chunks of the masked weights (the largest graph's), then those of Sigma^2;
// eptr: int32 [graphs + 1] edge offsets, or null for one graph of m edges
extern "C" int dense_modularity(const int* src, const int* dst,
                                const float* w, const int* C,
                                const float* Sigma, const float* two_m,
                                const int* eptr, long long m, int nv,
                                long long n_int, int blocks, int graphs,
                                float* scratch, long long scratch_half,
                                float* q_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* tickets = reinterpret_cast<unsigned int*>(
      scratch + 2 * scratch_half * graphs);
  cudaError_t err =
      cudaMemsetAsync(tickets, 0, sizeof(unsigned int) * graphs, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = eptr == nullptr ? dense_modularity_kernel<false>
                                 : dense_modularity_kernel<true>;
  kernel<<<dim3(blocks, graphs), kQThreads, 0, s>>>(
      src, dst, w, C, Sigma, two_m, eptr, m, nv, n_int, scratch,
      scratch_half, tickets, q_out);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[2];
  return static_cast<int>(err);
}

// scratch: nullptr where every warp's accumulators (rows_smem bytes a
// block) and Sigma's walk (sigma_smem) lie in shared memory; else 3 * nv
// floats for each of the grid's warps, then 2 * nv a graph for Sigma's
// accumulators and groups; two_m: graphs floats
extern "C" int dense_half_sweep(const int* order, const int* row_ptr,
                                const int* dst, const float* w, const int* C,
                                const float* K, const float* Sigma,
                                const float* two_m,
                                const unsigned char* movable,
                                const unsigned char* target_ok, int anchored,
                                int nv, int graphs, int* C_new,
                                unsigned char* move,
                                unsigned char* want, float* best,
                                float* Sigma_new, float* scratch, int grid,
                                int rows_smem, int sigma_smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int ret = rows_smem_ready(rows_smem);
  if (ret != 0) return ret;
  auto rows = graphs > 1 ? dense_rows<true> : dense_rows<false>;
  rows<<<grid, kRowThreads, rows_smem, s>>>(
      order, row_ptr, dst, w, C, K, Sigma, two_m, movable, target_ok,
      anchored, nv, graphs, C_new, move, want, best, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++launched[0];
  if (scratch == nullptr) {
    dense_sigma<true><<<graphs, kSigmaThreads, sigma_smem, s>>>(
        C_new, K, nv, Sigma_new, nullptr);
  } else {
    dense_sigma<false><<<graphs, kSigmaThreads, 0, s>>>(
        C_new, K, nv, Sigma_new,
        scratch + 3 * static_cast<size_t>(nv) * grid * kWarps);
  }
  err = cudaGetLastError();
  if (err == cudaSuccess) ++launched[1];
  return static_cast<int>(err);
}

// the kernels launched so far: 0 dense_rows, 1 dense_sigma, 2
// dense_modularity_kernel
extern "C" long long dense_kernel_launches(int kernel) {
  return kernel >= 0 && kernel < 3 ? launched[kernel] : -1;
}

// an empty launch: the floor under any kernel's time on this card
extern "C" int dense_noop_launch(void* stream) {
  dense_noop<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
