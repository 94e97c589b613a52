// One synchronous half-sweep of the dense scan's local move
// (repro_torch/core/local_move.py:_half_sweep_dense), in two launches.
//
// The plain version takes dozens of PyTorch operations a half-sweep (a
// stable sort of the edges by cell (src, C[dst]), an in-order segment sum
// into the [nv, nv] cells, Eq.-2 scoring, row reductions, the Sigma
// recompute), each a launch that costs more host time than a small
// graph's whole work.  Here:
//
// dense_rows: a block takes vertex rows i = blockIdx.x, blockIdx.x +
//   gridDim.x, ...  One thread folds the row's edges in index order into
//   per-community accumulators (two [nv] float rows: in shared memory, a
//   block a row, up to MAX_NV; past it in the block's slice of a global
//   scratch, a grid of one block a scratch slice walking the rows), from
//   +0.0 (true and anchored K_{i->c}): the same adds, in the same order,
//   as the plain version's in-order segment sums over the cells of its
//   stable sort.  Then the block scores every cell by paper Eq. 2 with the plain
//   version's float32 operations one by one (no contraction), and reduces
//   the row: want (a NaN-propagating max of the scores of the cells with
//   weight), best (the same over the candidates), c_star (the smallest
//   candidate community reaching best).
// dense_sigma: one thread a community c folds K_i over the vertices with
//   C_new[i] == c in increasing i from +0.0: the plain version's stable
//   sort by C_new and in-order segment sum.
//
// Every float result equals the plain version's bit for bit; the ±0 of
// best and want never matters (both are read only by > 0 and >=).
//
// dense_modularity (below): the loop's realized modularity in one block.
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float nan_max(float a, float b) {
  // torch.amax: NaN wins
  if (isnan(a) || isnan(b)) return __int_as_float(0x7fc00000);
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
dense_rows(const int* __restrict__ order, const int* __restrict__ row_ptr,
           const int* __restrict__ dst, const float* __restrict__ w,
           const int* __restrict__ C, const float* __restrict__ K,
           const float* __restrict__ Sigma, const float* __restrict__ two_m_p,
           const unsigned char* __restrict__ movable,
           const unsigned char* __restrict__ target_ok, int anchored, int nv,
           int* __restrict__ C_new, unsigned char* __restrict__ move,
           unsigned char* __restrict__ want, float* __restrict__ best_out,
           float* __restrict__ scratch) {
  extern __shared__ float smem[];
  float* wa = scratch == nullptr
                  ? smem
                  : scratch + 2 * static_cast<size_t>(nv) * blockIdx.x;
  float* wf = wa + nv;         // anchored K_{i->c}; wa: true K_{i->c}
  __shared__ float red_want[kThreads];
  __shared__ float red_best[kThreads];
  __shared__ int red_c[kThreads];

  const int ghost = nv - 1;
  for (int i = blockIdx.x; i < nv; i += gridDim.x) {
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
      wa[c] = 0.0f;
      wf[c] = 0.0f;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int e1 = row_ptr[i + 1];
      for (int k = row_ptr[i]; k < e1; ++k) {
        const int e = order[k];
        const int d = dst[e];
        const int c = C[d];
        const float we = w[e];
        const bool not_self = d != i;
        const float a = not_self ? we : 0.0f;
        const float f =
            anchored ? ((not_self && !movable[d]) ? we : 0.0f) : a;
        wa[c] = __fadd_rn(wa[c], a);
        wf[c] = __fadd_rn(wf[c], f);
      }
    }
    __syncthreads();

    const float two_m = *two_m_p;
    const float two_m2 = __fmul_rn(two_m, two_m);
    const int ci = C[i];
    const float k_own = wa[ci];
    const float ki = K[i];
    const float ki2 = __fmul_rn(2.0f, ki);
    const float sig_d = Sigma[ci];
    const bool row_ok = i < ghost && movable[i];
    const float neg = -INFINITY;
    float m_want = neg, m_best = neg;
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
      const bool geom = i < ghost && c < ghost && c != ci;
      if (!geom) continue;
      // 2.0 * (W - K_own) / two_m - 2.0 * Ki * (Ki + Sigma_c - Sigma_d)
      //   / (two_m * two_m), one rounding an operation, as the plain version
      const float t =
          __fdiv_rn(__fmul_rn(2.0f, __fsub_rn(wa[c], k_own)), two_m);
      const float u = __fdiv_rn(
          __fmul_rn(ki2, __fsub_rn(__fadd_rn(ki, Sigma[c]), sig_d)), two_m2);
      const float dq = __fsub_rn(t, u);
      if (wa[c] > 0.0f) m_want = nan_max(m_want, dq);
      const bool cand = row_ok && wf[c] > 0.0f &&
                        (target_ok == nullptr || target_ok[c]);
      if (cand) m_best = nan_max(m_best, dq);
    }
    red_want[threadIdx.x] = m_want;
    red_best[threadIdx.x] = m_best;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) {
        red_want[threadIdx.x] =
            nan_max(red_want[threadIdx.x], red_want[threadIdx.x + s]);
        red_best[threadIdx.x] =
            nan_max(red_best[threadIdx.x], red_best[threadIdx.x + s]);
      }
      __syncthreads();
    }
    const float best = red_best[0];

    // c_star: the smallest candidate whose score reaches best
    int c_min = INT_MAX;
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
      const bool geom = i < ghost && c < ghost && c != ci;
      const bool cand = geom && row_ok && wf[c] > 0.0f &&
                        (target_ok == nullptr || target_ok[c]);
      if (!cand) continue;
      const float t =
          __fdiv_rn(__fmul_rn(2.0f, __fsub_rn(wa[c], k_own)), two_m);
      const float u = __fdiv_rn(
          __fmul_rn(ki2, __fsub_rn(__fadd_rn(ki, Sigma[c]), sig_d)), two_m2);
      const float dq = __fsub_rn(t, u);
      if (dq >= best && c < c_min) c_min = c;
    }
    red_c[threadIdx.x] = c_min;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s)
        red_c[threadIdx.x] = min(red_c[threadIdx.x], red_c[threadIdx.x + s]);
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const int c_star = red_c[0];
      const bool mv = best > 0.0f && c_star < ghost;
      move[i] = mv;
      C_new[i] = i == ghost ? ghost : (mv ? c_star : ci);
      want[i] = red_want[0] > 0.0f;
      best_out[i] = best;
    }
    __syncthreads();             // the next row reuses the rows and buffers
  }
}

__global__ void __launch_bounds__(kThreads)
dense_sigma(const int* __restrict__ C_new, const float* __restrict__ K,
            int nv, float* __restrict__ Sigma_new) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nv) return;
  float acc = 0.0f;
  for (int i = 0; i < nv; ++i)
    if (C_new[i] == c) acc = __fadd_rn(acc, K[i]);
  Sigma_new[c] = acc;
}

// The realized modularity of the dense scan's sweep loop
// (core/local_move.py:realized_modularity) in one block: the two flat sums
// of ops.sum_inorder, each a tree of in-order folds of 1,024 consecutive
// values from +0.0, level after level until one value is left, over the
// masked weights w_in (an edge's weight where both ends share a
// community) and over Sigma^2; then internal / 2m - sig2 / (2m * 2m).
constexpr int kFlat = 1024;      // ops.FLAT_CHUNK
constexpr int kFlatThreads = 1024;

__device__ float fold_tree(const int* src, const int* dst, const float* w,
                           const int* C, const float* sig, long long n,
                           float* buf) {
  // level 0 folds the leaves (computed on the fly) into buf[0, n1)
  long long n1 = (n + kFlat - 1) / kFlat;
  if (n1 < 1) n1 = 1;
  for (long long j = threadIdx.x; j < n1; j += blockDim.x) {
    float acc = 0.0f;
    const long long e1 = min(n, (j + 1) * kFlat);
    for (long long e = j * kFlat; e < e1; ++e) {
      float v;
      if (sig != nullptr) {
        v = __fmul_rn(sig[e], sig[e]);
      } else {
        v = C[src[e]] == C[dst[e]] ? w[e] : 0.0f;
      }
      acc = __fadd_rn(acc, v);
    }
    buf[j] = acc;
  }
  __syncthreads();
  float* cur = buf;
  float* nxt = buf + n1;
  long long m = n1;
  while (m > 1) {
    const long long mn = (m + kFlat - 1) / kFlat;
    for (long long j = threadIdx.x; j < mn; j += blockDim.x) {
      float acc = 0.0f;
      const long long e1 = min(m, (j + 1) * kFlat);
      for (long long e = j * kFlat; e < e1; ++e) acc = __fadd_rn(acc, cur[e]);
      nxt[j] = acc;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    m = mn;
  }
  return cur[0];
}

__global__ void __launch_bounds__(kFlatThreads)
dense_modularity_kernel(const int* src, const int* dst, const float* w,
                        const int* C, const float* Sigma,
                        const float* two_m_p, long long m, int nv,
                        float* scratch, long long scratch_half,
                        float* q_out) {
  const float internal = fold_tree(src, dst, w, C, nullptr, m, scratch);
  __syncthreads();
  const float sig2 = fold_tree(nullptr, nullptr, nullptr, nullptr, Sigma,
                               nv, scratch + scratch_half);
  if (threadIdx.x == 0) {
    const float two_m = *two_m_p;
    *q_out = __fsub_rn(__fdiv_rn(internal, two_m),
                       __fdiv_rn(sig2, __fmul_rn(two_m, two_m)));
  }
}

}  // namespace

// scratch: at least 2 * (the level-0 chunks of max(m, nv)) floats
extern "C" int dense_modularity(const int* src, const int* dst,
                                const float* w, const int* C,
                                const float* Sigma, const float* two_m,
                                long long m, int nv, float* scratch,
                                long long scratch_half, float* q_out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dense_modularity_kernel<<<1, kFlatThreads, 0, s>>>(
      src, dst, w, C, Sigma, two_m, m, nv, scratch, scratch_half, q_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dense_half_sweep(const int* order, const int* row_ptr,
                                const int* dst, const float* w, const int* C,
                                const float* K, const float* Sigma,
                                const float* two_m,
                                const unsigned char* movable,
                                const unsigned char* target_ok, int anchored,
                                int nv, int* C_new, unsigned char* move,
                                unsigned char* want, float* best,
                                float* Sigma_new, float* scratch,
                                int scratch_blocks, void* stream) {
  // scratch: nullptr for nv <= MAX_NV (the rows in shared memory), else
  // 2 * nv * scratch_blocks floats, a slice for each block of the grid
  if (nv <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t smem = 0;
  int grid = nv;
  if (scratch == nullptr) {
    smem = 2 * static_cast<size_t>(nv) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          dense_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  } else if (grid > scratch_blocks) {
    grid = scratch_blocks;
  }
  dense_rows<<<grid, kThreads, smem, s>>>(order, row_ptr, dst, w, C, K,
                                          Sigma, two_m, movable, target_ok,
                                          anchored, nv, C_new, move, want,
                                          best, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_sigma<<<(nv + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      C_new, K, nv, Sigma_new);
  return static_cast<int>(cudaGetLastError());
}
