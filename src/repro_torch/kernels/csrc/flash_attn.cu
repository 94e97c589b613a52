// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py:flash_attention_fwd
// (body _flash_kernel): softmax(q k^T / sqrt(Dh), masked) v with an online
// softmax, float32 m, l and acc, output in q's type.  Query position qi
// sees key position kj when kj < Sk and, with `causal`, kj <= qi and, with
// a window (window >= 0), qi - kj < window.  A row that sees no key gets 0
// (the TPU kernel's guards: p = 0 off the mask, a correction of 0 while
// the running max is -inf, acc / max(l, 1e-30)).
//
// Layout: q [B, Sq, Hq, Dh] and k, v [B, Sk, Hkv, Dh], read through their
// element strides (the last dimension must be unit-stride); query head h
// reads kv head h / (Hq / Hkv), so grouped-query attention needs no copy of
// the kv heads.  out [B, Sq, Hq, Dh] is written by the caller's strides.
//
// Two kernels, chosen by the caller before launch
// (kernels/flash_attn.py:tensor_core_route), never on a failure:
//
// * flash_fwd_wgmma (flash_attention_fwd_wgmma) takes bfloat16 and float16
//   with Dh 64 or 128, 16-byte aligned base pointers and batch, sequence
//   and head strides that are multiples of 16 bytes (what TMA requires).
// * flash_fwd_kernel (flash_attention_fwd) takes everything else: float32
//   (its 2e-5 check cannot be met in TF32), other Dh up to 256, and views
//   TMA cannot read.
//
// Bound on this card: operations.  4 * Dh flops for every (query, key) pair
// the mask lets through, against 989 TFLOP/s of bf16 on the tensor cores.
// flash_fwd_wgmma issues 1.5x that work: P is split into two 16-bit parts
// (below), so the P.V product is done twice.
//
// flash_fwd_wgmma.  A block of two consumer warpgroups (256 threads) owns
// 128 query rows of one (batch, head), 64 rows per warpgroup; both share
// each K/V tile, which halves the K/V traffic and shared memory per row
// against one warpgroup a block.  Q's tile comes once by TMA; K and V tiles
// of 64 keys come by TMA (cp.async.bulk.tensor, 4-D tensor maps over
// [B, S, H, Dh] built per call from the strides) into a two-stage ring,
// each stage with an mbarrier that expects its bytes.  Thread 0 issues the
// load of tile j+1 before the block computes on tile j; the block barrier
// at the end of tile j (after wgmma.wait_group 0 in both warpgroups) frees
// its stage.  Every tile lies in shared memory in 128-byte-swizzled panels
// of 64 columns (two panels at Dh 128), the layout wgmma reads.
//   S = Q K^T is wgmma m64n64k16 with both operands from shared memory, K
// stored [keys][Dh] being K-major for this B.  S goes to log2 units in
// float32 (scale * log2 e), the running max and sum follow the accumulator
// layout (a row's 64 scores lie on the four lanes of a quad: two
// shuffles), and exp2f gives P.  O += P V is wgmma m64nDhk16 with A = P
// from registers (the f32 accumulator pairs pack into the 16-bit A
// fragment with no shuffle) and V from shared memory, MN-major (transpose
// bit set).  P rounded once to 16 bits misses the check of the output's
// bf16 rounding about tenfold, so P goes in as P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), two products into one accumulator.  The mask is
// applied only on tiles that cross the diagonal, the window's lower edge
// or Sk; keys at or beyond Sk arrive as TMA's zero fill and are masked, so
// they score nothing.  Tiles wholly above the diagonal or below the window
// are never loaded, a warpgroup skips the tiles none of its rows sees, and
// the heaviest (last causal) q tiles launch first.  O goes out by guarded
// stores from registers, masked to Sq.
//   Against the CUDA-core kernel's causes of slowness: the products run on
// the tensor cores in 16 bits (not f32 FMAs fed by one shared-memory load
// each), K and V stay 16-bit in shared memory and arrive by TMA while the
// previous tile is computed.  Later work: warp specialisation with
// setmaxnreg, ping-pong between warpgroups, overlap of softmax and MMA,
// persistent scheduling, fp8.
//
// flash_fwd_kernel.  Block (q tile, head, batch) with 256 threads holds 64
// query rows, four threads a row; a thread keeps the row's q and acc for
// its quarter of Dh in registers (dims 4t + 16i .. +3, so the quad's four
// float4 reads of a shared-memory row are 64 consecutive bytes).  Key tiles
// of BK rows of k and v are staged in shared memory as float32 (zero beyond
// Dh and Sk).  Per tile: scores by quad dot products (two shuffles), one
// max, one rescale, then acc += p v.  Tiles wholly above the causal
// diagonal or below the window are never loaded.  Dh <= 256.  It runs on
// the CUDA cores in float32 (67 TFLOP/s at most), with one shared-memory
// float4 load for every four multiply-adds.
#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 4;

struct Strides {  // in elements; the last dimension has stride 1
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides st,
                 int sq, int sk, int hq, int hkv, int dh, int causal,
                 int window, float scale) {
  constexpr int NV = DMAX / 16;  // float4 chunks a thread holds
  __shared__ float4 ks[BK][DMAX / 4];
  __shared__ float4 vs[BK][DMAX / 4];

  const int tid = threadIdx.x;
  const int t = tid & 3;
  const int q0 = blockIdx.x * kRowsPerBlock;
  const int qi = q0 + (tid >> 2);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);

  float4 qr[NV], acc[NV];
  const T* qrow = q + b * st.qb + static_cast<long long>(qi) * st.qs + h * st.qh;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d0 = 4 * (t + 4 * i);
    float e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      e[c] = (qi < sq && d0 + c < dh) ? to_f32(qrow[d0 + c]) * scale : 0.0f;
    qr[i] = make_float4(e[0], e[1], e[2], e[3]);
    acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float m = -INFINITY, l = 0.0f;

  int k_hi = sk;
  if (causal) k_hi = min(sk, q0 + kRowsPerBlock);
  int k_lo = 0;
  if (window >= 0) k_lo = max(0, q0 - window + 1);
  k_lo -= k_lo % BK;

  const T* kbase = k + b * st.kb + hk * st.kh;
  const T* vbase = v + b * st.vb + hk * st.vh;
  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    float* ksf = reinterpret_cast<float*>(ks);
    float* vsf = reinterpret_cast<float*>(vs);
    for (int idx = tid; idx < BK * DMAX; idx += kThreads) {
      const int j = idx / DMAX;
      const int d = idx - j * DMAX;
      const int kj = k0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (kj < sk && d < dh) {
        kv = to_f32(kbase[static_cast<long long>(kj) * st.ks + d]);
        vv = to_f32(vbase[static_cast<long long>(kj) * st.vs + d]);
      }
      ksf[idx] = kv;
      vsf[idx] = vv;
    }
    __syncthreads();

    float s[BK];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float p = 0.0f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 kk = ks[j][t + 4 * i];
        p = fmaf(qr[i].x, kk.x, p);
        p = fmaf(qr[i].y, kk.y, p);
        p = fmaf(qr[i].z, kk.z, p);
        p = fmaf(qr[i].w, kk.w, p);
      }
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      const int kj = k0 + j;
      const bool seen = kj < sk && (!causal || kj <= qi) &&
                        (window < 0 || qi - kj < window);
      s[j] = seen ? p : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
    const float corr = m == -INFINITY ? 0.0f : expf(m - m_safe);
    float l_tile = 0.0f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = s[j] == -INFINITY ? 0.0f : expf(s[j] - m_safe);
      l_tile += s[j];
    }
    l = l * corr + l_tile;
    m = m_new;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float4 a = acc[i];
      a.x *= corr; a.y *= corr; a.z *= corr; a.w *= corr;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float4 vv = vs[j][t + 4 * i];
        a.x = fmaf(s[j], vv.x, a.x);
        a.y = fmaf(s[j], vv.y, a.y);
        a.z = fmaf(s[j], vv.z, a.z);
        a.w = fmaf(s[j], vv.w, a.w);
      }
      acc[i] = a;
    }
  }

  if (qi >= sq) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  T* orow = o + b * st.ob + static_cast<long long>(qi) * st.os + h * st.oh;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int d0 = 4 * (t + 4 * i);
    const float e[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (d0 + c < dh) orow[d0 + c] = from_f32<T>(e[c] * inv);
  }
}

template <typename T, int DMAX, int BK>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides& st, int batch, int sq, int sk, int hq, int hkv,
           int dh, int causal, int window, float scale, cudaStream_t s) {
  dim3 grid((sq + kRowsPerBlock - 1) / kRowsPerBlock, hq, batch);
  flash_fwd_kernel<T, DMAX, BK><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, sq, sk, hq, hkv, dh,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o,
              const Strides& st, int batch, int sq, int sk, int hq, int hkv,
              int dh, int causal, int window, float scale, cudaStream_t s) {
  // shared memory: 2 * BK * DMAX * 4 bytes = 32 KB at DMAX 128 and 256
  if (dh <= 32)
    return launch<T, 32, 32>(q, k, v, o, st, batch, sq, sk, hq, hkv, dh, causal, window, scale, s);
  if (dh <= 64)
    return launch<T, 64, 32>(q, k, v, o, st, batch, sq, sk, hq, hkv, dh, causal, window, scale, s);
  if (dh <= 128)
    return launch<T, 128, 32>(q, k, v, o, st, batch, sq, sk, hq, hkv, dh, causal, window, scale, s);
  return launch<T, 256, 16>(q, k, v, o, st, batch, sq, sk, hq, hkv, dh, causal, window, scale, s);
}


// --- flash_fwd_wgmma: tensor cores, TMA-fed K/V ring -----------------------

namespace tc {

constexpr int kBK = 64;                 // keys per K/V tile
constexpr int kWGs = 2;                 // consumer warpgroups per block
constexpr int kWGRows = 64;             // query rows per warpgroup
constexpr int kRows = kWGs * kWGRows;   // query rows per block
constexpr int kThreads = 128 * kWGs;
constexpr int kPanelCols = 64;          // 16-bit columns per 128-byte panel
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-aligned base (the swizzle atom):
// Q [panel][128 rows][128 B], then two stages of K and V, each
// [panel][64 keys][128 B], then the mbarriers (Q, stage 0, stage 1).
template <int D>
struct Smem {
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kQPanel = kRows * 128;
  static constexpr int kKVPanel = kBK * 128;
  static constexpr int kTile = kPanels * kKVPanel;   // one K or V tile
  static constexpr int kStage = 2 * kTile;           // K, then V
  static constexpr int kKV = kPanels * kQPanel;
  static constexpr int kBars = kKV + 2 * kStage;
  static constexpr int kBytes = kBars + 3 * 8 + 1024;  // + alignment slack
};

template <typename T>
constexpr bool kIsBF16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the phase after `parity` to complete.  A tile arrives in
// microseconds; a wait of about 2^33 cycles (seconds) means a transfer
// that never completes, and traps (a launch failure) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 33)) __trap();
}

// One box of the 4-D map (Dh, H, S, B) at coordinates (d, h, s, b) into
// shared memory at `dst`; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(s),
      "r"(b) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving registers that an in-flight wgmma reads
// or writes across the points where this is called.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

#define WG_D32 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31" "}"
#define WG_ACC32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),  \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),  \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_D64 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63" "}"
#define WG_ACC64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),  \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),  \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),  \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),  \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),  \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),  \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// S[64 x 64] (+)= Q[64 x 16] K[64 keys x 16]^T, both K-major in shared
// memory; scale_d = 0 overwrites S.
template <typename T>
__device__ __forceinline__ void mma_qk(float (&d)[32], uint64_t da,
                                       uint64_t db, int scale_d) {
  if constexpr (kIsBF16<T>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC32(d) : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WG_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC32(d) : "l"(da), "l"(db), "r"(scale_d));
  }
}

// O[64 x D] += P[64 x 16] V[16 keys x D]: P from registers (four 32-bit
// registers of 16-bit pairs), V MN-major in shared memory (transposed B).
template <typename T, int D>
__device__ __forceinline__ void mma_pv(float (&d)[D / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  const int one = 1;
  if constexpr (D == 64 && kIsBF16<T>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(one));
  } else if constexpr (D == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(one));
  } else if constexpr (kIsBF16<T>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(one));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " WG_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(one));
  }
}

// Two floats as one register of two 16-bit values, the first in the low
// half (the A fragment's column order).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t u;
  if constexpr (kIsBF16<T>) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    memcpy(&u, &v, 4);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    memcpy(&u, &v, 4);
  }
  return u;
}

// (x0, x1) as P_hi = 16-bit(x) and P_lo = 16-bit(x - P_hi).
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  float h0, h1;
  if constexpr (kIsBF16<T>) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    memcpy(&hi, &v, 4);
    h0 = __low2float(v);
    h1 = __high2float(v);
  } else {
    const __half2 v = __floats2half2_rn(x0, x1);
    memcpy(&hi, &v, 4);
    h0 = __low2float(v);
    h1 = __high2float(v);
  }
  lo = pack2<T>(x0 - h0, x1 - h1);
}

// K and V tile of keys [k0, k0 + 64) into stage `stage`.
template <int D>
__device__ __forceinline__ void load_kv(uint32_t base, const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t bar,
                                        int stage, int k0, int hk, int b) {
  using L = Smem<D>;
  const uint32_t st = base + L::kKV + stage * L::kStage;
  mbar_expect_tx(bar, L::kStage);
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p) {
    tma_load(st + p * L::kKVPanel, tk, bar, p * kPanelCols, hk, k0, b);
    tma_load(st + L::kTile + p * L::kKVPanel, tv, bar, p * kPanelCols, hk,
             k0, b);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                long long ob, long long os, long long oh, int batch, int sq,
                int sk, int hq, int hkv, int causal, int window,
                float scale_log2) {
  using L = Smem<D>;
  constexpr int NO = D / 2;        // O accumulators a thread holds
  constexpr int NS = kBK / 2;      // S accumulators a thread holds
  constexpr int KS = kBK / 16;     // k-slices of the P V product
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_kv = bar_q + 8;       // + 8 * stage

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;           // accumulator row in the warp
  const int t = tid & 3;                   // column pair in an 8-column chunk

  // heaviest q tiles first: the block index runs over (batch, head) fastest
  const int nbh = batch * hq;
  const int blk = static_cast<int>(blockIdx.x);
  const int q0 = (static_cast<int>(gridDim.x) / nbh - 1 - blk / nbh) * kRows;
  const int h = blk % nbh % hq;
  const int b = blk % nbh / hq;
  const int hk = h / (hq / hkv);

  int k_hi = causal ? min(sk, q0 + kRows) : sk;
  int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  k_lo -= k_lo % kBK;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  // keys some row of this warpgroup sees lie in [w_lo, w_hi)
  const int qw = q0 + wg * kWGRows;
  const int w_hi = qw >= sq ? 0 : causal ? min(sk, qw + kWGRows) : sk;
  const int w_lo = window >= 0 ? max(0, qw - window + 1) : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv, 1);
    mbar_init(bar_kv + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kPanels * L::kQPanel);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      tma_load(base + p * L::kQPanel, &tq, bar_q, p * kPanelCols, h, q0, b);
    if (ntiles > 0) load_kv<D>(base, &tk, &tv, bar_kv, 0, k_lo, hk, b);
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows g and g + 8
  float l_run[2] = {0.0f, 0.0f};             // this thread's columns only
  const int row = qw + 16 * warp + g;
  const uint32_t q_wg = base + wg * (kWGRows * 128);
  mbar_wait(bar_q, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j & 1;
    const int k0 = k_lo + j * kBK;
    if (tid == 0 && j + 1 < ntiles)
      load_kv<D>(base, &tk, &tv, bar_kv + 8 * (s ^ 1), s ^ 1, k0 + kBK, hk,
                 b);
    mbar_wait(bar_kv + 8 * s, (j >> 1) & 1);
    if (k0 < w_hi && k0 + kBK > w_lo) {   // uniform across the warpgroup
      const uint32_t kst = base + L::kKV + s * L::kStage;
      float sc[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = 0.0f;
      hold(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;   // 16 columns of a panel
        mma_qk<T>(sc,
                  sw128_desc(q_wg + (kk >> 2) * L::kQPanel + off, 16, 1024),
                  sw128_desc(kst + (kk >> 2) * L::kKVPanel + off, 16, 1024),
                  kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      hold(sc);

      // accumulator element r: row `row` + 8 * ((r >> 1) & 1), key
      // k0 + 8 * (r >> 2) + 2 * t + (r & 1)
      const bool whole = k0 + kBK <= sk &&
                         (!causal || k0 + kBK - 1 <= qw) &&
                         (window < 0 || qw + kWGRows - 1 - k0 < window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int r = 0; r < NS; ++r) {
        float x = sc[r] * scale_log2;
        if (!whole) {
          const int kj = k0 + 8 * (r >> 2) + 2 * t + (r & 1);
          const int qi = row + 8 * ((r >> 1) & 1);
          const bool seen = kj < sk && (!causal || kj <= qi) &&
                            (window < 0 || qi - kj < window);
          x = seen ? x : -INFINITY;
        }
        sc[r] = x;
        mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], x);
      }
      float corr[2], m_safe[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        m_safe[i] = m_new == -INFINITY ? 0.0f : m_new;
        corr[i] = m_run[i] == -INFINITY ? 0.0f : exp2f(m_run[i] - m_safe[i]);
        m_run[i] = m_new;
        l_run[i] *= corr[i];
      }
#pragma unroll
      for (int r = 0; r < NS; ++r) {   // exp2f(-inf) = 0 off the mask
        const float p = exp2f(sc[r] - m_safe[(r >> 1) & 1]);
        sc[r] = p;
        l_run[(r >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < NO; ++r) acc[r] *= corr[(r >> 1) & 1];

      // P's A fragment for k-slice kk, register e: accumulator elements
      // 8 kk + 2 e and 8 kk + 2 e + 1 (rows g / g + 8, keys 2t / 8 + 2t)
      uint32_t p_hi[KS][4], p_lo[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split2<T>(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], p_hi[kk][e],
                    p_lo[kk][e]);
      hold(acc);
      hold(p_hi);
      hold(p_lo);
      wgmma_fence();
      const uint32_t vst = kst + L::kTile;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        // 16 keys of 128-byte rows; the next 64 columns of Dh one panel on
        const uint64_t dv = sw128_desc(vst + kk * 16 * 128, L::kKVPanel, 1024);
        mma_pv<T, D>(acc, p_hi[kk], dv);
        mma_pv<T, D>(acc, p_lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      hold(acc);
      hold(p_hi);
      hold(p_lo);
    }
    __syncthreads();   // every wgmma that read stage s has retired
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.0f / fmaxf(l, 1e-30f);
  }
  T* orow = o + b * ob + h * oh;
#pragma unroll
  for (int r = 0; r < NO; r += 2) {
    const int i = (r >> 1) & 1;
    const int qi = row + 8 * i;
    if (qi < sq) {
      const uint32_t v = pack2<T>(acc[r] * inv[i], acc[r + 1] * inv[i]);
      memcpy(orow + qi * os + 8 * (r >> 2) + 2 * t, &v, 4);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query so that the library needs no -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    return e == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D map (Dh, H, S, B) of a [B, S, H, Dh] tensor with element strides
// sb, ss, sh; boxes of 64 columns by `rows` sequence positions, swizzled
// 128 B, zero fill beyond the tensor.  A dimension of size 1 is never
// stepped, so its stride is given as Dh's row (any valid value).
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
            int dh, int heads, int seq, int batch, long long sb, long long ss,
            long long sh, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  auto bytes = [dh](long long stride, int size) {
    return static_cast<cuuint64_t>(size == 1 ? dh : stride) * 2;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {bytes(sh, heads), bytes(ss, seq),
                                 bytes(sb, batch)};
  const cuuint32_t box[4] = {kPanelCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides& st, int batch, int sq, int sk, int hq, int hkv,
           int causal, int window, float scale, cudaStream_t s) {
  const CUtensorMapDataType type = kIsBF16<T>
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, type, q, D, hq, sq, batch, st.qb, st.qs, st.qh, kRows) ||
      !encode(&mk, type, k, D, hkv, sk, batch, st.kb, st.ks, st.kh, kBK) ||
      !encode(&mv, type, v, D, hkv, sk, batch, st.vb, st.vs, st.vh, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>((sq + kRows - 1) / kRows) * hq * batch;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<D>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_wgmma<T, D><<<static_cast<unsigned>(blocks), kThreads,
                          Smem<D>::kBytes, s>>>(
      mq, mk, mv, static_cast<T*>(o), st.ob, st.os, st.oh, batch, sq, sk, hq,
      hkv, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// q, k, v, o of type `dtype` (FloatCode); strides: 12 element strides, the
// batch, sequence and head strides of q, k, v and o in that order.  window
// < 0 means no window.  Returns 0 or a cudaError_t code.  Launches on
// `stream`; does not synchronise or allocate.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const long long* strides, int batch,
                                   int sq, int sk, int hq, int hkv, int dh,
                                   int causal, int window, float scale,
                                   int dtype, void* stream) {
  if (batch == 0 || sq == 0 || hq == 0) return 0;
  if (batch < 0 || batch > 65535 || hq > 65535 || hkv < 1 || hq % hkv != 0 ||
      dh < 1 || dh > 256 || sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st{strides[0], strides[1], strides[2],  strides[3],
             strides[4], strides[5], strides[6],  strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLOAT_DISPATCH(dtype, T, {
    return launch_dh<T>(q, k, v, o, st, batch, sq, sk, hq, hkv, dh, causal,
                        window, scale, s);
  });
  return 0;
}

// The tensor-core route: the arguments of flash_attention_fwd, for
// bfloat16 or float16 with dh 64 or 128, base pointers 16-byte aligned and
// the batch, sequence and head strides of q, k and v multiples of 16 bytes
// (of dimensions longer than 1), and sk >= 1; out is written with pairs of
// elements, so its strides must be even.  Returns 0 or a cudaError_t code.
extern "C" int flash_attention_fwd_wgmma(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, int batch, int sq, int sk, int hq, int hkv,
    int dh, int causal, int window, float scale, int dtype, void* stream) {
  if (batch == 0 || sq == 0 || hq == 0) return 0;
  if (batch < 0 || hkv < 1 || hq % hkv != 0 || sk < 1 ||
      (dh != 64 && dh != 128) || (dtype != kF16 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st{strides[0], strides[1], strides[2],  strides[3],
             strides[4], strides[5], strides[6],  strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return dh == 64 ? tc::launch<__nv_bfloat16, 64>(
                          q, k, v, o, st, batch, sq, sk, hq, hkv, causal,
                          window, scale, s)
                    : tc::launch<__nv_bfloat16, 128>(
                          q, k, v, o, st, batch, sq, sk, hq, hkv, causal,
                          window, scale, s);
  return dh == 64 ? tc::launch<__half, 64>(q, k, v, o, st, batch, sq, sk, hq,
                                           hkv, causal, window, scale, s)
                  : tc::launch<__half, 128>(q, k, v, o, st, batch, sq, sk, hq,
                                            hkv, causal, window, scale, s);
}
