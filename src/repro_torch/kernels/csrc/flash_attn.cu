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
// the kv heads.  out [B, Sq, Hq, Dh] is written contiguous by the caller's
// strides.
//
// Design: block (q tile, head, batch) with 256 threads holds 64 query rows,
// four threads a row; a thread keeps the row's q and acc for its quarter of
// Dh in registers (dims 4t + 16i .. +3, so the quad's four float4 reads of
// a shared-memory row are 64 consecutive bytes).  Key tiles of BK rows of k
// and v are staged in shared memory as float32 (zero beyond Dh and Sk).
// Per tile: scores by quad dot products (two shuffles), one max, one
// rescale, then acc += p v.  Tiles wholly above the causal diagonal or
// below the window are never loaded.  Dh <= 256.
//
// Bound on this card: operations.  4 * Dh flops for every (query, key) pair
// the mask lets through, against 989 TFLOP/s of bf16 on the tensor cores.
// This first kernel runs on the CUDA cores in float32 (67 TFLOP/s at most),
// with one shared-memory float4 load for every four multiply-adds, so it
// stays far from that bound; wgmma tiles are later work.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

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
