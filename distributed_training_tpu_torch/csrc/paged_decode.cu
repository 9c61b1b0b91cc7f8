// Paged single-token decode attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU Pallas paged-attention kernel that distributed_training_
// tpu/ops/paged_attention.py::paged_attention dispatches to (JAX's stock
// jax.experimental.pallas.ops.tpu.paged_attention): one query token per
// sequence, q (B, H, hd), attending the first lengths[b] positions of that
// sequence in a paged pool k/v (Hkv, N, ps, hd) through its page-table row
// page_indices[b] (P entries); GQA with H / Hkv query heads per kv head;
// f32 logits and softmax, output (B, H, hd) in q's type; a length-0 row
// gives zeros.
//
// Design. One block per (kv head, sequence) walks the sequence's positions
// in tiles of TK tokens: each tile's K and V rows are gathered through the
// page table into shared memory as f32 (any page size: position p lives in
// slot p % ps of page page_indices[p / ps]), the logits of all the group's
// query heads are computed against the tile, one warp per head keeps that
// head's running max and sum, and the f32 accumulator (group heads x hd)
// lives in shared memory. Page ids are clamped into the pool, so a bad table
// reads wrong rows instead of faulting.
//
// What bounds it: decode reads every cached K/V byte once and does ~4 flops
// per byte, far below the card's ridge, so the bound is memory bandwidth.
// This first kernel is latency-bound instead: one block per (sequence, kv
// head) gives B * Hkv blocks (96 at the serving geometry, fewer than the
// 132 SMs) and each walks its tiles in order. Splitting a long sequence's
// pages over several blocks with a second combine pass (split-K, as
// FlashDecoding does), and vectorised loads, are the later steps (ROADMAP.md
// queue B).

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* lengths;
  const int* page_indices;
  void* out;
  int B, H, Hkv, N, ps, hd, P;
  float scale;
  cudaStream_t stream;
};

template <int TK>
size_t smem_bytes(int G, int hd) {
  return sizeof(float) * ((size_t)TK * (hd + 1) + (size_t)TK * hd + (size_t)G * hd +
                          (size_t)G * TK + (size_t)G * hd + (size_t)G * 3);
}

template <typename T, int TK>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ lengths,
                    const int* __restrict__ page_indices, T* __restrict__ out,
                    int H, int Hkv, int N, int ps, int hd, int P, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int ldk = hd + 1;
  float* ks = smem;                 // [TK][hd + 1]
  float* vs = ks + TK * ldk;        // [TK][hd]
  float* qs = vs + TK * hd;         // [G][hd]
  float* sc = qs + G * hd;          // [G][TK] logits, then weights
  float* acc = sc + G * TK;         // [G][hd]
  float* stat = acc + G * hd;       // [G][3]: running max, sum, rescale

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = kThreads / 32;
  const int len = max(0, min(lengths[b], P * ps));
  const int* table = page_indices + (size_t)b * P;
  const T* qb = q + ((size_t)b * H + (size_t)hk * G) * hd;
  const size_t head_off = (size_t)hk * N * ps * hd;

  for (int i = tid; i < G * hd; i += kThreads) {
    qs[i] = dtt::to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    stat[3 * g] = -INFINITY;
    stat[3 * g + 1] = 0.f;
    stat[3 * g + 2] = 1.f;
  }

  for (int t0 = 0; t0 < len; t0 += TK) {
    const int n = min(TK, len - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < n * hd; i += kThreads) {
      const int tt = i / hd, c = i % hd;
      const int pos = t0 + tt;
      const int page = min(max(table[pos / ps], 0), N - 1);
      const size_t off = head_off + ((size_t)page * ps + pos % ps) * hd + c;
      ks[tt * ldk + c] = dtt::to_f32(k_pages[off]);
      vs[tt * hd + c] = dtt::to_f32(v_pages[off]);
    }
    __syncthreads();
    for (int i = tid; i < G * TK; i += kThreads) {
      const int g = i / TK, tt = i % TK;
      float s = -INFINITY;
      if (tt < n) {
        const float* qg = qs + g * hd;
        const float* kr = ks + tt * ldk;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qg[d] * kr[d];
        s = dot * scale;
      }
      sc[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += nwarps) {
      float* sg = sc + g * TK;
      float mx = -INFINITY;
      for (int tt = lane; tt < TK; tt += 32) mx = fmaxf(mx, sg[tt]);
      mx = dtt::warp_max(mx);
      const float m_old = stat[3 * g];
      const float m_new = fmaxf(m_old, mx);  // finite: the tile has n >= 1 keys
      float sum = 0.f;
      for (int tt = lane; tt < TK; tt += 32) {
        const float p = (tt < n) ? expf(sg[tt] - m_new) : 0.f;
        sg[tt] = p;
        sum += p;
      }
      sum = dtt::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        stat[3 * g] = m_new;
        stat[3 * g + 1] = stat[3 * g + 1] * alpha + sum;
        stat[3 * g + 2] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, c = i % hd;
      const float* pg = sc + g * TK;
      float a = acc[i] * stat[3 * g + 2];
      for (int tt = 0; tt < n; ++tt) a += pg[tt] * vs[tt * hd + c];
      acc[i] = a;
    }
  }
  __syncthreads();
  T* ob = out + ((size_t)b * H + (size_t)hk * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    const float l = stat[3 * (i / hd) + 1];
    dtt::store(ob + i, l > 0.f ? acc[i] / l : 0.f);
  }
}

template <typename T, int TK>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes<TK>(a.H / a.Hkv, a.hd);
  cudaError_t err = dtt::allow_smem(paged_decode_kernel<T, TK>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hkv, a.B);
  paged_decode_kernel<T, TK><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
      static_cast<const T*>(a.v_pages), a.lengths, a.page_indices,
      static_cast<T*>(a.out), a.H, a.Hkv, a.N, a.ps, a.hd, a.P, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(const Args& a) {
  if (a.hd <= 128) return launch<T, 64>(a);
  if (a.hd <= 256) return launch<T, 32>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, H, hd); k_pages/v_pages (Hkv, N, ps, hd); out (B, H, hd), all
// contiguous and of type dtype; lengths (B,) and page_indices (B, P) int32.
// Returns the cudaError_t of the launch (0 = launched).
int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const void* lengths, const void* page_indices, void* out,
                 int B, int H, int Hkv, int N, int ps, int hd, int P,
                 float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || N <= 0 || ps <= 0 || hd <= 0 ||
      P <= 0)
    return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, static_cast<const int*>(lengths),
               static_cast<const int*>(page_indices), out, B, H, Hkv, N, ps, hd,
               P, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == dtt::kF32) return static_cast<int>(by_head_dim<float>(a));
  if (dtype == dtt::kBF16) return static_cast<int>(by_head_dim<__nv_bfloat16>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
