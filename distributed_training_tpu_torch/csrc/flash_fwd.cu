// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel distributed_training_tpu/ops/
// flash_attention.py::_fwd_kernel (launched by _flash_fwd): blockwise
// online-softmax attention over q (B, H, S, D) and k/v (B, Hkv, Sk, D),
// causal / sliding-window / non-causal, GQA by routing q-head h to kv-head
// h / (H / Hkv), f32 accumulation over f32 or bf16 operands, output in the
// input type or f32, per-row logsumexp (B, H, S) in f32, rows with no live
// key written as zeros.
//
// Design. One block per (q-tile of kBQ rows, head, batch); a loop over
// k-tiles inside the block takes the place of the TPU grid's sequential
// nk axis, and the loop bounds skip every tile the causal/window band
// cannot reach (the TPU kernel's _block_needed), so causal attention does
// about half the work and windowed attention O(S * window). Four adjacent
// threads share one query row: each holds a quarter of the row's output
// accumulator and of the row's logits per tile in registers, and the row's
// running max and sum are reduced with warp shuffles. K and V tiles are
// staged in shared memory as f32 (rows padded by one word so the threads
// of a warp hit distinct banks).
//
// What bounds it: at the serving shapes (D = 64) the work is
// 4 * S^2 * D * H * B / 2 flops against S * D * H * B * 8 bytes, well above
// the card's ridge, so the bound is the tensor-core rate. This first
// kernel multiplies with f32 FMAs from shared memory and is bound by
// shared-memory bandwidth instead: wgmma with TMA-fed tiles is the later
// step (ROADMAP.md queue B).

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowThreads = 4;                  // threads sharing a query row
constexpr int kBQ = kThreads / kRowThreads;     // query rows per block (64)
constexpr float kNoKeyLse = -1e30f;             // lse of a row with no live key

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, Hkv, S, Sk, D, causal, window, block_k;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename TO, int BK, int MAXJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, TO* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int S, int Sk, int D,
                 int causal, int window, float scale) {
  constexpr int NC = BK / kRowThreads;  // logits per thread per k-tile
  extern __shared__ float smem[];
  const int ld = D + 1;                 // padded row stride of qs / ks
  constexpr int ldp = BK + 1;
  float* qs = smem;                     // [kBQ][D + 1]
  float* ks = qs + kBQ * ld;            // [BK][D + 1]
  float* vs = ks + BK * ld;             // [BK][D]
  float* ps = vs + BK * D;              // [kBQ][BK + 1] softmax weights

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* qb = q + (size_t)(b * H + h) * S * D;
  const T* kb = k + (size_t)(b * Hkv + hk) * Sk * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * Sk * D;

  const int tid = threadIdx.x;
  const int r = tid / kRowThreads;      // query row within the tile
  const int part = tid % kRowThreads;   // this thread's share of the row
  const int row = q0 + r;               // absolute query position

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, c = i % D;
    qs[rr * ld + c] = (q0 + rr < S) ? dtt::to_f32(qb[(size_t)(q0 + rr) * D + c]) : 0.f;
  }

  float acc[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) acc[j] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  // Key range any row of this tile can see.
  int k_lo = 0, k_hi = Sk;
  if (causal) {
    k_hi = min(Sk, q0 + kBQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int t_hi = (k_hi + BK - 1) / BK;

  for (int t = k_lo / BK; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done with ks/vs
    for (int i = tid; i < BK * D; i += kThreads) {
      const int rr = i / D, c = i % D;
      const bool in = k0 + rr < Sk;
      const size_t g = (size_t)(k0 + rr) * D + c;
      ks[rr * ld + c] = in ? dtt::to_f32(kb[g]) : 0.f;
      vs[rr * D + c] = in ? dtt::to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = 0.f;
    const float* qrow = qs + r * ld;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < NC; ++j) s[j] += qd * ks[(part + kRowThreads * j) * ld + d];
    }
    float mloc = -INFINITY;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = k0 + part + kRowThreads * j;
      bool live = col < Sk && row < S;
      if (causal) {
        live = live && col <= row;
        if (window > 0) live = live && col >= row - window + 1;
      }
      s[j] = live ? s[j] * scale : -INFINITY;
      mloc = fmaxf(mloc, s[j]);
    }
    // The row's threads are adjacent lanes of one warp.
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m, mloc);
    // m_new == -inf: no live key seen yet; weights stay zero.
    const float alpha = (m_new == -INFINITY) ? 1.f : expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float p = (s[j] == -INFINITY) ? 0.f : expf(s[j] - m_new);
      lsum += p;
      ps[r * ldp + part + kRowThreads * j] = p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l = l * alpha + lsum;
    m = m_new;
    __syncwarp();  // the row's weights, written by its own warp

    const float* prow = ps + r * ldp;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = prow[kk];
      const float* vrow = vs + kk * D;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int c = part + kRowThreads * j;
        if (c < D) acc[j] += p * vrow[c];
      }
    }
  }

  if (row < S) {
    const bool has = l > 0.f;
    TO* orow = o + ((size_t)(b * H + h) * S + row) * D;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int c = part + kRowThreads * j;
      if (c < D) dtt::store(orow + c, has ? acc[j] / l : 0.f);
    }
    if (part == 0) lse[(size_t)(b * H + h) * S + row] = has ? m + logf(l) : kNoKeyLse;
  }
}

template <typename T, typename TO, int BK, int MAXJ>
cudaError_t launch(const Args& a) {
  const size_t smem = sizeof(float) *
                      ((size_t)kBQ * (a.D + 1) + (size_t)BK * (a.D + 1) +
                       (size_t)BK * a.D + (size_t)kBQ * (BK + 1));
  cudaError_t err = dtt::allow_smem(flash_fwd_kernel<T, TO, BK, MAXJ>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd_kernel<T, TO, BK, MAXJ><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<TO*>(a.o), a.lse, a.H, a.Hkv,
      a.S, a.Sk, a.D, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, typename TO, int MAXJ>
cudaError_t by_block_k(const Args& a) {
  if (a.block_k == 64) return launch<T, TO, 64, MAXJ>(a);
  if (a.block_k == 32) return launch<T, TO, 32, MAXJ>(a);
  return cudaErrorInvalidValue;
}

template <typename T, typename TO>
cudaError_t by_head_dim(const Args& a) {
  if (a.D <= 64) return by_block_k<T, TO, 64 / kRowThreads>(a);
  if (a.D <= 128) return by_block_k<T, TO, 128 / kRowThreads>(a);
  if (a.D <= 256) return by_block_k<T, TO, 256 / kRowThreads>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, H, S, D), k/v (B, Hkv, Sk, D) contiguous, of type in_dtype;
// o (B, H, S, D) of type out_dtype; lse (B, H, S) f32. Returns the
// cudaError_t of the launch (0 = launched).
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int B, int H, int Hkv, int S, int Sk, int D, int causal,
              int window, int block_k, float scale, int in_dtype,
              int out_dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || D <= 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<float*>(lse), B, H, Hkv, S, Sk, D,
               causal, window, block_k, scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (in_dtype == dtt::kF32 && out_dtype == dtt::kF32) {
    err = by_head_dim<float, float>(a);
  } else if (in_dtype == dtt::kBF16 && out_dtype == dtt::kBF16) {
    err = by_head_dim<__nv_bfloat16, __nv_bfloat16>(a);
  } else if (in_dtype == dtt::kBF16 && out_dtype == dtt::kF32) {
    err = by_head_dim<__nv_bfloat16, float>(a);
  }
  return static_cast<int>(err);
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
