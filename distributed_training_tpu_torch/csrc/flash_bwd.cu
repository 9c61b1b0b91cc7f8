// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the three Pallas TPU kernels of distributed_training_tpu/ops/
// flash_attention.py's backward:
//   - _bwd_fused_kernel (launched by _flash_bwd_fused): dq, dk, dv in one
//     sweep -> flash_bwd_dkv with a dq accumulator (FUSED = true);
//   - _bwd_dkv_kernel (the split path of _flash_bwd): dk, dv accumulated
//     over q-tiles -> flash_bwd_dkv without one (FUSED = false);
//   - _bwd_dq_kernel (the split path): dq accumulated over k-tiles ->
//     flash_bwd_dq.
// Inputs: q/do (B, H, S, D), k/v (B, Hkv, Sk, D) in f32 or bf16 (do
// already in v's type), the forward's per-row lse (B, H, S) and
// delta = rowsum(dO * O) (B, H, S), both f32. Every tile recomputes
// s = q k^T * scale and p = exp(s - lse) (masked entries give p = 0
// exactly), then dp = dO v^T and ds = p (dp - delta) scale. The rounding
// points are the TPU kernels': p is rounded to do's type before the dv
// product and ds to q's type before the dk and dq products; every sum is
// in f32. GQA: q-head h reads kv-head h / (H / Hkv); dk and dv are
// written per q-head and the wrapper sums each group.
//
// Design. One block per (tile of kT rows, q-head, batch); a loop inside
// the block over the other sequence's tiles takes the place of the TPU
// grid's sequential axis, with bounds set from the causal/window band so
// that tiles with no live pair cost nothing. The dk/dv kernel holds its
// k/v tile in shared memory and its dk/dv rows in registers (kRT threads
// per row), and loops over the q-tiles from the causal diagonal to the
// window's end. The TPU fused kernel keeps a whole (S, D) f32 dq in VMEM;
// 227 KB of shared memory cannot hold that, so the fused kernel instead
// adds each tile's ds k into a zeroed f32 (B, H, S, D) dq buffer in
// device memory with atomicAdd, as FlashAttention-2 does. The split
// kernels use no atomics and are deterministic; the fused dq sums in an
// order that changes from run to run.
//
// What bounds it: at the training shape (B 8, H 12, S 1024, D 64, bf16,
// causal) the work is 10 * D flops per live (query, key) pair, about
// 32 GFLOP, against about 89 MB of inputs and outputs: operations bound
// on the tensor cores. This first kernel multiplies with f32 FMAs from
// shared memory and is bound by shared-memory bandwidth instead;
// mma.sync/wgmma with TMA-fed tiles is the later step (ROADMAP.md).

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;     // split: (B, H, S, D) of the gradient type; fused: f32 accumulator
  void* dk;     // (B, H, Sk, D) per q-head, gradient type
  void* dv;
  int B, H, Hkv, S, Sk, D, causal, window;
  float scale;
  cudaStream_t stream;
};

// The value a float takes once rounded to T (round to nearest even).
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return round_to(x, static_cast<T*>(nullptr));
}

// Shared-memory layout, in floats, for tiles of kT rows and head dim D.
template <int kT>
__host__ __device__ constexpr size_t smem_floats(int D) {
  return 4 * (size_t)kT * (D + 1) + 2 * (size_t)kT * (kT + 1) + 2 * kT;
}

struct Tiles {
  float* ks;     // [kT][D + 1] keys
  float* vs;     // [kT][D + 1] values
  float* qs;     // [kT][D + 1] queries
  float* dos;    // [kT][D + 1] output gradient
  float* ps;     // [kT][kT + 1] p rounded to do's type
  float* dss;    // [kT][kT + 1] ds rounded to q's type
  float* lse;    // [kT]
  float* delta;  // [kT]
};

template <int kT>
__device__ Tiles carve(float* smem, int D) {
  const int ld = D + 1;
  Tiles t;
  t.ks = smem;
  t.vs = t.ks + kT * ld;
  t.qs = t.vs + kT * ld;
  t.dos = t.qs + kT * ld;
  t.ps = t.dos + kT * ld;
  t.dss = t.ps + kT * (kT + 1);
  t.lse = t.dss + kT * (kT + 1);
  t.delta = t.lse + kT;
  return t;
}

// Rows [r0, r0 + kT) of a (rows, D) matrix into a padded f32 tile; rows
// past the end are zeros.
template <typename T, int kT>
__device__ void load_rows(float* dst, const T* src, int r0, int rows, int D) {
  const int ld = D + 1;
  for (int i = threadIdx.x; i < kT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = (r0 + r < rows) ? dtt::to_f32(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

template <int kT>
__device__ void load_stats(const Tiles& t, const float* lse, const float* delta,
                           int q0, int S) {
  for (int i = threadIdx.x; i < kT; i += kThreads) {
    const bool in = q0 + i < S;
    t.lse[i] = in ? lse[q0 + i] : 0.f;
    t.delta[i] = in ? delta[q0 + i] : 0.f;
  }
}

// One (q-tile, k-tile) pair: p and ds for every (query, key) of the two
// tiles, rounded to their product types, into t.ps / t.dss. kRT threads
// share a query row; each computes kT / kRT columns.
template <typename T, int kT>
__device__ void tile_scores(const Tiles& t, int q0, int k0, int S, int Sk, int D,
                            int causal, int window, float scale) {
  constexpr int kRT = kThreads / kT;
  constexpr int kNC = kT / kRT;
  constexpr int ldp = kT + 1;
  const int ld = D + 1;
  const int r = threadIdx.x / kRT;
  const int part = threadIdx.x % kRT;
  const int row = q0 + r;
  float s[kNC], dp[kNC];
#pragma unroll
  for (int j = 0; j < kNC; ++j) s[j] = dp[j] = 0.f;
  const float* qrow = t.qs + r * ld;
  const float* drow = t.dos + r * ld;
  for (int d = 0; d < D; ++d) {
    const float qd = qrow[d];
    const float dd = drow[d];
#pragma unroll
    for (int j = 0; j < kNC; ++j) {
      const int c = part + kRT * j;
      s[j] += qd * t.ks[c * ld + d];
      dp[j] += dd * t.vs[c * ld + d];
    }
  }
  const float l = t.lse[r];
  const float dl = t.delta[r];
#pragma unroll
  for (int j = 0; j < kNC; ++j) {
    const int c = part + kRT * j;
    const int col = k0 + c;
    bool live = row < S && col < Sk;
    if (causal) {
      live = live && col <= row;
      if (window > 0) live = live && col >= row - window + 1;
    }
    const float p = live ? expf(s[j] * scale - l) : 0.f;
    t.ps[r * ldp + c] = rounded<T>(p);
    t.dss[r * ldp + c] = rounded<T>(p * (dp[j] - dl) * scale);
  }
}

// dq rows of the current q-tile from its ds tile: acc[j] += ds[r, :] k[:, c].
template <int kT, int kMaxJ>
__device__ void accumulate_dq(const Tiles& t, int D, float (&acc)[kMaxJ]) {
  constexpr int kRT = kThreads / kT;
  constexpr int ldp = kT + 1;
  const int ld = D + 1;
  const int r = threadIdx.x / kRT;
  const int part = threadIdx.x % kRT;
  for (int kk = 0; kk < kT; ++kk) {
    const float ds = t.dss[r * ldp + kk];
    const float* krow = t.ks + kk * ld;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int c = part + kRT * j;
      if (c < D) acc[j] += ds * krow[c];
    }
  }
}

template <typename T, typename TG, int kT, int kMaxJ, bool FUSED>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq_acc, TG* __restrict__ dk,
                     TG* __restrict__ dv, int H, int Hkv, int S, int Sk, int D,
                     int causal, int window, float scale) {
  constexpr int kRT = kThreads / kT;
  constexpr int ldp = kT + 1;
  extern __shared__ float smem[];
  const Tiles t = carve<kT>(smem, D);
  const int ld = D + 1;

  const int k0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t bh = (size_t)b * H + h;
  const T* qb = q + bh * S * D;
  const T* db = dout + bh * S * D;
  const float* lb = lse + bh * S;
  const float* deb = delta + bh * S;
  const T* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * Sk * D;

  load_rows<T, kT>(t.ks, kb, k0, Sk, D);
  load_rows<T, kT>(t.vs, vb, k0, Sk, D);

  const int r = threadIdx.x / kRT;      // key row (dk/dv), query row (dq)
  const int part = threadIdx.x % kRT;
  float dk_acc[kMaxJ], dv_acc[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  // Queries that see any key of this tile: from the causal diagonal to
  // the last key's window end, [k0, k0 + kT - 1 + window - 1].
  int q_lo = 0, q_hi = S;
  if (causal) {
    q_lo = k0;
    if (window > 0) q_hi = min(S, k0 + kT - 1 + window);
  }
  const int t_hi = (q_hi + kT - 1) / kT;

  for (int tq = q_lo / kT; tq < t_hi; ++tq) {
    const int q0 = tq * kT;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, kT>(t.qs, qb, q0, S, D);
    load_rows<T, kT>(t.dos, db, q0, S, D);
    load_stats<kT>(t, lb, deb, q0, S);
    __syncthreads();
    tile_scores<T, kT>(t, q0, k0, S, Sk, D, causal, window, scale);
    __syncthreads();
    for (int qq = 0; qq < kT; ++qq) {
      const float p = t.ps[qq * ldp + r];
      const float ds = t.dss[qq * ldp + r];
      const float* dorow = t.dos + qq * ld;
      const float* qrow = t.qs + qq * ld;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int c = part + kRT * j;
        if (c < D) {
          dv_acc[j] += p * dorow[c];
          dk_acc[j] += ds * qrow[c];
        }
      }
    }
    if constexpr (FUSED) {
      float acc[kMaxJ];
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) acc[j] = 0.f;
      accumulate_dq<kT, kMaxJ>(t, D, acc);
      if (q0 + r < S) {
        float* dqrow = dq_acc + (bh * S + q0 + r) * D;
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          const int c = part + kRT * j;
          if (c < D) atomicAdd(dqrow + c, acc[j]);
        }
      }
    }
  }

  if (k0 + r < Sk) {
    TG* dkrow = dk + (bh * Sk + k0 + r) * D;
    TG* dvrow = dv + (bh * Sk + k0 + r) * D;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int c = part + kRT * j;
      if (c < D) {
        dtt::store(dkrow + c, dk_acc[j]);
        dtt::store(dvrow + c, dv_acc[j]);
      }
    }
  }
}

template <typename T, typename TG, int kT, int kMaxJ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    TG* __restrict__ dq, int H, int Hkv, int S, int Sk, int D,
                    int causal, int window, float scale) {
  constexpr int kRT = kThreads / kT;
  extern __shared__ float smem[];
  const Tiles t = carve<kT>(smem, D);

  const int q0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t bh = (size_t)b * H + h;
  const T* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * Sk * D;

  load_rows<T, kT>(t.qs, q + bh * S * D, q0, S, D);
  load_rows<T, kT>(t.dos, dout + bh * S * D, q0, S, D);
  load_stats<kT>(t, lse + bh * S, delta + bh * S, q0, S);

  float acc[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) acc[j] = 0.f;

  // Keys any query of this tile sees (the forward's band).
  int k_lo = 0, k_hi = Sk;
  if (causal) {
    k_hi = min(Sk, q0 + kT);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int t_hi = (k_hi + kT - 1) / kT;

  for (int tk = k_lo / kT; tk < t_hi; ++tk) {
    const int k0 = tk * kT;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, kT>(t.ks, kb, k0, Sk, D);
    load_rows<T, kT>(t.vs, vb, k0, Sk, D);
    __syncthreads();
    tile_scores<T, kT>(t, q0, k0, S, Sk, D, causal, window, scale);
    __syncthreads();
    accumulate_dq<kT, kMaxJ>(t, D, acc);
  }

  const int r = threadIdx.x / kRT;
  const int part = threadIdx.x % kRT;
  if (q0 + r < S) {
    TG* dqrow = dq + (bh * S + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int c = part + kRT * j;
      if (c < D) dtt::store(dqrow + c, acc[j]);
    }
  }
}

template <typename T, typename TG, int kT, int kMaxJ>
cudaError_t launch_dkv(const Args& a, bool fused) {
  const size_t smem = sizeof(float) * smem_floats<kT>(a.D);
  const dim3 grid((a.Sk + kT - 1) / kT, a.H, a.B);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* d = static_cast<const T*>(a.dout);
  TG* dk = static_cast<TG*>(a.dk);
  TG* dv = static_cast<TG*>(a.dv);
  cudaError_t err;
  if (fused) {
    auto kern = flash_bwd_dkv_kernel<T, TG, kT, kMaxJ, true>;
    if ((err = dtt::allow_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, a.stream>>>(q, k, v, d, a.lse, a.delta,
                                             static_cast<float*>(a.dq), dk, dv, a.H,
                                             a.Hkv, a.S, a.Sk, a.D, a.causal,
                                             a.window, a.scale);
  } else {
    auto kern = flash_bwd_dkv_kernel<T, TG, kT, kMaxJ, false>;
    if ((err = dtt::allow_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, a.stream>>>(q, k, v, d, a.lse, a.delta, nullptr,
                                             dk, dv, a.H, a.Hkv, a.S, a.Sk, a.D,
                                             a.causal, a.window, a.scale);
  }
  return cudaGetLastError();
}

template <typename T, typename TG, int kT, int kMaxJ>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = sizeof(float) * smem_floats<kT>(a.D);
  auto kern = flash_bwd_dq_kernel<T, TG, kT, kMaxJ>;
  cudaError_t err = dtt::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kT - 1) / kT, a.H, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<TG*>(a.dq), a.H, a.Hkv, a.S, a.Sk, a.D, a.causal, a.window,
      a.scale);
  return cudaGetLastError();
}

// Tiles by head dim: 64 rows (4 threads a row) up to D 128, where the
// five tiles take 166 KB of shared memory; 32 rows (8 threads a row)
// above, up to D 256 (140 KB).
template <typename T, typename TG>
cudaError_t by_head_dim(const Args& a, int which) {
  // which: 0 = dk/dv, 1 = dk/dv with the fused dq, 2 = dq
  if (a.D <= 64) {
    return which == 2 ? launch_dq<T, TG, 64, 16>(a) : launch_dkv<T, TG, 64, 16>(a, which == 1);
  }
  if (a.D <= 128) {
    return which == 2 ? launch_dq<T, TG, 64, 32>(a) : launch_dkv<T, TG, 64, 32>(a, which == 1);
  }
  if (a.D <= 256) {
    return which == 2 ? launch_dq<T, TG, 32, 32>(a) : launch_dkv<T, TG, 32, 32>(a, which == 1);
  }
  return cudaErrorInvalidValue;
}

int dispatch(const Args& a, int in_dtype, int grad_dtype, int which) {
  if (a.B <= 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv || a.D <= 0 || a.S <= 0 ||
      a.Sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (in_dtype == dtt::kF32 && grad_dtype == dtt::kF32) {
    err = by_head_dim<float, float>(a, which);
  } else if (in_dtype == dtt::kBF16 && grad_dtype == dtt::kBF16) {
    err = by_head_dim<__nv_bfloat16, __nv_bfloat16>(a, which);
  } else if (in_dtype == dtt::kBF16 && grad_dtype == dtt::kF32) {
    err = by_head_dim<__nv_bfloat16, float>(a, which);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// q/do (B, H, S, D), k/v (B, Hkv, Sk, D) contiguous in in_dtype; lse and
// delta (B, H, S) f32. dk/dv (B, H, Sk, D) per q-head in grad_dtype.
// dq_acc: a zeroed f32 (B, H, S, D) buffer that receives dq by atomicAdd
// (the fused kernel), or null (the split path's dk/dv kernel). Returns
// the cudaError_t of the launch (0 = launched).
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq_acc, void* dk, void* dv,
                  int B, int H, int Hkv, int S, int Sk, int D, int causal, int window,
                  float scale, int in_dtype, int grad_dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq_acc, dk, dv, B, H, Hkv, S, Sk, D,
               causal, window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(a, in_dtype, grad_dtype, dq_acc != nullptr ? 1 : 0);
}

// The split path's dq kernel: dq (B, H, S, D) in grad_dtype.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
                 int S, int Sk, int D, int causal, int window, float scale,
                 int in_dtype, int grad_dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, nullptr, B, H, Hkv, S,
               Sk, D, causal, window, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(a, in_dtype, grad_dtype, 2);
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
