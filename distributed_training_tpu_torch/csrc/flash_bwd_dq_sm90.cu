// Flash-attention backward's dq on Hopper's tensor cores (sm_90a), plain C
// interface: bf16 q/k/v/dO at head dim 64 or 128.
//
// Replaces the Pallas TPU kernel distributed_training_tpu/ops/
// flash_attention.py::_bwd_dq_kernel (the split path of _flash_bwd) on the
// port's bf16 route; csrc/flash_bwd_sm90.cu's flash_bwd_dkv_sm90 is the
// split path's dk/dv kernel, and csrc/flash_bwd.cu keeps the SIMT pair for
// f32 and the other head dims (the routing is ops/flash_attention.py::
// _design). Same function as flash_bwd.cu's flash_bwd_dq: from the
// forward's lse and delta = rowsum(dO * O) (both f32, (B, H, S)), dq
// (B, H, S, D) in the gradient type (bf16 or f32), summed in f32 over the
// k-tiles. The rounding points are the TPU kernel's and the plain
// version's: dO in v's type, ds rounded to q's type before the dq
// product, every sum in f32. GQA: q-head h reads kv-head h / (H / Hkv).
//
// What bounds it: at the training shape (B 8, H 12, S 1024, D 64, causal)
// the work is 6 D flops per live (query, key) pair (S, dP and dQ), 19.3
// GFLOP, against 63 MB of inputs and outputs: operations bound, 0.020 ms
// at the bf16 tensor-core rate. The previous SIMT kernel took 97x that on
// f32 FMAs.
//
// Design (the forward's walk, csrc/flash_fwd_sm90.cu, with the backward's
// products). One warpgroup (128 threads) per (q-tile of 64 queries, q-head,
// batch); causal blocks run heaviest first (the q-tile index is reversed,
// since the last q-tiles have the longest bands). Q and dO are loaded once
// into 128-byte-swizzled shared memory and each thread keeps lse and delta
// of its two rows in registers; K and V tiles of 64 keys pass through a
// two-stage cp.async ring (zero fill past Sk), from the window's first
// k-tile to the causal diagonal (the SIMT kernel's band). Per k-tile:
//   S  = Q K^T        (A = Q, B = K, both K-major in shared memory)
//   dP = dO V^T       (A = dO, B = V)
//   P  = exp2((S scale - lse) log2e), masked to exactly 0 on the tiles
//        that cross the diagonal, the window's edge or the ragged end
//   dS = P (dP - delta) scale, rounded to bf16 in registers
//   dQ += dS K        (A = dS from registers: an accumulator's registers
//                      are the next product's A fragment; B = K MN-major)
// s scale - lse is formed in one fma and only then scaled by log2(e), as
// the fused kernel does (folding log2(e) into both terms flips bf16
// roundings of ds). dQ stays in f32 registers for the whole band and is
// written once: no atomics, so the result is the same on every run, as
// the TPU kernel's is.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace dtt::sm90;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kBQ = 64;        // queries per block: wgmma's M
constexpr int kBK = 64;        // keys per tile

template <int D>
struct Smem {
  static constexpr int kQ = kBQ * D * 2;   // the Q or the dO tile, bytes
  static constexpr int kKV = kBK * D * 2;  // one K or V tile
  static constexpr int kBytes = 2 * kQ + 2 * 2 * kKV + 1024;  // + alignment slack
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  int B, H, Hkv, S, Sk, causal, window;
  float scale;
  cudaStream_t stream;
};

__device__ __forceinline__ bool live(int row, int col, int Sk, int causal, int window) {
  if (col >= Sk) return false;
  if (!causal) return true;
  return col <= row && (window <= 0 || col > row - window);
}

template <int D, typename TG>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         TG* __restrict__ dq, int H, int Hkv, int S, int Sk, int causal,
                         int window, float scale) {
  extern __shared__ uint8_t smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sdO = sQ + Smem<D>::kQ;
  const uint32_t sKV = sdO + Smem<D>::kQ;  // stage s: K at sKV + 2 s kKV, V right after

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t bh = (size_t)b * H + h;
  const bf16* kb = k + ((size_t)b * Hkv + hk) * Sk * D;
  const bf16* vb = v + ((size_t)b * Hkv + hk) * Sk * D;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane % 4);        // its column pair in each 8-column chunk

  // Keys any query of this tile sees (the forward's band).
  int k_lo = 0, k_hi = Sk;
  if (causal) {
    k_hi = min(Sk, q0 + kBQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int t_lo = k_lo / kBK;
  const int t_hi = (k_hi + kBK - 1) / kBK;

  load_tile<kBQ, D, kThreads>(sQ, q + bh * S * D, q0, S);
  load_tile<kBQ, D, kThreads>(sdO, dout + bh * S * D, q0, S);
  load_tile<kBK, D, kThreads>(sKV, kb, t_lo * kBK, Sk);
  load_tile<kBK, D, kThreads>(sKV + Smem<D>::kKV, vb, t_lo * kBK, Sk);
  cp_async_commit();

  // lse and delta of this thread's two rows; rows past S read zeros (their
  // Q and dO rows are zeros too, and they are never written).
  float lq[2], dl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + r0 + 8 * rr;
    lq[rr] = row < S ? lse[bh * S + row] : 0.f;
    dl[rr] = row < S ? delta[bh * S + row] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    const uint32_t sK = sKV + st * 2 * Smem<D>::kKV;
    const uint32_t sV = sK + Smem<D>::kKV;
    __syncthreads();  // every thread is done with the other stage (tile t - 1)
    if (t + 1 < t_hi) {
      const uint32_t nK = sKV + (st ^ 1) * 2 * Smem<D>::kKV;
      load_tile<kBK, D, kThreads>(nK, kb, (t + 1) * kBK, Sk);
      load_tile<kBK, D, kThreads>(nK + Smem<D>::kKV, vb, (t + 1) * kBK, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t have landed
    fence_async_smem();
    __syncthreads();     // and everyone's

    float s[kBK / 2], dp[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<kBK>::ss<0, 0>(s, desc_k(sQ, kBQ, kk), desc_k(sK, kBK, kk));
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<kBK>::ss<0, 0>(dp, desc_k(sdO, kBQ, kk), desc_k(sV, kBK, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // Rows of s / dp are queries, columns keys. Rows past S need no mask:
    // they are never written, and dQ's rows do not mix.
    const int k0 = t * kBK;
    bool edge = k0 + kBK > Sk;
    if (causal) {
      edge = edge || k0 + kBK - 1 > q0;                    // crosses the diagonal
      if (window > 0) edge = edge || k0 < q0 + kBQ - window;  // or the window's edge
    }
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = 4 * i + j;
        const int rr = j >> 1;
        float p = exp2f(fmaf(s[idx], scale, -lq[rr]) * kLog2e);
        if (edge && !live(q0 + r0 + 8 * rr, k0 + 8 * i + c0 + (j & 1), Sk, causal, window)) {
          p = 0.f;
        }
        dp[idx] = p * (dp[idx] - dl[rr]) * scale;
      }
    uint32_t dsa[kBK / 16][4];
    to_a_frags<kBK / 16>(dp, dsa);  // ds rounded to q's type

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      Wgmma<D>::template rs<1>(acc, dsa[kk], desc_mn(sK, kBK, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  TG* dqb = dq + bh * S * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + r0 + 8 * rr;
    if (row < S) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        store2(dqb + (size_t)row * D + 8 * i + c0, acc[4 * i + 2 * rr],
               acc[4 * i + 2 * rr + 1]);
      }
    }
  }
}

template <int D, typename TG>
cudaError_t launch(const Args& a) {
  auto kern = flash_bwd_dq_sm90_kernel<D, TG>;
  cudaError_t err = dtt::allow_smem(kern, Smem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  kern<<<grid, kThreads, Smem<D>::kBytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<TG*>(a.dq), a.H, a.Hkv, a.S, a.Sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename TG>
cudaError_t by_head_dim(const Args& a, int D) {
  if (D == 64) return launch<64, TG>(a);
  if (D == 128) return launch<128, TG>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q/do (B, H, S, D), k/v (B, Hkv, Sk, D) contiguous bf16, D 64 or 128;
// lse and delta (B, H, S) f32; dq (B, H, S, D) in grad_dtype (bf16 or
// f32). Returns the cudaError_t of the launch (0 = launched).
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
                      int S, int Sk, int D, int causal, int window, float scale, int grad_dtype,
                      void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || Sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, B, H, Hkv, S, Sk, causal, window, scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (grad_dtype == dtt::kBF16) {
    err = by_head_dim<bf16>(a, D);
  } else if (grad_dtype == dtt::kF32) {
    err = by_head_dim<float>(a, D);
  }
  return static_cast<int>(err);
}

const char* flash_bwd_dq_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
