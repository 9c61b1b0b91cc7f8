// Flash-attention forward on Hopper's tensor cores (sm_90a), plain C
// interface: bf16 q/k/v at head dim 64 or 128.
//
// Replaces the Pallas TPU kernel distributed_training_tpu/ops/
// flash_attention.py::_fwd_kernel (launched by _flash_fwd) on the port's
// bf16 route; csrc/flash_fwd.cu keeps f32 and the other head dims (the
// routing is ops/flash_attention.py::_design). Same function: blockwise
// online-softmax attention over q (B, H, S, D) and k/v (B, Hkv, Sk, D),
// causal / sliding-window / non-causal (Sq != Sk allowed without the
// mask), GQA by routing q-head h to kv-head h / (H / Hkv), output in bf16
// or f32, per-row logsumexp (B, H, S) in f32, rows with no live key
// written as zeros with lse -1e30.
//
// What bounds it: at the training shape (B 8, H 12, S 1024, D 64, causal)
// the work is 4 D flops per live (query, key) pair, 12.9 GFLOP, against
// 50 MB of inputs and outputs: 0.015 ms at 3.35 TB/s, 0.013 ms at the
// bf16 tensor-core rate, so both limits sit close; the previous SIMT
// kernel ran at 96x that bound on f32 FMAs from shared memory.
//
// Design (FlashAttention-3's forward, without its warp specialisation).
// One warpgroup (128 threads) per (q-tile of 64 rows, head, batch): 64 is
// wgmma's M. Q is loaded once into 128-byte-swizzled shared memory; K and
// V tiles of 64 keys pass through a ring of two stages filled by cp.async
// (zero fill past Sk), so the next tile's copy runs under this tile's
// products. cp.async rather than TMA: the copies need no tensor maps
// (four per launch, each encoded on the host by libcuda) and the
// ragged edge and GQA offsets stay plain address arithmetic. S = Q K^T is
// wgmma m64n64k16 with both operands K-major in shared memory; the online
// softmax runs on the accumulator's registers (a row's four threads share
// its max and sum through quad shuffles; exp2 with log2(e) folded into the
// scale); the masks are applied only to tiles that cross the causal
// diagonal, the window's edge or the ragged end; P goes to bf16 in
// registers and is the A operand of O += P V (m64nDk16, V MN-major from
// shared memory), O in f32 registers. The k-tile loop keeps the band
// bounds of the SIMT kernel (dead tiles are never loaded), and causal
// blocks run heaviest first (the q-tile index is reversed).

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace dtt::sm90;

constexpr int kThreads = 128;       // one warpgroup
constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr float kNoKeyLse = -1e30f;  // lse of a row with no live key

template <int D>
struct Smem {
  static constexpr int kQ = kBQ * D * 2;                // the Q tile, bytes
  static constexpr int kKV = kBK * D * 2;               // one K or V tile
  static constexpr int kBytes = kQ + 2 * 2 * kKV + 1024;  // + 1024-byte alignment slack
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, Hkv, S, Sk, causal, window;
  float scale;
  cudaStream_t stream;
};

__device__ __forceinline__ bool live(int row, int col, int Sk, int causal, int window) {
  if (col >= Sk) return false;
  if (!causal) return true;
  return col <= row && (window <= 0 || col > row - window);
}

template <int D, typename TO>
__global__ void __launch_bounds__(kThreads)
flash_fwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, TO* __restrict__ o, float* __restrict__ lse,
                      int H, int Hkv, int S, int Sk, int causal, int window, float scale) {
  extern __shared__ uint8_t smem[];
  const uint32_t sQ = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sKV = sQ + Smem<D>::kQ;  // stage s: K at sKV + 2 s kKV, V right after

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
  const float sl2 = scale * kLog2e;

  // Key range any row of this tile can see.
  int k_lo = 0, k_hi = Sk;
  if (causal) {
    k_hi = min(Sk, q0 + kBQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int t_lo = k_lo / kBK;
  const int t_hi = (k_hi + kBK - 1) / kBK;

  load_tile<kBQ, D, kThreads>(sQ, q + bh * S * D, q0, S);
  load_tile<kBK, D, kThreads>(sKV, kb, t_lo * kBK, Sk);
  load_tile<kBK, D, kThreads>(sKV + Smem<D>::kKV, vb, t_lo * kBK, Sk);
  cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

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

    float s[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<kBK>::ss<0, 0>(s, desc_k(sQ, kBQ, kk), desc_k(sK, kBK, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const int k0 = t * kBK;
    bool edge = k0 + kBK > Sk;
    if (causal) {
      edge = edge || k0 + kBK - 1 > q0;                    // crosses the diagonal
      if (window > 0) edge = edge || k0 < q0 + kBQ - window;  // or the window's edge
    }
    if (edge) {
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + r0 + 8 * (j >> 1);
          const int col = k0 + 8 * i + c0 + (j & 1);
          if (!live(row, col, Sk, causal, window)) s[4 * i + j] = -INFINITY;
        }
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i) {
        mx = fmaxf(mx, fmaxf(s[4 * i + 2 * rr], s[4 * i + 2 * rr + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      // m_new == -inf: no live key yet; every weight is exp2(-inf) = 0.
      const float alpha = m_new == -INFINITY ? 1.f : exp2f((m[rr] - m_new) * sl2);
      const float base = m_new == -INFINITY ? 0.f : m_new * sl2;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int idx = 4 * i + 2 * rr + jj;
          s[idx] = exp2f(fmaf(s[idx], sl2, -base));
          sum += s[idx];
        }
      l[rr] = l[rr] * alpha + sum;
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i + 2 * rr] *= alpha;
        acc[4 * i + 2 * rr + 1] *= alpha;
      }
    }

    uint32_t pa[kBK / 16][4];
    to_a_frags<kBK / 16>(s, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      Wgmma<D>::template rs<1>(acc, pa[kk], desc_mn(sV, kBK, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  TO* ob = o + bh * S * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = q0 + r0 + 8 * rr;
    if (row < S) {
      const bool has = lt > 0.f;
      const float inv = has ? 1.f / lt : 0.f;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        store2(ob + (size_t)row * D + 8 * i + c0, acc[4 * i + 2 * rr] * inv,
               acc[4 * i + 2 * rr + 1] * inv);
      }
      if (lane % 4 == 0) lse[bh * S + row] = has ? m[rr] * scale + logf(lt) : kNoKeyLse;
    }
  }
}

template <int D, typename TO>
cudaError_t launch(const Args& a) {
  auto kern = flash_fwd_sm90_kernel<D, TO>;
  cudaError_t err = dtt::allow_smem(kern, Smem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  kern<<<grid, kThreads, Smem<D>::kBytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<TO*>(a.o), a.lse, a.H, a.Hkv, a.S, a.Sk,
      a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t by_head_dim(const Args& a, int D) {
  if (D == 64) return launch<64, TO>(a);
  if (D == 128) return launch<128, TO>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, H, S, D), k/v (B, Hkv, Sk, D) contiguous bf16, D 64 or 128;
// o (B, H, S, D) in out_dtype (bf16 or f32); lse (B, H, S) f32. Returns
// the cudaError_t of the launch (0 = launched).
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int H, int Hkv, int S, int Sk, int D, int causal, int window, float scale,
                   int out_dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || Sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, static_cast<float*>(lse), B, H, Hkv, S, Sk, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (out_dtype == dtt::kBF16) {
    err = by_head_dim<bf16>(a, D);
  } else if (out_dtype == dtt::kF32) {
    err = by_head_dim<float>(a, D);
  }
  return static_cast<int>(err);
}

const char* flash_fwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
