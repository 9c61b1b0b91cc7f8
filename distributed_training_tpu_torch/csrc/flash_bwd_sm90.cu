// Flash-attention backward on Hopper's tensor cores (sm_90a), plain C
// interface: bf16 q/k/v/dO at head dim 64 or 128. One kernel, templated on
// whether it carries dq (DQ), gives two entry points:
//   - flash_bwd_sm90 (DQ = true) replaces the Pallas TPU kernel
//     distributed_training_tpu/ops/flash_attention.py::_bwd_fused_kernel
//     (launched by _flash_bwd_fused): dq, dk and dv in one sweep;
//   - flash_bwd_dkv_sm90 (DQ = false) replaces _bwd_dkv_kernel (the split
//     path of _flash_bwd): dk and dv alone, accumulated over the q-tiles.
// csrc/flash_bwd_dq_sm90.cu is the split path's dq kernel; csrc/
// flash_bwd.cu keeps the SIMT kernels for f32 and the other head dims (the
// routing is ops/flash_attention.py::_design). Same function as
// flash_bwd.cu's kernels: from the forward's lse and delta = rowsum(dO * O)
// (both f32, (B, H, S)), dk and dv per q-head in the gradient type (bf16 or
// f32), which the wrapper sums over each GQA group; with DQ, dq is added
// into a zeroed f32 (B, H, S, D) buffer that the wrapper casts. The
// rounding points are the TPU kernels' and the plain version's: p is
// rounded to dO's type before the dv product, ds to q's type before the
// dk and dq products, every sum in f32.
//
// What bounds it: at the training shape (B 8, H 12, S 1024, D 64, causal)
// the fused work is 10 D flops per live pair, 32.2 GFLOP, against 89 MB of
// inputs and outputs: operations bound, 0.033 ms at the bf16 tensor-core
// rate; dk/dv alone are 8 D flops a pair, 0.026 ms. The previous SIMT
// kernels took 109x (fused) and 93x (dk/dv) that on f32 FMAs.
//
// Design (FlashAttention-3's backward in its transposed form, so that
// every product is a legal wgmma). One warpgroup per (k-tile of 64 keys,
// q-head, batch); causal blocks with the longest band (the first k-tiles)
// are launched first. K and V are loaded once into swizzled shared memory;
// the q-tiles of the band (from the causal diagonal to the window's end,
// the SIMT kernel's bounds) pass through a two-stage cp.async ring of
// (Q, dO, lse, delta) tiles. Per q-tile of 64 queries:
//   S^T  = K Q^T         (A = K, B = Q, both K-major in shared memory)
//   dP^T = V dO^T        (A = V, B = dO)
//   P^T  = exp2((S^T scale - lse) log2e), masked to exactly 0
//   dS^T = P^T (dP^T - delta) scale
//   dV  += P^T dO        (A = P^T as bf16 from registers, B = dO MN-major)
//   dK  += dS^T Q        (A = dS^T as bf16 from registers, B = Q MN-major)
//   dQ   = dS K          (DQ only: dS^T written to shared memory as bf16
//                         and read back as an MN-major A; B = K MN-major)
// The exponent is formed as the plain version forms it, s scale - lse in
// one fma, and only then scaled by log2(e): folding log2(e) into both
// terms (s scale log2e - lse log2e) subtracts two numbers near 10 and
// leaves p about 1e-6 off, which flips the bf16 rounding of p and ds ten
// times as often as the products' summation order does. dK and dV stay in
// f32 registers for the whole band and are written once. With DQ, each dQ
// tile is added to device memory with vector reductions (float4
// atomicAdd, red.global.add.v4.f32): neighbouring lanes swap halves so
// each holds four adjacent columns of one row; their order changes from
// run to run. Without DQ the kernel has no dS^T tile in shared memory
// (8 KB less a block), no third product and no reductions: it uses no
// atomics and gives the same bits on every run.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace dtt::sm90;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kBK = 64;        // keys per block: wgmma's M for S^T, dP^T, dK, dV
constexpr int kBQ = 64;        // queries per tile: wgmma's M for dQ

template <int D>
struct Smem {
  static constexpr int kKV = kBK * D * 2;        // the K or the V tile, bytes
  static constexpr int kQ = kBQ * D * 2;         // one Q or dO tile
  static constexpr int kStage = 2 * kQ + 1024;   // Q, dO, then lse and delta (64 floats each)
  static constexpr int kDS = kBK * kBQ * 2;      // dS^T in bf16 (DQ only)
  static constexpr int bytes(bool dq) {           // + 1024-byte alignment slack
    return 2 * kKV + 2 * kStage + (dq ? kDS : 0) + 1024;
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  float* dq;  // null without DQ
  void* dk;
  void* dv;
  int B, H, Hkv, S, Sk, causal, window;
  float scale;
  cudaStream_t stream;
};

__device__ __forceinline__ bool live(int row, int col, int S, int Sk, int causal, int window) {
  if (row >= S || col >= Sk) return false;
  if (!causal) return true;
  return col <= row && (window <= 0 || col > row - window);
}

// One q-tile's Q, dO, lse and delta into a ring stage; rows past S are
// zeros.
template <int D>
__device__ __forceinline__ void load_stage(uint32_t stage, const bf16* qb, const bf16* dob,
                                           const float* lb, const float* deb, int q0, int S) {
  load_tile<kBQ, D, kThreads>(stage, qb, q0, S);
  load_tile<kBQ, D, kThreads>(stage + Smem<D>::kQ, dob, q0, S);
  const int i = threadIdx.x % kBQ;
  const bool is_lse = threadIdx.x < kBQ;
  const bool valid = q0 + i < S;
  cp_async4(stage + 2 * Smem<D>::kQ + (is_lse ? 0 : 4 * kBQ) + 4 * i,
            (is_lse ? lb : deb) + (valid ? q0 + i : 0), valid);
}

// dq[rows, cols] += one 64 x 64 f32 accumulator block, by float4
// reductions: lanes l and l ^ 1 swap halves so that the even lane holds
// row r, columns c .. c + 3 and the odd lane row r + 8.
__device__ __forceinline__ void add_dq(float* dqb, const float (&d)[32], int row0, int col0,
                                       int S, int D, int lane) {
  const bool odd = lane & 1;
  const int row = row0 + (odd ? 8 : 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x0 = d[4 * i], x1 = d[4 * i + 1], y0 = d[4 * i + 2], y1 = d[4 * i + 3];
    const float t0 = __shfl_xor_sync(0xffffffffu, odd ? x0 : y0, 1);
    const float t1 = __shfl_xor_sync(0xffffffffu, odd ? x1 : y1, 1);
    const int col = col0 + 8 * i - (odd ? 2 : 0);
    const float4 val = odd ? make_float4(t0, t1, y0, y1) : make_float4(x0, x1, t0, t1);
    if (row < S) atomicAdd(reinterpret_cast<float4*>(dqb + (size_t)row * D + col), val);
  }
}

template <int D, typename TG, bool DQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dq, TG* __restrict__ dk, TG* __restrict__ dv, int H,
                      int Hkv, int S, int Sk, int causal, int window, float scale) {
  extern __shared__ uint8_t smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t sK = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem + (sK - raw);  // generic pointer to sK
  const uint32_t sV = sK + Smem<D>::kKV;
  const uint32_t sStage = sV + Smem<D>::kKV;
  [[maybe_unused]] const uint32_t sDS = sStage + 2 * Smem<D>::kStage;  // DQ only

  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t bh = (size_t)b * H + h;
  const bf16* qb = q + bh * S * D;
  const bf16* dob = dout + bh * S * D;
  const float* lb = lse + bh * S;
  const float* deb = delta + bh * S;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;  // this thread's accumulator rows: r0 and r0 + 8
  const int c0 = 2 * (lane % 4);        // its column pair in each 8-column chunk

  // Queries that see any key of this tile: from the causal diagonal to the
  // last key's window end, [k0, k0 + kBK - 1 + window - 1].
  int q_lo = 0, q_hi = S;
  if (causal) {
    q_lo = k0;
    if (window > 0) q_hi = min(S, k0 + kBK - 1 + window);
  }
  const int t_lo = q_lo / kBQ;
  const int t_hi = (q_hi + kBQ - 1) / kBQ;

  load_tile<kBK, D, kThreads>(sK, k + ((size_t)b * Hkv + hk) * Sk * D, k0, Sk);
  load_tile<kBK, D, kThreads>(sV, v + ((size_t)b * Hkv + hk) * Sk * D, k0, Sk);
  if (t_lo < t_hi) load_stage<D>(sStage, qb, dob, lb, deb, t_lo * kBQ, S);
  cp_async_commit();

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    const uint32_t sQ = sStage + st * Smem<D>::kStage;
    const uint32_t sdO = sQ + Smem<D>::kQ;
    const float* sL = reinterpret_cast<const float*>(gbase + (sQ - sK) + 2 * Smem<D>::kQ);
    const float* sDe = sL + kBQ;
    __syncthreads();  // every thread is done with the other stage (and dS^T)
    if (t + 1 < t_hi) {
      load_stage<D>(sStage + (st ^ 1) * Smem<D>::kStage, qb, dob, lb, deb, (t + 1) * kBQ, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t have landed
    fence_async_smem();
    __syncthreads();     // and everyone's

    const int q0 = t * kBQ;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<64>::ss<0, 0>(s, desc_k(sK, kBK, kk), desc_k(sQ, kBQ, kk));
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<64>::ss<0, 0>(dp, desc_k(sV, kBK, kk), desc_k(sdO, kBQ, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // Rows of s / dp are keys, columns queries.
    bool edge = q0 + kBQ > S || k0 + kBK > Sk;
    if (causal) {
      edge = edge || k0 + kBK - 1 > q0;                    // crosses the diagonal
      if (window > 0) edge = edge || k0 < q0 + kBQ - window;  // or the window's edge
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int qc = 8 * i + c0 + jj;
        const float lq = sL[qc];
        const float dl = sDe[qc];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int idx = 4 * i + 2 * rr + jj;
          float p = exp2f(fmaf(s[idx], scale, -lq) * kLog2e);
          if (edge && !live(q0 + qc, k0 + r0 + 8 * rr, S, Sk, causal, window)) p = 0.f;
          dp[idx] = p * (dp[idx] - dl) * scale;
          s[idx] = p;
        }
      }
    uint32_t pa[4][4], dsa[4][4];
    to_a_frags<4>(s, pa);    // p rounded to dO's type
    to_a_frags<4>(dp, dsa);  // ds rounded to q's type

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      Wgmma<D>::template rs<1>(dv_acc, pa[kk], desc_mn(sdO, kBQ, kk));
    }
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      Wgmma<D>::template rs<1>(dk_acc, dsa[kk], desc_mn(sQ, kBQ, kk));
    }
    wgmma_commit();
    if constexpr (DQ) {
      // dS^T (keys x queries) into shared memory for dQ, under the products.
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st_shared_u32(sDS + swz(kBK, r0 + 8 * (j & 1), 16 * kk + 8 * (j >> 1) + c0),
                        dsa[kk][j]);
        }
    }
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    if constexpr (DQ) {
      fence_async_smem();
      __syncthreads();

      // dQ = dS K by 64-column blocks of D: A = dS, i.e. dS^T read MN-major.
      float* dqb = dq + bh * S * D;
#pragma unroll
      for (int half = 0; half < D / 64; ++half) {
        float dqa[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          Wgmma<64>::ss<1, 1>(dqa, desc_mn(sDS, kBK, kk),
                              desc_mn(sK + half * kBK * 128, kBK, kk));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
        add_dq(dqb, dqa, q0 + r0, 64 * half + c0, S, D, lane);
      }
    }
  }

  TG* dkb = dk + bh * Sk * D;
  TG* dvb = dv + bh * Sk * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k0 + r0 + 8 * rr;
    if (key < Sk) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const size_t off = (size_t)key * D + 8 * i + c0;
        store2(dkb + off, dk_acc[4 * i + 2 * rr], dk_acc[4 * i + 2 * rr + 1]);
        store2(dvb + off, dv_acc[4 * i + 2 * rr], dv_acc[4 * i + 2 * rr + 1]);
      }
    }
  }
}

template <int D, typename TG, bool DQ>
cudaError_t launch(const Args& a) {
  auto kern = flash_bwd_sm90_kernel<D, TG, DQ>;
  constexpr int kBytes = Smem<D>::bytes(DQ);
  cudaError_t err = dtt::allow_smem(kern, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + kBK - 1) / kBK, a.H, a.B);
  kern<<<grid, kThreads, kBytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta, a.dq,
      static_cast<TG*>(a.dk), static_cast<TG*>(a.dv), a.H, a.Hkv, a.S, a.Sk, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

template <bool DQ>
int dispatch(const Args& a, int D, int grad_dtype) {
  if (a.B <= 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv || a.S <= 0 || a.Sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (grad_dtype == dtt::kBF16) {
    if (D == 64) err = launch<64, bf16, DQ>(a);
    if (D == 128) err = launch<128, bf16, DQ>(a);
  } else if (grad_dtype == dtt::kF32) {
    if (D == 64) err = launch<64, float, DQ>(a);
    if (D == 128) err = launch<128, float, DQ>(a);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// q/do (B, H, S, D), k/v (B, Hkv, Sk, D) contiguous bf16, D 64 or 128;
// lse and delta (B, H, S) f32; dq_acc a zeroed f32 (B, H, S, D) buffer
// that receives dq; dk/dv (B, H, Sk, D) per q-head in grad_dtype (bf16 or
// f32). Returns the cudaError_t of the launch (0 = launched).
int flash_bwd_sm90(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq_acc, void* dk, void* dv, int B,
                   int H, int Hkv, int S, int Sk, int D, int causal, int window, float scale,
                   int grad_dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<float*>(dq_acc), dk, dv, B, H, Hkv, S, Sk, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, D, grad_dtype);
}

// The split path's dk/dv kernel: the same arguments without dq.
int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                       int Hkv, int S, int Sk, int D, int causal, int window, float scale,
                       int grad_dtype, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               nullptr, dk, dv, B, H, Hkv, S, Sk, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, D, grad_dtype);
}

const char* flash_bwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
