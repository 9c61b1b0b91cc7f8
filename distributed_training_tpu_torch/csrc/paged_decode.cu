// Paged single-token decode attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU Pallas paged-attention kernel that distributed_training_
// tpu/ops/paged_attention.py::paged_attention dispatches to (JAX's stock
// jax.experimental.pallas.ops.tpu.paged_attention): one query token per
// sequence, q (B, H, hd), attending the first lengths[b] positions of that
// sequence in a paged pool k/v (Hkv, N, ps, hd) through its page-table row
// page_indices[b] (P entries); GQA with G = H / Hkv query heads per kv head;
// f32 logits and softmax, output (B, H, hd) in q's type; a length-0 row
// gives zeros. Lengths are clamped into [0, P * ps] and page ids into the
// pool, so a bad table reads wrong rows instead of faulting.
//
// What bounds it: decode reads every cached K/V element once and does
// about 2 G flops per byte with it (G <= 4 for every preset), below even
// the CUDA cores' ridge of about 20 flops per byte (67 TFLOP/s f32 over
// 3.35 TB/s). The bound is memory bandwidth. Tensor cores would speed up
// arithmetic that does not bound this kernel, so it uses none, on purpose.
// What keeps it above that bound at decode sizes is latency: each block's
// chain of the length, its page ids, its pages, its arithmetic and the
// merge, then the combine; the design spreads the walk over many blocks
// and keeps each chain short.
//
// Design "split_kv" (FlashDecoding).
// - The grid is (splits, Hkv x head chunks, B). Each block walks one
//   contiguous range of whole pages of one sequence (split s: logical pages
//   [s * pps, (s + 1) * pps), pps and the split count chosen on the host
//   from shapes only) for up to GC query heads of its kv head. A block whose
//   range starts at or past the sequence's length writes an empty partial
//   (m = -inf, l = 0) and exits.
// - Each block resolves its page ids once, into shared memory, then copies
//   K and V a page at a time (an "item": a page, or R rows of one when a
//   page is larger than kItemBytes) with 16-byte cp.async, a round of Q
//   items at a time. When the split's items fit kRingBytes they are one
//   round, all in flight at once, after one DRAM round trip for the length
//   and one for the page ids; otherwise two buffers of Q items alternate,
//   the next round's copies in flight while this one is computed. One page
//   of one kv head is one contiguous run of ps * hd elements; a round's
//   tokens land in order in a K region and a V region of its buffer, so a
//   token's rows sit at (token - first token of the round) * row bytes, no
//   division. K and V stay in their storage type in shared memory; one
//   barrier per round.
// - Each row's hd is spread over lpr lanes (a "lane group") in 16-byte
//   vectors. A lane group takes every (4 * 32 / lpr)-th token of the round,
//   kTile of them at a time: their logits are independent (the q.k dot
//   products reduced with shuffles, all kTile in flight together), then one
//   max, one rescale and one pass of P.V update the lane group's running max
//   m, sum l and unnormalised f32 accumulator (its slice of GC x hd), all in
//   registers, with log2(e) folded into q's scale so exp2 serves (one
//   rescale a tile, not one a row, shortens the block's chain). At the end
//   the lane groups merge by shuffles, the warps through shared memory.
// - With one split the block writes the output itself. With more, it writes
//   its partial (m, l, accumulator) to an f32 workspace the wrapper
//   allocated, and a second kernel launched by the same C call merges each
//   (sequence, query head)'s splits with weights exp2(m_i - max m) in a
//   fixed order: no atomics, so a second launch gives the same bits. The
//   combine is a programmatic dependent launch: it is scheduled while the
//   split kernel runs and waits (griddepcontrol.wait) for its partials, so
//   its launch latency hides behind the split kernel's tail.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kItemBytes = 16384;  // K + V of one item, at most
constexpr int kRingBytes = 65536;  // K + V of all items in shared memory, at most
constexpr int kTile = 8;           // tokens a lane group takes at once
constexpr int kCombineThreads = 128;
constexpr int kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* lengths;
  const int* page_indices;
  void* out;
  float* ws;
  int B, H, Hkv, N, ps, hd, P, splits, pps;
  float scale;
  cudaStream_t stream;
};

// 16 bytes of T, widened to f32 in registers.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* x) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

// Lanes a key row is spread over: the row's 16-byte vectors rounded up to a
// power of two, at most a warp (f32 at hd > 128: two vectors a lane).
template <typename T>
__device__ __forceinline__ int lanes_per_row(int hd) {
  const int nvec = hd / Vec<T>::kN;
  int lpr = 1;
  while (lpr < nvec && lpr < 32) lpr <<= 1;
  return lpr;
}

// Rows of one item: a whole page when its K and V fit kItemBytes.
__host__ __device__ __forceinline__ int item_rows(int ps, int row_bytes) {
  const int fit = kItemBytes / (2 * row_bytes);
  return ps < fit ? ps : fit;
}

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Items a round copies, and the buffers of rounds: the whole split in one
// buffer when it fits kRingBytes, else two buffers of half that.
inline void rounds_of(int items_per_split, int item_bytes, int& q, int& buffers) {
  const int fit = kRingBytes / item_bytes;  // >= 4: item_bytes <= kItemBytes
  buffers = items_per_split <= fit ? 1 : 2;
  q = buffers == 1 ? items_per_split : fit / 2;
}

// Weight of a partial with running max m against the overall max mx; an
// empty partial (m = -inf) weighs 0, also when mx is -inf.
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.f : exp2f(m - mx);
}

template <typename T, int GC>
__global__ void __launch_bounds__(kThreads)
paged_split_kv_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages, const int* __restrict__ lengths,
                      const int* __restrict__ page_indices, T* __restrict__ out,
                      float* __restrict__ ws, int H, int Hkv, int N, int ps, int hd, int P,
                      int splits, int pps, int R, int Q, int buffers, float scale_log2) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kVecs = 256 / (32 * kN);  // vectors a lane holds at hd 256
  constexpr int kE = kVecs * kN;          // floats a lane holds per head
  extern __shared__ __align__(16) unsigned char smem[];
  // The combine (launched after this kernel, dependent) may be scheduled;
  // it waits for this grid's writes itself.
  asm volatile("griddepcontrol.launch_dependents;");

  const int G = H / Hkv;
  const int chunks = (G + GC - 1) / GC;
  const int split = blockIdx.x;
  const int hk = blockIdx.y / chunks;
  const int g0 = (blockIdx.y % chunks) * GC;
  const int gc = min(GC, G - g0);  // query heads of this block
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = max(0, min(lengths[b], P * ps));
  const int t0 = split * pps * ps;
  const int t1 = min(len, t0 + pps * ps);
  const size_t head0 = (size_t)b * H + (size_t)hk * G + g0;  // first query head
  const size_t n_partials = (size_t)gridDim.z * H * splits;
  float* ws_ml = ws + n_partials * hd;  // (m, l) pairs after the accumulators

  if (t0 >= len) {  // nothing to attend in this range
    if (splits > 1) {
      for (int g = tid; g < gc; g += kThreads) {
        float* ml = ws_ml + ((head0 + g) * splits + split) * 2;
        ml[0] = -INFINITY;
        ml[1] = 0.f;
      }
    } else {
      for (int i = tid; i < gc * hd; i += kThreads) dtt::store(out + head0 * hd + i, 0.f);
    }
    return;
  }

  const int row_bytes = hd * (int)sizeof(T);
  const int ipp = (ps + R - 1) / R;  // items a page
  const int nv = t1 - t0;            // tokens of this split
  const int n_pages = (nv + ps - 1) / ps;
  const int last_rows = nv - (n_pages - 1) * ps;
  const int n_items = (n_pages - 1) * ipp + (last_rows + R - 1) / R;
  const int stage_bytes = 2 * R * row_bytes;
  int* pid = reinterpret_cast<int*>(smem);
  unsigned char* ring = smem + align16((size_t)pps * sizeof(int));
  float* m_sm = reinterpret_cast<float*>(ring + (size_t)Q * buffers * stage_bytes);
  float* l_sm = m_sm + kWarps * GC;
  float* acc_sm = l_sm + kWarps * GC;  // [warp][GC][hd]

  const int* table = page_indices + (size_t)b * P + (size_t)split * pps;
  for (int j = tid; j < n_pages; j += kThreads) pid[j] = min(max(table[j], 0), N - 1);
  __syncthreads();

  // Item i is rows [r0, r0 + n) of logical page j of this split, tokens
  // [first_token(i), + n); round k copies items [k Q, k Q + Q) into buffer
  // k % buffers (K rows, then V rows, Q R rows each), one commit group.
  const int vregion = Q * R * row_bytes;
  auto first_token = [&](int i) { return (i / ipp) * ps + (i % ipp) * R; };
  auto copy_round = [&](int k) {
    const int i_end = min(n_items, (k + 1) * Q);
    const int v_lo = first_token(k * Q);
    const uint32_t buf = dtt::sm90::smem_u32(ring + (size_t)(k % buffers) * Q * stage_bytes);
    for (int i = k * Q; i < i_end; ++i) {
      const int j = i / ipp, r0 = (i % ipp) * R;
      const int n = min(R, min(ps - r0, nv - (j * ps + r0)));
      const size_t src = (((size_t)hk * N + pid[j]) * ps + r0) * row_bytes;
      const char* ks = reinterpret_cast<const char*>(k_pages) + src;
      const char* vs = reinterpret_cast<const char*>(v_pages) + src;
      const uint32_t dst = buf + (first_token(i) - v_lo) * row_bytes;
      const int n16 = n * row_bytes / 16;
      for (int c = tid; c < n16; c += kThreads) {
        dtt::sm90::cp_async16(dst + c * 16, ks + c * 16, true);
        dtt::sm90::cp_async16(dst + vregion + c * 16, vs + c * 16, true);
      }
    }
    dtt::sm90::cp_async_commit();  // an empty group past the end keeps the count
  };
  const int rounds = (n_items + Q - 1) / Q;
  copy_round(0);
  if (buffers == 2) copy_round(1);

  const int nvec = hd / kN;
  const int lpr = lanes_per_row<T>(hd);
  const int rpw = 32 / lpr;         // lane groups a warp
  const int nslots = kWarps * rpw;  // lane groups a block
  const int sub = lane % lpr, slot = lane / lpr;

  float qr[GC][kE], acc[GC][kE], m[GC], l[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int c = sub + v * lpr;
      if (g < gc && c < nvec) {
        Vec<T>::load(q + (head0 + g) * hd + c * kN, &qr[g][v * kN]);
      } else {
#pragma unroll
        for (int e = 0; e < kN; ++e) qr[g][v * kN + e] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      qr[g][e] *= scale_log2;
      acc[g][e] = 0.f;
    }
  }

  for (int k = 0; k < rounds; ++k) {
    // Groups committed: buffers + k; round k's must be in.
    if (buffers == 2) {
      dtt::sm90::cp_async_wait<1>();
    } else {
      dtt::sm90::cp_async_wait<0>();
    }
    __syncthreads();  // round k is in
    const int i0 = k * Q;
    const int v_lo = first_token(i0);
    const int v_hi = i0 + Q < n_items ? first_token(i0 + Q) : nv;
    const unsigned char* buf = ring + (size_t)(k % buffers) * Q * stage_bytes;
    // Warp-uniform trip count: every lane of the warp joins the shuffles.
    for (int vb = v_lo + warp * rpw; vb < v_hi; vb += kTile * nslots) {
      float s[GC][kTile];
      int off[kTile];  // byte offset of the token's K row in buf; -1: no token
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int v = vb + slot + t * nslots;
        off[t] = v < v_hi ? (v - v_lo) * row_bytes : -1;
        float kx[kE];
#pragma unroll
        for (int u = 0; u < kVecs; ++u) {
          const int c = sub + u * lpr;
          if (off[t] >= 0 && c < nvec) {
            Vec<T>::load(reinterpret_cast<const T*>(buf + off[t]) + c * kN, &kx[u * kN]);
          } else {
#pragma unroll
            for (int e = 0; e < kN; ++e) kx[u * kN + e] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < kE; ++e) dot = fmaf(qr[g][e], kx[e], dot);
          s[g][t] = dot;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        if (o < lpr) {
#pragma unroll
          for (int g = 0; g < GC; ++g)
#pragma unroll
            for (int t = 0; t < kTile; ++t) s[g][t] += __shfl_xor_sync(0xffffffffu, s[g][t], o);
        }
      }
      // One rescale a tile: s becomes the unnormalised weights p.
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float mt = -INFINITY;
#pragma unroll
        for (int t = 0; t < kTile; ++t)
          if (off[t] >= 0) mt = fmaxf(mt, s[g][t]);
        const float mn = fmaxf(m[g], mt);
        const float a = weight(m[g], mn);  // 0 while the lane group has no key
        float psum = 0.f;
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          s[g][t] = off[t] >= 0 ? exp2f(s[g][t] - mn) : 0.f;
          psum += s[g][t];
        }
        l[g] = l[g] * a + psum;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][e] *= a;
        m[g] = mn;
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        if (off[t] >= 0) {
          float vx[kE];
#pragma unroll
          for (int u = 0; u < kVecs; ++u) {
            const int c = sub + u * lpr;
            if (c < nvec) {
              Vec<T>::load(reinterpret_cast<const T*>(buf + off[t] + vregion) + c * kN,
                           &vx[u * kN]);
            } else {
#pragma unroll
              for (int e = 0; e < kN; ++e) vx[u * kN + e] = 0.f;
            }
          }
#pragma unroll
          for (int g = 0; g < GC; ++g)
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[g][e] = fmaf(s[g][t], vx[e], acc[g][e]);
        }
      }
    }
    if (buffers == 2) {
      if (k + 2 < rounds) __syncthreads();  // every warp is done with this buffer
      copy_round(k + 2);  // commits even past the end: the count stays buffers + k
    }
  }
  dtt::sm90::cp_async_wait<0>();

  // Merge the warp's lane groups (lanes sub, sub + lpr, ... hold the same
  // columns), then the warps through shared memory.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o >= lpr) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mn = fmaxf(m[g], mo);
        const float a = weight(m[g], mn), ao = weight(mo, mn);
        l[g] = l[g] * a + lo * ao;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float x = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
          acc[g][e] = acc[g][e] * a + x * ao;
        }
        m[g] = mn;
      }
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g < gc) {
        float* dst = acc_sm + (warp * GC + g) * hd;
#pragma unroll
        for (int v = 0; v < kVecs; ++v) {
          const int c = sub + v * lpr;
          if (c < nvec) {
#pragma unroll
            for (int e = 0; e < kN; ++e) dst[c * kN + e] = acc[g][v * kN + e];
          }
        }
        if (lane == 0) {
          m_sm[warp * GC + g] = m[g];
          l_sm[warp * GC + g] = l[g];
        }
      }
    }
  }
  __syncthreads();

  for (int idx = tid; idx < gc * hd; idx += kThreads) {
    const int g = idx / hd, d = idx - g * hd;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_sm[w * GC + g]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = weight(m_sm[w * GC + g], mx);
      sum += l_sm[w * GC + g] * wt;
      a += acc_sm[(w * GC + g) * hd + d] * wt;
    }
    if (splits == 1) {
      dtt::store(out + (head0 + g) * hd + d, sum > 0.f ? a / sum : 0.f);
    } else {
      const size_t part = (head0 + g) * splits + split;
      ws[part * hd + d] = a;
      if (d == 0) {
        ws_ml[part * 2] = mx;
        ws_ml[part * 2 + 1] = sum;
      }
    }
  }
}

// out[b, h] = sum_i w_i acc_i / sum_i w_i l_i over the splits of (b, h),
// w_i = exp2(m_i - max m), one block per (b, h). Each thread takes one
// float4 column of the accumulators and a strided group of splits, and
// merges them online as it loads them (partial (m, l) and accumulator in
// one pass, loads unrolled so several are in flight); then the groups are
// merged through shared memory in a fixed order. An empty split (m = -inf)
// weighs 0 and its accumulator was never written: it is selected away,
// never multiplied, so no garbage or NaN reaches the output. No split with
// a key gives zeros.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int splits, int hd) {
  extern __shared__ __align__(16) float csm[];  // [groups][hd] sums, [groups] m, [groups] l
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the split kernel's partials are in
  const int tid = threadIdx.x;
  const size_t bh = blockIdx.x;
  const float2* ml = reinterpret_cast<const float2*>(ws + (size_t)gridDim.x * splits * hd) +
                     bh * splits;
  const int n4 = hd / 4;
  const int groups = kCombineThreads / n4;
  const int c = tid % n4, g = tid / n4;
  float* part = csm;
  float* m_g = csm + groups * hd;
  float* l_g = m_g + groups;
  if (g < groups) {
    const float4* acc = reinterpret_cast<const float4*>(ws + bh * splits * hd) + c;
    float m = -INFINITY, l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = g; s < splits; s += groups) {
      const float2 st = ml[s];
      const float4 x = acc[(size_t)s * n4];
      const float mn = fmaxf(m, st.x);
      const float wo = weight(m, mn), w = weight(st.x, mn);
      l = l * wo + st.y * w;
      a.x = a.x * wo + (w > 0.f ? w * x.x : 0.f);
      a.y = a.y * wo + (w > 0.f ? w * x.y : 0.f);
      a.z = a.z * wo + (w > 0.f ? w * x.z : 0.f);
      a.w = a.w * wo + (w > 0.f ? w * x.w : 0.f);
      m = mn;
    }
    *reinterpret_cast<float4*>(part + g * hd + 4 * c) = a;
    if (c == 0) {
      m_g[g] = m;
      l_g[g] = l;
    }
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int k = 0; k < groups; ++k) mx = fmaxf(mx, m_g[k]);
  float sum = 0.f;
  for (int k = 0; k < groups; ++k) sum += l_g[k] * weight(m_g[k], mx);
  for (int d = tid; d < hd; d += kCombineThreads) {
    float v = 0.f;
    for (int k = 0; k < groups; ++k) {
      const float w = weight(m_g[k], mx);
      v += w > 0.f ? w * part[k * hd + d] : 0.f;
    }
    dtt::store(out + bh * hd + d, sum > 0.f ? v / sum : 0.f);
  }
}

template <typename T, int GC>
cudaError_t launch(const Args& a) {
  const int G = a.H / a.Hkv;
  const int row_bytes = a.hd * (int)sizeof(T);
  const int R = item_rows(a.ps, row_bytes);
  const int item_bytes = 2 * R * row_bytes;
  int Q, buffers;
  rounds_of(a.pps * ((a.ps + R - 1) / R), item_bytes, Q, buffers);
  const size_t smem = align16((size_t)a.pps * sizeof(int)) + (size_t)Q * buffers * item_bytes +
                      sizeof(float) * kWarps * GC * (a.hd + 2);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = dtt::allow_smem(paged_split_kv_kernel<T, GC>, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.splits, a.Hkv * ((G + GC - 1) / GC), a.B);
  paged_split_kv_kernel<T, GC><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
      static_cast<const T*>(a.v_pages), a.lengths, a.page_indices, static_cast<T*>(a.out),
      a.ws, a.H, a.Hkv, a.N, a.ps, a.hd, a.P, a.splits, a.pps, R, Q, buffers, a.scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const int groups = kCombineThreads / (a.hd / 4);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.H);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = sizeof(float) * (size_t)groups * (a.hd + 2);
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_combine_kernel<T>, static_cast<const float*>(a.ws),
                            static_cast<T*>(a.out), a.splits, a.hd);
}

template <typename T>
cudaError_t by_group(const Args& a) {
  const int G = a.H / a.Hkv;
  if (G == 1) return launch<T, 1>(a);
  if (G == 2) return launch<T, 2>(a);
  return launch<T, 4>(a);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// q (B, H, hd); k_pages/v_pages (Hkv, N, ps, hd); out (B, H, hd), all
// contiguous, 16-byte aligned and of type dtype; lengths (B,) and
// page_indices (B, P) int32. The walk is cut into `splits` splits of
// `pages_per_split` pages (splits * pages_per_split >= P, every split
// starting inside P); with splits > 1, workspace holds B * H * splits *
// (hd + 2) floats. Launches the split kernel and, for splits > 1, the
// combine, on `stream`. Returns the cudaError_t of the launches (0 =
// launched).
int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const void* lengths, const void* page_indices, void* out,
                 void* workspace, int B, int H, int Hkv, int N, int ps, int hd,
                 int P, int splits, int pages_per_split, float scale, int dtype,
                 void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || N <= 0 || ps <= 0 || hd <= 0 ||
      hd > 256 || hd % 8 || P <= 0 || splits <= 0 || pages_per_split <= 0 ||
      (long long)splits * pages_per_split < P || (long long)(splits - 1) * pages_per_split >= P ||
      (splits > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k_pages) || !aligned16(v_pages) || !aligned16(out) ||
      !aligned16(workspace))
    return cudaErrorMisalignedAddress;
  const Args a{q, k_pages, v_pages, static_cast<const int*>(lengths),
               static_cast<const int*>(page_indices), out, static_cast<float*>(workspace),
               B, H, Hkv, N, ps, hd, P, splits, pages_per_split, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == dtt::kF32) return static_cast<int>(by_group<float>(a));
  if (dtype == dtt::kBF16) return static_cast<int>(by_group<__nv_bfloat16>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
