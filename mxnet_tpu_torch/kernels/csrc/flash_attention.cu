// Flash attention for Hopper (sm_90a): the online-softmax forward/carry (K2)
// and the backward (K3).
//
// Layouts: q (BH, Sq, D), k/v (BH, Skv, D) in fp32 or bf16, row-major and
// contiguous; the carry o (BH, Sq, D) and m/l (BH, Sq) are fp32. D <= 128.
//
// Replaces the TPU kernels
//   mxnet_tpu/pallas/flash_attention.py:_attn_kernel (K2, reached through
//     _carry_call / flash_attention_carry and the flash_attention forward)
//   mxnet_tpu/pallas/flash_attention.py:_bwd_kernel (K3, reached through
//     _bwd_flash).
//
// Bound on the card: operations. At D = 64 each query row does 4*Skv*D
// flops forward (10*Skv*D backward) for 2*D elements of its own traffic,
// so above a few hundred keys the work, not the bytes, sets the least
// time: 4*BH*pairs*D flops over 67 TFLOP/s in fp32 (CUDA cores; no TF32,
// so the result stays within the reference's fp32 tolerances) or over
// 989 TFLOP/s in bf16 (H100 SXM data sheet), where `pairs` counts the
// (query, key) pairs the mask lets through. This first version computes
// every product in fp32 on CUDA cores for both input types; tensor-core
// (wgmma) tiles are later work.
//
// Design. The TPU kernel keeps the whole local K/V block in VMEM
// ((1, Skv, D) BlockSpecs); at Skv 8192, D 128 in fp32 that is 8 MB, far
// over a block's 227 KB of shared memory, so here K/V stream through
// shared memory in 64-key tiles:
//  * forward: one block of 256 threads per (64-query tile, bh). Thread
//    (ty, tx) of the 16x16 grid owns query rows ty + 16*i (i < 4): it
//    computes the scores of those rows against keys tx + 16*j (j < 4) and
//    accumulates output columns tx + 16*j (j < D/16) of the same rows, so
//    the running max m and denominator l of a row live in registers of
//    the 16 threads of one half-warp and merge by xor shuffles. K is
//    staged transposed and every tile is padded to an odd leading
//    dimension, so the shared-memory reads are free of bank conflicts.
//    Under a causal mask, key tiles wholly above the tile's last row are
//    skipped (exact: such a tile leaves (o, m, l) unchanged).
//  * backward: the TPU kernel accumulates dk/dv over the sequential
//    q-block grid axis into revisited output blocks. Blocks on Hopper run
//    in parallel and in no order, so the backward is two kernels with no
//    atomics, hence deterministic: a K/V-major kernel (one block per
//    64-key tile loops over query tiles, accumulating dk and dv in
//    registers) and a Q-major kernel (one block per 64-query tile loops
//    over key tiles, accumulating dq). Both recompute p = exp(s - lse)
//    from the saved log-sum-exp; delta = rowsum(dO * O) comes in.
//  * ragged Sq and Skv are masked in the kernel, not padded.
//
// Numerics carried over from the reference: scores = (q . k) * scale in
// fp32 (bf16 inputs widen exactly); the mask is k_pos < kv_len and, when
// causal, q_pos >= k_pos over global positions q_offset + row and
// kv_offset + col; masked scores are the finite NEG_INF = -1e30 and p is
// set to 0 where the mask is false (a row that has seen no visible key
// has m = -1e30, where exp(s - m) would be 1); for bf16 inputs p is
// rounded to bf16 before p.V while l sums the unrounded p; the backward
// computes in fp32 and rounds dq/dk/dv once to the input type.
// expf/logf are the accurate versions (no fast-math).
//
// The launchers allocate nothing, launch on the caller's stream and
// return cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // a 16 x 16 grid of threads
constexpr int kLdS = kBK + 1;    // leading dim of score and transposed tiles
constexpr float kNegInf = -1e30f;

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float round_p(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
  // p.astype(v.dtype) before the p.V product
  static __device__ __forceinline__ float round_p(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [r0, r0 + kBQ) of a (rows, d) matrix into a (kBQ, ld) fp32 tile;
// rows past `rows` are zero
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, int r0, int rows,
                                          int d) {
  for (int idx = threadIdx.x; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const int gr = r0 + r;
    dst[r * ld + c] = gr < rows ? Cvt<T>::load(src[(int64_t)gr * d + c]) : 0.0f;
  }
}

// rows [r0, r0 + kBK) of a (rows, d) matrix, transposed into a (d, kLdS)
// fp32 tile; rows past `rows` are zero
template <typename T>
__device__ __forceinline__ void load_rows_t(float* dst, const T* src, int r0, int rows, int d) {
  for (int idx = threadIdx.x; idx < kBK * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const int gr = r0 + r;
    dst[c * kLdS + r] = gr < rows ? Cvt<T>::load(src[(int64_t)gr * d + c]) : 0.0f;
  }
}

__host__ __device__ constexpr int ld_rows(int d) { return d + 1; }

size_t fwd_smem_floats(int d) {
  return (size_t)kBQ * ld_rows(d) + (size_t)d * kLdS + (size_t)kBK * d + (size_t)kBQ * kLdS;
}

size_t bwd_smem_floats(int d) {
  return 2 * (size_t)kBQ * ld_rows(d) + 2 * (size_t)d * kLdS + 2 * (size_t)kBQ * kLdS + 2 * kBQ;
}

// ---------------------------------------------------------------------------
// K2: merge K/V into the online-softmax carry (o, m, l). With o_in == null
// the carry starts empty (o = 0, m = NEG_INF, l = 0). With out != null the
// epilogue normalises instead of storing the carry:
//   out = o / max(l, 1e-30) (in T), lse = m + log(max(l, 1e-30)).
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ o_in, const float* __restrict__ m_in,
                 const float* __restrict__ l_in, float* __restrict__ o_out,
                 float* __restrict__ m_out, float* __restrict__ l_out, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int skv, int d, int64_t q_off, int64_t kv_off,
                 int causal, float scale) {
  extern __shared__ float smem[];
  const int ldq = ld_rows(d);
  float* sQ = smem;                       // (kBQ, ldq)
  float* sKT = sQ + kBQ * ldq;            // (d, kLdS)
  float* sV = sKT + d * kLdS;             // (kBK, d)
  float* sP = sV + kBK * d;               // (kBQ, kLdS)
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qb = q + (int64_t)bh * sq * d;
  const T* kb = k + (int64_t)bh * skv * d;
  const T* vb = v + (int64_t)bh * skv * d;

  load_rows(sQ, ldq, qb, q0, sq, d);

  float acc[4][DC], mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    const int64_t row = (int64_t)bh * sq + gr;
    const bool live = o_in != nullptr && gr < sq;
    mrow[i] = live ? m_in[row] : kNegInf;
    lrow[i] = live ? l_in[row] : 0.0f;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int dc = tx + 16 * j;
      acc[i][j] = (live && dc < d) ? o_in[row * d + dc] : 0.0f;
    }
  }

  // keys [0, n_end) can be visible to some row of this tile
  int n_end = skv;
  if (causal) {
    const int last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
    const int64_t lim = q_off + last - kv_off + 1;
    n_end = lim < 0 ? 0 : (lim < skv ? (int)lim : skv);
  }

  for (int k0 = 0; k0 < n_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads of sKT/sV/sP are done
    load_rows_t(sKT, kb, k0, skv, d);
    for (int idx = threadIdx.x; idx < kBK * d; idx += kThreads) {
      const int r = idx / d;
      sV[idx] = k0 + r < skv ? Cvt<T>::load(vb[(int64_t)k0 * d + idx]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int dd = 0; dd < d; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * ldq + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sKT[dd * kLdS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t q_pos = q_off + q0 + ty + 16 * i;
      bool ok[4];
      float bmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gc = k0 + tx + 16 * j;
        ok[j] = gc < skv && (!causal || q_pos >= kv_off + gc);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        bmax = fmaxf(bmax, s[i][j]);
      }
      bmax = half_warp_max(bmax);
      const float m_new = fmaxf(mrow[i], bmax);
      const float corr = expf(mrow[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        psum += p;
        sP[(ty + 16 * i) * kLdS + tx + 16 * j] = Cvt<T>::round_p(p);
      }
      psum = half_warp_sum(psum);
      lrow[i] = lrow[i] * corr + psum;
      mrow[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    const int kn = skv - k0 < kBK ? skv - k0 : kBK;
    for (int c = 0; c < kn; ++c) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kLdS + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int dc = tx + 16 * j;
        vv[j] = dc < d ? sV[c * d + dc] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    if (gr >= sq) continue;
    const int64_t row = (int64_t)bh * sq + gr;
    if (out != nullptr) {
      const float lm = fmaxf(lrow[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int dc = tx + 16 * j;
        if (dc < d) out[row * d + dc] = Cvt<T>::store(acc[i][j] / lm);
      }
      if (tx == 0) lse[row] = mrow[i] + logf(lm);
    } else {
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int dc = tx + 16 * j;
        if (dc < d) o_out[row * d + dc] = acc[i][j];
      }
      if (tx == 0) {
        m_out[row] = mrow[i];
        l_out[row] = lrow[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3, shared step: for the query tile in sQ/sG (rows r0..) and the key tile
// in sKT/sVT (keys c0..), p = exp(s - lse) and ds = p * (dp - delta) * scale
// into sP and sS; thread (ty, tx) computes rows ty + 16*i, keys tx + 16*j.
__device__ __forceinline__ void bwd_scores(const float* sQ, const float* sG, const float* sKT,
                                           const float* sVT, const float* sL, const float* sD,
                                           float* sP, float* sS, int ldq, int d, int r0,
                                           int c0, int sq, int skv, int causal, float scale) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
  for (int dd = 0; dd < d; ++dd) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = sQ[(ty + 16 * i) * ldq + dd];
      gv[i] = sG[(ty + 16 * i) * ldq + dd];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = sKT[dd * kLdS + tx + 16 * j];
      vv[j] = sVT[dd * kLdS + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int gr = r0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int gc = c0 + c;
      const bool ok = gr < sq && gc < skv && (!causal || gr >= gc);
      const float p = ok ? expf(s[i][j] * scale - sL[r]) : 0.0f;
      sP[r * kLdS + c] = p;
      sS[r * kLdS + c] = p * (dp[i][j] - sD[r]) * scale;
    }
  }
}

__device__ __forceinline__ void load_stats(float* sL, float* sD, const float* lse,
                                           const float* delta, int64_t base, int r0, int sq) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool live = r0 + r < sq;
    sL[r] = live ? lse[base + r0 + r] : 0.0f;
    sD[r] = live ? delta[base + r0 + r] : 0.0f;
  }
}

// K3a: one block per (64-key tile, bh) accumulates dk and dv over the
// query tiles; thread (ty, tx) owns keys ty + 16*i, columns tx + 16*j.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int sq, int skv, int d,
                      int causal, float scale) {
  extern __shared__ float smem[];
  const int ldq = ld_rows(d);
  float* sQ = smem;                      // (kBQ, ldq)
  float* sG = sQ + kBQ * ldq;            // (kBQ, ldq)
  float* sKT = sG + kBQ * ldq;           // (d, kLdS)
  float* sVT = sKT + d * kLdS;           // (d, kLdS)
  float* sP = sVT + d * kLdS;            // (kBQ, kLdS)
  float* sS = sP + kBQ * kLdS;           // (kBQ, kLdS)
  float* sL = sS + kBQ * kLdS;           // (kBQ,)
  float* sD = sL + kBQ;                  // (kBQ,)
  const int bh = blockIdx.y;
  const int c0 = blockIdx.x * kBK;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qbase = (int64_t)bh * sq;
  const int64_t kbase = (int64_t)bh * skv;

  load_rows_t(sKT, k + kbase * d, c0, skv, d);
  load_rows_t(sVT, v + kbase * d, c0, skv, d);

  float adk[4][DC], adv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) adk[i][j] = adv[i][j] = 0.0f;

  // causal: query rows below c0 see none of these keys
  for (int r0 = causal ? c0 : 0; r0 < sq; r0 += kBQ) {
    __syncthreads();  // the previous tile's reads are done
    load_rows(sQ, ldq, q + qbase * d, r0, sq, d);
    load_rows(sG, ldq, g + qbase * d, r0, sq, d);
    load_stats(sL, sD, lse, delta, qbase, r0, sq);
    __syncthreads();
    bwd_scores(sQ, sG, sKT, sVT, sL, sD, sP, sS, ldq, d, r0, c0, sq, skv, causal, scale);
    __syncthreads();
    const int rn = sq - r0 < kBQ ? sq - r0 : kBQ;
    for (int r = 0; r < rn; ++r) {
      float pv[4], sv[4], gv[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[r * kLdS + ty + 16 * i];
        sv[i] = sS[r * kLdS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int dc = tx + 16 * j;
        gv[j] = dc < d ? sG[r * ldq + dc] : 0.0f;
        qv[j] = dc < d ? sQ[r * ldq + dc] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          adv[i][j] = fmaf(pv[i], gv[j], adv[i][j]);   // dv += p^T g
          adk[i][j] = fmaf(sv[i], qv[j], adk[i][j]);   // dk += ds^T q
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gc = c0 + ty + 16 * i;
    if (gc >= skv) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int dc = tx + 16 * j;
      if (dc < d) {
        dk[(kbase + gc) * d + dc] = Cvt<T>::store(adk[i][j]);
        dv[(kbase + gc) * d + dc] = Cvt<T>::store(adv[i][j]);
      }
    }
  }
}

// K3b: one block per (64-query tile, bh) accumulates dq = ds k over the
// key tiles; thread (ty, tx) owns rows ty + 16*i, columns tx + 16*j.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int sq, int skv, int d,
                    int causal, float scale) {
  extern __shared__ float smem[];
  const int ldq = ld_rows(d);
  float* sQ = smem;
  float* sG = sQ + kBQ * ldq;
  float* sKT = sG + kBQ * ldq;
  float* sVT = sKT + d * kLdS;
  float* sP = sVT + d * kLdS;
  float* sS = sP + kBQ * kLdS;
  float* sL = sS + kBQ * kLdS;
  float* sD = sL + kBQ;
  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * kBQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qbase = (int64_t)bh * sq;
  const int64_t kbase = (int64_t)bh * skv;

  load_rows(sQ, ldq, q + qbase * d, r0, sq, d);
  load_rows(sG, ldq, g + qbase * d, r0, sq, d);
  load_stats(sL, sD, lse, delta, qbase, r0, sq);

  float adq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) adq[i][j] = 0.0f;

  int n_end = skv;
  if (causal) {
    const int last = (r0 + kBQ < sq ? r0 + kBQ : sq) - 1;
    n_end = last + 1 < skv ? last + 1 : skv;
  }
  for (int c0 = 0; c0 < n_end; c0 += kBK) {
    __syncthreads();
    load_rows_t(sKT, k + kbase * d, c0, skv, d);
    load_rows_t(sVT, v + kbase * d, c0, skv, d);
    __syncthreads();
    bwd_scores(sQ, sG, sKT, sVT, sL, sD, sP, sS, ldq, d, r0, c0, sq, skv, causal, scale);
    __syncthreads();
    const int kn = skv - c0 < kBK ? skv - c0 : kBK;
    for (int c = 0; c < kn; ++c) {
      float sv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sS[(ty + 16 * i) * kLdS + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int dc = tx + 16 * j;
        kv[j] = dc < d ? sKT[dc * kLdS + c] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) adq[i][j] = fmaf(sv[i], kv[j], adq[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r0 + ty + 16 * i;
    if (gr >= sq) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int dc = tx + 16 * j;
      if (dc < d) dq[(qbase + gr) * d + dc] = Cvt<T>::store(adq[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DC>
cudaError_t fwd_typed(const void* q, const void* k, const void* v, const void* o_in,
                      const void* m_in, const void* l_in, void* o_out, void* m_out, void* l_out,
                      void* out, void* lse, int bh, int sq, int skv, int d, int64_t q_off,
                      int64_t kv_off, int causal, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(d) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, DC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(o_in), static_cast<const float*>(m_in),
      static_cast<const float*>(l_in), static_cast<float*>(o_out), static_cast<float*>(m_out),
      static_cast<float*>(l_out), static_cast<T*>(out), static_cast<float*>(lse), sq, skv, d,
      q_off, kv_off, causal, scale);
  return cudaGetLastError();
}

template <typename T, int DC>
cudaError_t bwd_typed(const void* q, const void* k, const void* v, const void* g,
                      const void* lse, const void* delta, void* dq, void* dk, void* dv, int bh,
                      int sq, int skv, int d, int causal, float scale, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats(d) * sizeof(float);
  auto kdkdv = flash_bwd_dkdv_kernel<T, DC>;
  auto kdq = flash_bwd_dq_kernel<T, DC>;
  cudaError_t err = allow_smem(kdkdv, smem);
  if (err == cudaSuccess) err = allow_smem(kdq, smem);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const float* lt = static_cast<const float*>(lse);
  const float* dt = static_cast<const float*>(delta);
  if (skv > 0) {
    kdkdv<<<dim3((skv + kBK - 1) / kBK, bh), kThreads, smem, stream>>>(
        qt, kt, vt, gt, lt, dt, static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, d, causal,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (sq > 0) {
    kdq<<<dim3((sq + kBQ - 1) / kBQ, bh), kThreads, smem, stream>>>(
        qt, kt, vt, gt, lt, dt, static_cast<T*>(dq), sq, skv, d, causal, scale);
    err = cudaGetLastError();
  }
  return err;
}

// DC = columns per thread = ceil(d / 16), rounded up to 1, 2, 4 or 8
#define MX_DISPATCH_DC(d, FN, ...)                              \
  ((d) <= 16 ? FN<T, 1>(__VA_ARGS__)                            \
   : (d) <= 32 ? FN<T, 2>(__VA_ARGS__)                          \
   : (d) <= 64 ? FN<T, 4>(__VA_ARGS__)                          \
               : FN<T, 8>(__VA_ARGS__))

template <typename T>
cudaError_t fwd_dispatch(const void* q, const void* k, const void* v, const void* o_in,
                         const void* m_in, const void* l_in, void* o_out, void* m_out,
                         void* l_out, void* out, void* lse, int bh, int sq, int skv, int d,
                         int64_t q_off, int64_t kv_off, int causal, float scale,
                         cudaStream_t stream) {
  return MX_DISPATCH_DC(d, fwd_typed, q, k, v, o_in, m_in, l_in, o_out, m_out, l_out, out, lse,
                        bh, sq, skv, d, q_off, kv_off, causal, scale, stream);
}

template <typename T>
cudaError_t bwd_dispatch(const void* q, const void* k, const void* v, const void* g,
                         const void* lse, const void* delta, void* dq, void* dk, void* dv,
                         int bh, int sq, int skv, int d, int causal, float scale,
                         cudaStream_t stream) {
  return MX_DISPATCH_DC(d, bwd_typed, q, k, v, g, lse, delta, dq, dk, dv, bh, sq, skv, d,
                        causal, scale, stream);
}

bool shape_ok(int64_t bh, int64_t sq, int64_t skv, int d) {
  return bh > 0 && bh <= 65535 && sq >= 0 && sq < (1LL << 30) && skv >= 0 &&
         skv < (1LL << 30) && d >= 1 && d <= 128;
}

}  // namespace

// K2. Carry mode: o_in/m_in/l_in -> o_out/m_out/l_out (o_in == null starts
// from the empty carry). Normalised mode (out != null): writes out (in the
// input type) and lse instead of the carry. dtype_code: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int mx_flash_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* o_in, const void* m_in, const void* l_in,
                                      void* o_out, void* m_out, void* l_out, void* out,
                                      void* lse, int64_t bh, int64_t sq, int64_t skv, int d,
                                      int64_t q_offset, int64_t kv_offset, int causal,
                                      float scale, int dtype_code, void* stream) {
  if (!shape_ok(bh, sq, skv, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return fwd_dispatch<float>(q, k, v, o_in, m_in, l_in, o_out, m_out, l_out, out, lse,
                                 (int)bh, (int)sq, (int)skv, d, q_offset, kv_offset, causal,
                                 scale, s);
    case 1:
      return fwd_dispatch<__nv_bfloat16>(q, k, v, o_in, m_in, l_in, o_out, m_out, l_out, out,
                                         lse, (int)bh, (int)sq, (int)skv, d, q_offset,
                                         kv_offset, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3: dq, dk, dv (in the input type) from q, k, v, g = dO and the fp32
// lse and delta = rowsum(dO * O); two kernels on the caller's stream.
extern "C" int mx_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* g, const void* lse, const void* delta,
                                      void* dq, void* dk, void* dv, int64_t bh, int64_t sq,
                                      int64_t skv, int d, int causal, float scale,
                                      int dtype_code, void* stream) {
  if (!shape_ok(bh, sq, skv, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return bwd_dispatch<float>(q, k, v, g, lse, delta, dq, dk, dv, (int)bh, (int)sq,
                                 (int)skv, d, causal, scale, s);
    case 1:
      return bwd_dispatch<__nv_bfloat16>(q, k, v, g, lse, delta, dq, dk, dv, (int)bh,
                                         (int)sq, (int)skv, d, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
