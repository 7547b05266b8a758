// Flash attention for Hopper (sm_90a) on the tensor cores: the online-softmax
// forward/carry (K2) and the backward (K3).
//
// Layouts: q (BH, Sq, D), k/v (BH, Skv, D) in fp32 or bf16, row-major and
// contiguous; the carry o (BH, Sq, D) and m/l (BH, Sq) are fp32. 1 <= D <= 128.
//
// Replaces the TPU kernels
//   mxnet_tpu/pallas/flash_attention.py:_attn_kernel (K2, reached through
//     _carry_call / flash_attention_carry and the flash_attention forward):
//     flash_fwd_kernel;
//   mxnet_tpu/pallas/flash_attention.py:_bwd_kernel (K3, reached through
//     _bwd_flash): flash_bwd_dkdv_kernel + flash_bwd_dq_kernel.
//
// Bound on the card: operations. Per (query, key) pair the mask lets through
// and per head dim, the forward does 4 flops and the backward 10; at the LM's
// shape (8, 8, 512, 64) causal that is 2.15 and 5.38 GFLOP against 9 MB of
// traffic. bf16 runs on the tensor cores at 989 TFLOP/s (H100 SXM data sheet):
// forward 2.2 us. fp32 has to keep the reference's fp32 accuracy, which tf32
// alone (10 mantissa bits) does not: it runs as 3xTF32 (below), three tf32
// products of 495 TFLOP/s each, so 165 TFLOP/s: forward 13.0 us, backward
// 32.6 us. (On CUDA cores, 67 TFLOP/s, the same work takes 2.5x longer.)
//
// Design. One thread block per tile of 64 x NWG rows of the resident operand
// (queries for K2 and the dq kernel, keys for the dk/dv kernel) and one bh:
//  * warps 0 .. 4*NWG-1 are NWG consumer warpgroups of 64 rows each; the last
//    warp is the producer. It fills a ring of stages of the streamed operand
//    (K and V tiles of 64 keys for K2, three stages, two for fp32 at D > 64;
//    the same, two stages, for dq; Q and dO tiles of 64 queries with their
//    lse and delta, two stages, for dk/dv), each stage on a "full"
//    mbarrier, and refills a stage when the consumers' "empty" mbarrier says
//    it is free, so the loads of the next tiles overlap the products of
//    this one. (A producer warpgroup that gives its registers to the
//    consumers by setmaxnreg, with the next tile's Q.K^T issued before this
//    tile's softmax, measured no faster on the H100, so K2 stays this way.)
//  * Loads: by TMA where the row stride is a multiple of 16 bytes (D % 4 == 0
//    in fp32, D % 8 == 0 in bf16) and every input's base is 16-byte aligned,
//    one 4-d box per tile ({chunk of 16 bytes, rows, chunks, bh}; rows past S
//    and columns past D are zero-filled); otherwise the producer warp loads the
//    same tile with plain loads and zero-fills it. Both write the core-matrix
//    layout of hopper_mma.cuh, with D padded to DP = 32, 64 or 128; zero
//    columns add nothing to any product. Operands stay in their input type in
//    shared memory.
//  * bf16 products are wgmma (HGMMA) with fp32 accumulators: Q.K^T, dO.V^T
//    and K.Q^T, V.dO^T take both operands from shared memory, K-major; P.V,
//    P^T.dO, dS^T.Q and dS.K take P (or dS) from registers, rounded to bf16
//    in the accumulator's own layout (no shared-memory round trip), and B from
//    shared memory MN-major (transposed), which wgmma allows for 16-bit types.
//  * fp32 products are mma.sync.m16n8k8.tf32 (HMMA) in the split-TF32 scheme:
//    wgmma takes tf32 from shared memory only K-major, so P.V, P^T.dO, dS^T.Q
//    and dS.K would need a transposed copy of each tile; mma.sync reads its
//    fragments from the same tiles in any orientation and splits them in
//    registers. Its accumulator layout per warp equals wgmma's, so the softmax
//    and the epilogues are shared by both types.
//  * Online softmax on the accumulator fragment: a thread holds 2 rows; row
//    max and sum over the 4 threads of a row by shuffles; m, l in registers.
//  * Causal: key tiles wholly above a block's last row are never loaded; a
//    warpgroup skips tiles wholly above its own rows (exact: such a tile
//    leaves (o, m, l) unchanged) and masks only tiles that cross its diagonal
//    or the ragged end. Query tiles are scheduled heaviest first (reversed
//    block order), so the causal tail does not leave SMs idle.
//  * Backward: the TPU kernel accumulates dk/dv across its sequential q-block
//    axis. Blocks on Hopper run in parallel and in no order, so the backward
//    keeps two kernels and no atomics, hence deterministic: a K/V-major kernel
//    computes S^T = K.Q^T and dP^T = V.dO^T so that P^T and dS^T land in
//    registers as A operands of dV += P^T.dO and dK += dS^T.Q; a Q-major
//    kernel computes S, dP and dQ += dS.K. That is 7 products per pair and
//    dim where 5 would do with an ordered dq reduction: the price of
//    determinism without atomics. Both recompute p = exp(s - lse) from the
//    saved log-sum-exp; delta = rowsum(dO * O) comes in (the dk/dv
//    kernel's producer stages both beside each query tile).
//
// Numerics:
//  * 3xTF32: each fp32 operand x is split into hi = tf32(x) and
//    lo = tf32(x - hi), rounding to nearest with ties away from zero on the
//    low 13 mantissa bits (the plain helper split_tf32 in
//    kernels/flash_attention.py does the same), and each product is
//    lo.hi + hi.lo + hi.hi, as CUTLASS's OpMultiplyAddFastF32; no plain tf32.
//  * scores = (q . k) * scale in fp32; the mask is k_pos < kv_len and, when
//    causal, q_pos >= k_pos over global positions q_offset + row and
//    kv_offset + col; masked scores are the finite NEG_INF = -1e30 and p is
//    set to 0 where the mask is false (a row that has seen no visible key
//    keeps m = -1e30, where exp(s - m) would be 1). l sums the unrounded p.
//  * bf16 forward: p is rounded to bf16 before P.V, as the reference's
//    p.astype(v.dtype). bf16 backward: p and ds are computed in fp32 and
//    rounded to bf16 as the A operands of dV, dK and dQ (the reference keeps
//    them in fp32; SDPA's bf16 backward rounds them the same way). fp32 keeps
//    p and ds in fp32 (split like every operand).
//  * dq/dk/dv and the normalised output round once to the input type.
//    exp(x) is exp2f(x * log2(e)) (the special-function unit, 2 ulp, plus
//    the rounding of the product: within 1e-6 relative over the range the
//    softmax uses); logf is the accurate version.
//
// The launchers allocate nothing, launch on the caller's stream and return
// the first cudaError_t (cudaErrorInvalidValue if a tensor map is refused).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <initializer_list>

#include "hopper_mma.cuh"

namespace {

using namespace mxk;

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;  // rows of a warpgroup's tile

template <typename T> struct Ty;
template <> struct Ty<float> {
  using Raw = uint32_t;
  static constexpr bool kBf16 = false;
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};
template <> struct Ty<__nv_bfloat16> {
  using Raw = uint16_t;
  static constexpr bool kBf16 = true;
  static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};

struct FwdParams {
  const void *q, *k, *v;
  const float *o_in, *m_in, *l_in;
  float *o_out, *m_out, *l_out;
  void* out;
  float* lse;
  int sq, skv, d;
  int64_t q_off, kv_off;
  int causal, tma;
  float scale;
};

struct BwdParams {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int sq, skv, d;
  int causal, tma;
  float scale;
};

// -- tiles ----------------------------------------------------------------------

// fp32 value of element (r, c) of a core-matrix tile with R rows
template <typename T, int R>
__device__ __forceinline__ float lds(const char* tile, int r, int c) {
  constexpr int CW = 16 / sizeof(T);
  const T* p = reinterpret_cast<const T*>(tile + ((c / CW) * R + r) * 16) + (c % CW);
  return Ty<T>::load(*p);
}

// Rows [row0, row0 + R) of matrix `bh` of a (BH, s, d) tensor into a
// core-matrix tile of R rows and DP columns, called by all 32 lanes of the
// producer warp. TMA: lane 0 issues one box (the caller has announced its bytes
// on `bar`). Plain: the lanes copy 16-byte pieces, zero past s and d; the
// caller then fences and arrives.
template <typename T, int R, int DP>
__device__ __forceinline__ void load_tile(char* dst, const CUtensorMap& map, const void* src,
                                          int s, int d, int bh, int row0, uint64_t* bar,
                                          bool tma, int lane) {
  constexpr int CW = 16 / sizeof(T), NC = DP / CW;
  using Raw = typename Ty<T>::Raw;
  if (tma) {
    if (lane == 0) tma_load_4d(dst, &map, bar, 0, row0, 0, bh);
    return;
  }
  const Raw* base = static_cast<const Raw*>(src) + (int64_t)bh * s * d;
  for (int p = lane; p < NC * R; p += 32) {
    const int j = p / R, r = p - j * R, gr = row0 + r;
    union {
      uint4 u;
      Raw e[CW];
    } buf;
#pragma unroll
    for (int e = 0; e < CW; ++e) {
      const int c = j * CW + e;
      buf.e[e] = (gr < s && c < d) ? base[(int64_t)gr * d + c] : Raw(0);
    }
    *reinterpret_cast<uint4*>(dst + p * 16) = buf.u;
  }
}

// producer side of a barrier: TMA announces `bytes` first, plain loads arrive
// (all 32 lanes) after their stores are visible to the async proxy
__device__ __forceinline__ void produce_begin(uint64_t* bar, uint32_t bytes, bool tma, int lane) {
  if (tma && lane == 0) mbar_arrive_expect_tx(bar, bytes);
}
__device__ __forceinline__ void produce_end(uint64_t* bar, bool tma) {
  if (!tma) {
    fence_proxy_async();
    mbar_arrive(bar);
  }
}

// -- products -------------------------------------------------------------------

// acc (this warpgroup's 64 rows x BN) = A[a_row .. a_row + 64) . B[0 .. BN)^T over
// K = DP (columns >= d are zero; fp32 skips their k-steps, bf16 keeps its
// wgmma sequence free of branches, which measured faster); A has RA rows, B
// has BN = 64 rows.
// bf16 with kWait false: the products are left in flight, for the caller to
// wait on with wgmma_done (so that two products can overlap).
template <typename T, int RA, int BN, int DP, bool kWait = true>
__device__ __forceinline__ void gemm_nt(float (&acc)[BN / 2], const char* sA, int a_row,
                                        const char* sB, int d) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  if constexpr (Ty<T>::kBf16) {
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = gmma_desc(sA + a_row * 16 + kk * 2 * RA * 16, RA * 16, 128);
      const uint64_t db = gmma_desc(sB + kk * 2 * BN * 16, BN * 16, 128);
      wgmma_ss_m64n64k16(acc, da, db, 1);
    }
    wgmma_commit();
    if constexpr (kWait) {
      wgmma_wait0();
      reg_fence(acc);
    }
  } else {
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int ra = a_row + 16 * warp + g;
#pragma unroll
    for (int kb = 0; kb < DP / 8; ++kb) {
      if (8 * kb < d) {
        uint32_t ahi[4], alo[4];
        split_tf32(lds<float, RA>(sA, ra, 8 * kb + t), ahi[0], alo[0]);
        split_tf32(lds<float, RA>(sA, ra + 8, 8 * kb + t), ahi[1], alo[1]);
        split_tf32(lds<float, RA>(sA, ra, 8 * kb + t + 4), ahi[2], alo[2]);
        split_tf32(lds<float, RA>(sA, ra + 8, 8 * kb + t + 4), ahi[3], alo[3]);
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb) {
          uint32_t bhi[2], blo[2];
          split_tf32(lds<float, BN>(sB, 8 * nb + g, 8 * kb + t), bhi[0], blo[0]);
          split_tf32(lds<float, BN>(sB, 8 * nb + g, 8 * kb + t + 4), bhi[1], blo[1]);
          mma_3xtf32(&acc[nb * 4], ahi, alo, bhi, blo);
        }
      }
    }
  }
}

// acc (64 rows x DP) += P . B, P (64 rows x BK) in the accumulator layout of
// gemm_nt, B a tile of BK rows (the contraction) and DP columns. bf16: P is
// rounded to bf16. fp32: mma.sync's A fragment wants columns t and t + 4 where
// the accumulator holds 2t and 2t + 1, so the contraction index is permuted
// (k = t <-> col 2t, k = t + 4 <-> col 2t + 1) in P and in B's rows alike.
template <typename T, int BK, int DP, bool kWait = true>
__device__ __forceinline__ void gemm_pn(float (&acc)[DP / 2], const float (&p)[BK / 2],
                                        const char* sB) {
  if constexpr (Ty<T>::kBf16) {
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      a[kk][0] = pack_bf16(p[8 * kk + 0], p[8 * kk + 1]);
      a[kk][1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
      a[kk][2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
      a[kk][3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
    }
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = gmma_desc(sB + kk * 16 * 16, 128, BK * 16);
      if constexpr (DP == 32) wgmma_rs_m64n32k16(acc, a[kk], db, 1);
      else if constexpr (DP == 64) wgmma_rs_m64n64k16(acc, a[kk], db, 1);
      else wgmma_rs_m64n128k16(acc, a[kk], db, 1);
    }
    wgmma_commit();
    if constexpr (kWait) {
      wgmma_wait0();
      reg_fence(acc);
    }
  } else {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kb = 0; kb < BK / 8; ++kb) {
      uint32_t ahi[4], alo[4];
      split_tf32(p[kb * 4 + 0], ahi[0], alo[0]);
      split_tf32(p[kb * 4 + 2], ahi[1], alo[1]);
      split_tf32(p[kb * 4 + 1], ahi[2], alo[2]);
      split_tf32(p[kb * 4 + 3], ahi[3], alo[3]);
#pragma unroll
      for (int nb = 0; nb < DP / 8; ++nb) {
        uint32_t bhi[2], blo[2];
        split_tf32(lds<float, BK>(sB, 8 * kb + 2 * t, 8 * nb + g), bhi[0], blo[0]);
        split_tf32(lds<float, BK>(sB, 8 * kb + 2 * t + 1, 8 * nb + g), bhi[1], blo[1]);
        mma_3xtf32(&acc[nb * 4], ahi, alo, bhi, blo);
      }
    }
  }
}

// completes the products a gemm_* with kWait false left in flight
template <typename T, int N1, int N2>
__device__ __forceinline__ void wgmma_done(float (&a)[N1], float (&b)[N2]) {
  if constexpr (Ty<T>::kBf16) {
    wgmma_wait0();
    reg_fence(a);
    reg_fence(b);
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// exp(x) as exp2f(x * log2(e)): the tensor-core products leave the
// special-function unit as the next limit
__device__ __forceinline__ float exp_fast(float x) { return exp2f(x * kLog2e); }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a (64 x DP) accumulator's rows ra and ra + 8 to a (rows, d) matrix of OutT
template <typename OutT, int DP>
__device__ __forceinline__ void store_rows(OutT* dst, const float (&acc)[DP / 2], int ra,
                                           int rows, int d) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int r = ra + 8 * ((i >> 1) & 1), c = (i >> 2) * 8 + 2 * t + (i & 1);
    if (r < rows && c < d) dst[(int64_t)r * d + c] = Ty<OutT>::store(acc[i]);
  }
}

// the block's place in the grid: (tile, bh), tiles in reverse order when
// `reverse` (heaviest causal query tiles first); blocks start in linear order
__device__ __forceinline__ void block_tile(bool reverse, int& tile, int& bh) {
  const int n_bh = gridDim.y;
  const int lin = blockIdx.x + blockIdx.y * gridDim.x;
  tile = lin / n_bh;
  bh = lin - tile * n_bh;
  if (reverse) tile = gridDim.x - 1 - tile;
}

// ---------------------------------------------------------------------------
// K2: merge K/V into the online-softmax carry (o, m, l). With o_in == null the
// carry starts empty (o = 0, m = NEG_INF, l = 0). With out != null the epilogue
// normalises instead of storing the carry:
//   out = o / max(l, 1e-30) (in T), lse = m + log(max(l, 1e-30)).
constexpr int kFwdWG = 2;
constexpr int kFwdThreads = 128 * kFwdWG + 32;

// K/V stages in the ring: three where a row of DP columns takes at most 256
// bytes (every bf16 width, fp32 up to 64 columns), else two (fp32 at D > 64,
// where three would not fit beside Q)
template <typename T, int DP>
__host__ __device__ constexpr int fwd_stages() {
  return DP * sizeof(T) <= 256 ? 3 : 2;
}
template <typename T, int DP>
constexpr size_t fwd_smem() {
  return (size_t)(kTile * kFwdWG + 2 * kTile * fwd_stages<T, DP>()) * DP * sizeof(T) +
         8 * sizeof(uint64_t);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                 const __grid_constant__ CUtensorMap tmv, const FwdParams P) {
  constexpr int BQ = kTile * kFwdWG, BN = kTile, NS = fwd_stages<T, DP>();
  constexpr int QB = BQ * DP * sizeof(T), KB = BN * DP * sizeof(T);
  extern __shared__ __align__(1024) char smem[];
  char* sQ = smem;
  char* sK = sQ + QB;       // NS stages
  char* sV = sK + NS * KB;  // NS stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + NS * KB);
  uint64_t* bar_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + NS;

  int tile, bh;
  block_tile(P.causal, tile, bh);
  const int q0 = tile * BQ, sq = P.sq, skv = P.skv, d = P.d;
  const bool tma = P.tma;
  // keys [0, n_end) can be visible to some row of this block
  int n_end = skv;
  if (P.causal) {
    const int last = (q0 + BQ < sq ? q0 + BQ : sq) - 1;
    const int64_t lim = P.q_off + last - P.kv_off + 1;
    n_end = lim < 0 ? 0 : (lim < skv ? (int)lim : skv);
  }
  const int n_it = (n_end + BN - 1) / BN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, tma ? 1 : 32);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], tma ? 1 : 32);
      mbar_init(&empty[s], 4 * kFwdWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * kFwdWG) {  // producer
    if (n_it == 0) return;
    produce_begin(bar_q, QB, tma, lane);
    load_tile<T, BQ, DP>(sQ, tmq, P.q, sq, d, bh, q0, bar_q, tma, lane);
    produce_end(bar_q, tma);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % NS;
      if (it >= NS) mbar_wait(&empty[st], (it / NS - 1) & 1);
      produce_begin(&full[st], 2 * KB, tma, lane);
      load_tile<T, BN, DP>(sK + st * KB, tmk, P.k, skv, d, bh, it * BN, &full[st], tma, lane);
      load_tile<T, BN, DP>(sV + st * KB, tmv, P.v, skv, d, bh, it * BN, &full[st], tma, lane);
      produce_end(&full[st], tma);
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64); this thread
  // rows ra and ra + 8
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int ra = kTile * wg + 16 * (warp & 3) + g;
  const int first = q0 + kTile * wg;
  const int last = (first + kTile < sq ? first + kTile : sq) - 1;
  const int64_t rowbase = (int64_t)bh * sq + q0;
  float o[DP / 2], m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    const bool live = P.o_in != nullptr && q0 + r < sq;
    m[h] = live ? P.m_in[rowbase + r] : kNegInf;
    l[h] = live ? P.l_in[rowbase + r] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    const int r = ra + 8 * ((i >> 1) & 1), c = (i >> 2) * 8 + 2 * t + (i & 1);
    o[i] = (P.o_in != nullptr && q0 + r < sq && c < d) ? P.o_in[(rowbase + r) * d + c] : 0.0f;
  }

  const int64_t qpos[2] = {P.q_off + q0 + ra, P.q_off + q0 + ra + 8};
  if (n_it > 0) mbar_wait(bar_q, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % NS;
    mbar_wait(&full[st], (it / NS) & 1);
    const int k0 = it * BN;
    const int64_t kpos0 = P.kv_off + k0;
    // a tile wholly above this warpgroup's rows leaves its carry unchanged
    const bool skip = first >= sq || (P.causal && kpos0 > P.q_off + last);
    const bool masked = k0 + BN > skv || (P.causal && kpos0 + BN - 1 > P.q_off + first);
    if (!skip) {
      float s[BN / 2];
      gemm_nt<T, BQ, BN, DP>(s, sQ, kTile * wg, sK + st * KB, d);
      uint32_t ok = 0xffffffffu;
      float bmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i >> 1) & 1, c = (i >> 2) * 8 + 2 * t + (i & 1);
        bool vis = true;
        if (masked) vis = k0 + c < skv && (!P.causal || qpos[h] >= kpos0 + c);
        if (!vis) ok &= ~(1u << i);
        s[i] = vis ? s[i] * P.scale : kNegInf;
        bmax[h] = fmaxf(bmax[h], s[i]);
      }
      float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(bmax[h]));
        corr[h] = exp_fast(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i >> 1) & 1;
        s[i] = ((ok >> i) & 1u) ? exp_fast(s[i] - m[h]) : 0.0f;
        psum[h] += s[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(psum[h]);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      gemm_pn<T, BN, DP>(o, s, sV + st * KB);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  const int rows = sq - q0;
  if (P.out != nullptr) {
    float lm[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) lm[h] = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = o[i] / lm[(i >> 1) & 1];
    store_rows<T, DP>(static_cast<T*>(P.out) + rowbase * d, o, ra, rows, d);
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (ra + 8 * h < rows) P.lse[rowbase + ra + 8 * h] = m[h] + logf(lm[h]);
    }
  } else {
    store_rows<float, DP>(P.o_out + rowbase * d, o, ra, rows, d);
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (ra + 8 * h < rows) {
          P.m_out[rowbase + ra + 8 * h] = m[h];
          P.l_out[rowbase + ra + 8 * h] = l[h];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// K3. One consumer warpgroup and a producer warp per block: at D 128 in bf16
// a block takes 96 KB of shared memory (two fit on an SM; the dq kernel runs
// two, the dk/dv kernel one, for its registers: see dkdv_min_blocks).
constexpr int kBwdThreads = 128 + 32;

template <typename T, int DP>
constexpr size_t dkdv_smem() {
  return (size_t)(2 * kTile + 4 * kTile) * DP * sizeof(T) + 4 * kTile * sizeof(float) +
         8 * sizeof(uint64_t);
}
template <typename T, int DP>
constexpr size_t dq_smem() {
  return (size_t)(2 * kTile + 4 * kTile) * DP * sizeof(T) + 8 * sizeof(uint64_t);
}
// Blocks per SM the register budget is cut for. Two at D <= 64 (dk/dv and
// dq), and for the bf16 dq kernel at D 128. The dk/dv kernel at D 128 keeps
// dk, dv, s^T and dp^T (64 + 64 + 32 + 32 floats a thread) and takes the
// registers of one block: cut for two, its four products spill and serialise
// (5.7x slower at (2, 16, 2048, 128) bf16, measured on the H100), though its
// 96 KB of shared memory would let two blocks in.
template <int DP>
__host__ __device__ constexpr int dkdv_min_blocks() {
  return DP <= 64 ? 2 : 1;
}
template <typename T, int DP>
__host__ __device__ constexpr int dq_min_blocks() {
  return (Ty<T>::kBf16 || DP <= 64) ? 2 : 1;
}

// p = exp(s * scale - lse) where visible, else 0; ds = p * (dp - delta) * scale;
// s and dp become p and ds in place
__device__ __forceinline__ void bwd_p_ds(float& s, float& dp, bool vis, float lse, float delta,
                                         float scale) {
  const float p = vis ? exp_fast(s * scale - lse) : 0.0f;
  s = p;
  dp = p * (dp - delta) * scale;
}

// K3a: one block per (64-key tile, bh) accumulates dk and dv over the query
// tiles; this thread owns keys ra and ra + 8 of the tile.
template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads, (dkdv_min_blocks<DP>()))
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv,
                      const __grid_constant__ CUtensorMap tmg, const BwdParams P) {
  constexpr int BK = kTile, BN = kTile;
  constexpr int KB = BK * DP * sizeof(T), QB = BN * DP * sizeof(T);
  extern __shared__ __align__(1024) char smem[];
  char* sK = smem;
  char* sV = sK + KB;
  char* sQ = sV + KB;      // 2 stages
  char* sG = sQ + 2 * QB;  // 2 stages
  float* sL = reinterpret_cast<float*>(sG + 2 * QB);  // lse, 2 stages of BN
  float* sD = sL + 2 * BN;                            // delta, likewise
  uint64_t* bars = reinterpret_cast<uint64_t*>(sD + 2 * BN);
  uint64_t* bar_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 3;

  int tile, bh;
  block_tile(false, tile, bh);  // under the causal mask tile 0 is the heaviest
  const int c0 = tile * BK, sq = P.sq, skv = P.skv, d = P.d;
  const bool tma = P.tma;
  const int r_start = P.causal ? c0 : 0;  // queries below c0 see none of these keys
  const int n_it = r_start < sq ? (sq - r_start + BN - 1) / BN : 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, tma ? 1 : 32);
    for (int s = 0; s < 2; ++s) {
      // every lane arrives after storing its share of lse and delta; with
      // TMA, lane 0 also announces the tiles' bytes
      mbar_init(&full[s], tma ? 33 : 32);
      mbar_init(&empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (n_it == 0) return;
    produce_begin(bar_kv, 2 * KB, tma, lane);
    load_tile<T, BK, DP>(sK, tmk, P.k, skv, d, bh, c0, bar_kv, tma, lane);
    load_tile<T, BK, DP>(sV, tmv, P.v, skv, d, bh, c0, bar_kv, tma, lane);
    produce_end(bar_kv, tma);
    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1, r0 = r_start + it * BN;
      if (it >= 2) mbar_wait(&empty[st], ((it >> 1) - 1) & 1);
      produce_begin(&full[st], 2 * QB, tma, lane);
      load_tile<T, BN, DP>(sQ + st * QB, tmq, P.q, sq, d, bh, r0, &full[st], tma, lane);
      load_tile<T, BN, DP>(sG + st * QB, tmg, P.g, sq, d, bh, r0, &full[st], tma, lane);
      const int64_t qbase = (int64_t)bh * sq;
      for (int i = lane; i < BN; i += 32) {
        const bool live = r0 + i < sq;
        sL[st * BN + i] = live ? P.lse[qbase + r0 + i] : 0.0f;
        sD[st * BN + i] = live ? P.delta[qbase + r0 + i] : 0.0f;
      }
      if (!tma) fence_proxy_async();
      mbar_arrive(&full[st]);
    }
    return;
  }

  const int t = lane & 3;
  const int ra = 16 * warp + (lane >> 2);
  const int kpos[2] = {c0 + ra, c0 + ra + 8};
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.0f;

  if (n_it > 0) mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, r0 = r_start + it * BN;
    mbar_wait(&full[st], (it >> 1) & 1);
    const bool masked = r0 + BN > sq || c0 + BK > skv || (P.causal && r0 < c0 + BK - 1);
    float s[BN / 2], dp[BN / 2];
    gemm_nt<T, BK, BN, DP, false>(s, sK, 0, sQ + st * QB, d);   // S^T = K . Q^T
    gemm_nt<T, BK, BN, DP, false>(dp, sV, 0, sG + st * QB, d);  // dP^T = V . dO^T
    wgmma_done<T>(s, dp);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int h = (i >> 1) & 1, col = (i >> 2) * 8 + 2 * t + (i & 1), qr = r0 + col;
      bool vis = true;
      if (masked) vis = qr < sq && kpos[h] < skv && (!P.causal || qr >= kpos[h]);
      bwd_p_ds(s[i], dp[i], vis, sL[st * BN + col], sD[st * BN + col], P.scale);
    }
    gemm_pn<T, BN, DP, false>(dv, s, sG + st * QB);   // dV += P^T . dO
    gemm_pn<T, BN, DP, false>(dk, dp, sQ + st * QB);  // dK += dS^T . Q
    wgmma_done<T>(dv, dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  const int64_t kbase = ((int64_t)bh * skv + c0) * d;
  store_rows<T, DP>(static_cast<T*>(P.dk) + kbase, dk, ra, skv - c0, d);
  store_rows<T, DP>(static_cast<T*>(P.dv) + kbase, dv, ra, skv - c0, d);
}

// K3b: one block per (64-query tile, bh) accumulates dq = ds k over the key
// tiles; this thread owns rows ra and ra + 8 of the tile.
template <typename T, int DP>
__global__ void __launch_bounds__(kBwdThreads, (dq_min_blocks<T, DP>()))
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tmq,
                    const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const __grid_constant__ CUtensorMap tmg, const BwdParams P) {
  constexpr int BQ = kTile, BN = kTile;
  constexpr int QB = BQ * DP * sizeof(T), KB = BN * DP * sizeof(T);
  extern __shared__ __align__(1024) char smem[];
  char* sQ = smem;
  char* sG = sQ + QB;
  char* sK = sG + QB;      // 2 stages
  char* sV = sK + 2 * KB;  // 2 stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + 2 * KB);
  uint64_t* bar_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 3;

  int tile, bh;
  block_tile(P.causal, tile, bh);
  const int r0 = tile * BQ, sq = P.sq, skv = P.skv, d = P.d;
  const bool tma = P.tma;
  int n_end = skv;
  if (P.causal) {
    const int last = (r0 + BQ < sq ? r0 + BQ : sq) - 1;
    n_end = last + 1 < skv ? last + 1 : skv;
  }
  const int n_it = (n_end + BN - 1) / BN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, tma ? 1 : 32);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], tma ? 1 : 32);
      mbar_init(&empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (n_it == 0) return;
    produce_begin(bar_q, 2 * QB, tma, lane);
    load_tile<T, BQ, DP>(sQ, tmq, P.q, sq, d, bh, r0, bar_q, tma, lane);
    load_tile<T, BQ, DP>(sG, tmg, P.g, sq, d, bh, r0, bar_q, tma, lane);
    produce_end(bar_q, tma);
    for (int it = 0; it < n_it; ++it) {
      const int st = it & 1;
      if (it >= 2) mbar_wait(&empty[st], ((it >> 1) - 1) & 1);
      produce_begin(&full[st], 2 * KB, tma, lane);
      load_tile<T, BN, DP>(sK + st * KB, tmk, P.k, skv, d, bh, it * BN, &full[st], tma, lane);
      load_tile<T, BN, DP>(sV + st * KB, tmv, P.v, skv, d, bh, it * BN, &full[st], tma, lane);
      produce_end(&full[st], tma);
    }
    return;
  }

  const int t = lane & 3;
  const int ra = 16 * warp + (lane >> 2);
  const int qpos[2] = {r0 + ra, r0 + ra + 8};
  const int64_t qbase = (int64_t)bh * sq;
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = qpos[h] < sq;
    lse[h] = live ? P.lse[qbase + qpos[h]] : 0.0f;
    delta[h] = live ? P.delta[qbase + qpos[h]] : 0.0f;
  }
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;

  if (n_it > 0) mbar_wait(bar_q, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1, k0 = it * BN;
    mbar_wait(&full[st], (it >> 1) & 1);
    const bool masked = k0 + BN > skv || r0 + BQ > sq || (P.causal && k0 + BN - 1 > r0);
    float s[BN / 2], dp[BN / 2];
    gemm_nt<T, BQ, BN, DP, false>(s, sQ, 0, sK + st * KB, d);   // S = Q . K^T
    gemm_nt<T, BQ, BN, DP, false>(dp, sG, 0, sV + st * KB, d);  // dP = dO . V^T
    wgmma_done<T>(s, dp);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int h = (i >> 1) & 1, kc = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
      bool vis = true;
      if (masked) vis = qpos[h] < sq && kc < skv && (!P.causal || qpos[h] >= kc);
      bwd_p_ds(s[i], dp[i], vis, lse[h], delta[h], P.scale);
    }
    gemm_pn<T, BN, DP>(dq, dp, sK + st * KB);  // dQ += dS . K
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  store_rows<T, DP>(static_cast<T*>(P.dq) + (qbase + r0) * d, dq, ra, sq - r0, d);
}

// ---------------------------------------------------------------------------
// host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// the 4-d map {16-byte chunk, rows, chunks, bh} of a (bh, s, d) tensor whose
// box fills a core-matrix tile of `rows` rows and DP columns
template <typename T>
bool encode_map(CUtensorMap* map, const void* ptr, int bh, int s, int d, int rows, int dp) {
  constexpr int E = sizeof(T), CW = 16 / E;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)CW, (cuuint64_t)s, (cuuint64_t)(d / CW), (cuuint64_t)bh};
  const cuuint64_t strides[3] = {(cuuint64_t)d * E, 16, (cuuint64_t)s * d * E};
  const cuuint32_t box[4] = {(cuuint32_t)CW, (cuuint32_t)rows, (cuuint32_t)(dp / CW), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapDataType ty =
      E == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, ty, 4, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA takes a tensor when its rows are whole 16-byte units and its base is
// 16-byte aligned
template <typename T>
bool tma_ok(int d, std::initializer_list<const void*> ptrs) {
  if ((d * (int)sizeof(T)) % 16 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DP>
cudaError_t fwd_typed(FwdParams P, int bh, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  memset(&mq, 0, sizeof(mq));
  memset(&mk, 0, sizeof(mk));
  memset(&mv, 0, sizeof(mv));
  P.tma = P.skv > 0 && tma_ok<T>(P.d, {P.q, P.k, P.v});
  if (P.tma && !(encode_map<T>(&mq, P.q, bh, P.sq, P.d, kTile * kFwdWG, DP) &&
                 encode_map<T>(&mk, P.k, bh, P.skv, P.d, kTile, DP) &&
                 encode_map<T>(&mv, P.v, bh, P.skv, P.d, kTile, DP)))
    return cudaErrorInvalidValue;
  const size_t smem = fwd_smem<T, DP>();
  auto kernel = flash_fwd_kernel<T, DP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P.sq + kTile * kFwdWG - 1) / (kTile * kFwdWG), bh);
  kernel<<<grid, kFwdThreads, smem, stream>>>(mq, mk, mv, P);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t bwd_typed(BwdParams P, int bh, cudaStream_t stream) {
  constexpr int BN = kTile;
  CUtensorMap mq, mk, mv, mg, mq2, mg2;
  for (CUtensorMap* m : {&mq, &mk, &mv, &mg, &mq2, &mg2}) memset(m, 0, sizeof(*m));
  P.tma = P.sq > 0 && P.skv > 0 && tma_ok<T>(P.d, {P.q, P.k, P.v, P.g});
  // dk/dv streams Q and dO in BN-row tiles; dq holds them in 64-row tiles
  if (P.tma && !(encode_map<T>(&mq, P.q, bh, P.sq, P.d, BN, DP) &&
                 encode_map<T>(&mg, P.g, bh, P.sq, P.d, BN, DP) &&
                 encode_map<T>(&mq2, P.q, bh, P.sq, P.d, kTile, DP) &&
                 encode_map<T>(&mg2, P.g, bh, P.sq, P.d, kTile, DP) &&
                 encode_map<T>(&mk, P.k, bh, P.skv, P.d, kTile, DP) &&
                 encode_map<T>(&mv, P.v, bh, P.skv, P.d, kTile, DP)))
    return cudaErrorInvalidValue;
  auto kdkdv = flash_bwd_dkdv_kernel<T, DP>;
  auto kdq = flash_bwd_dq_kernel<T, DP>;
  const size_t s1 = dkdv_smem<T, DP>(), s2 = dq_smem<T, DP>();
  cudaError_t err = allow_smem(kdkdv, s1);
  if (err == cudaSuccess) err = allow_smem(kdq, s2);
  if (err != cudaSuccess) return err;
  if (P.skv > 0) {
    kdkdv<<<dim3((P.skv + kTile - 1) / kTile, bh), kBwdThreads, s1, stream>>>(mq, mk, mv, mg, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (P.sq > 0) {
    kdq<<<dim3((P.sq + kTile - 1) / kTile, bh), kBwdThreads, s2, stream>>>(mq2, mk, mv, mg2, P);
    err = cudaGetLastError();
  }
  return err;
}

// DP = the head dim padded to 32, 64 or 128 columns
#define MX_DISPATCH_DP(d, FN, ...) \
  ((d) <= 32 ? FN<T, 32>(__VA_ARGS__) : (d) <= 64 ? FN<T, 64>(__VA_ARGS__) : FN<T, 128>(__VA_ARGS__))

template <typename T>
cudaError_t fwd_dispatch(const FwdParams& P, int bh, cudaStream_t s) {
  return MX_DISPATCH_DP(P.d, fwd_typed, P, bh, s);
}
template <typename T>
cudaError_t bwd_dispatch(const BwdParams& P, int bh, cudaStream_t s) {
  return MX_DISPATCH_DP(P.d, bwd_typed, P, bh, s);
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
  FwdParams P;
  P.q = q;
  P.k = k;
  P.v = v;
  P.o_in = static_cast<const float*>(o_in);
  P.m_in = static_cast<const float*>(m_in);
  P.l_in = static_cast<const float*>(l_in);
  P.o_out = static_cast<float*>(o_out);
  P.m_out = static_cast<float*>(m_out);
  P.l_out = static_cast<float*>(l_out);
  P.out = out;
  P.lse = static_cast<float*>(lse);
  P.sq = (int)sq;
  P.skv = (int)skv;
  P.d = d;
  P.q_off = q_offset;
  P.kv_off = kv_offset;
  P.causal = causal;
  P.tma = 0;
  P.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return fwd_dispatch<float>(P, (int)bh, s);
    case 1:
      return fwd_dispatch<__nv_bfloat16>(P, (int)bh, s);
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
  BwdParams P;
  P.q = q;
  P.k = k;
  P.v = v;
  P.g = g;
  P.lse = static_cast<const float*>(lse);
  P.delta = static_cast<const float*>(delta);
  P.dq = dq;
  P.dk = dk;
  P.dv = dv;
  P.sq = (int)sq;
  P.skv = (int)skv;
  P.d = d;
  P.causal = causal;
  P.tma = 0;
  P.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return bwd_dispatch<float>(P, (int)bh, s);
    case 1:
      return bwd_dispatch<__nv_bfloat16>(P, (int)bh, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
