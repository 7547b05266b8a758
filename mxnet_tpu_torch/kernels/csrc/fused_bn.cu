// Fused BatchNorm-apply + residual-add + ReLU (the ResNet block tail) for
// Hopper (sm_90a), forward and backward.
//
//     out[m, c] = max(x[m, c] * scale[c] + bias[c] (+ residual[m, c]), 0)
//
// over the channels-last (M = N*H*W, C) view of an NHWC activation, and its
// gradients from the saved forward, with mask = out > 0:
//
//     dx = g*mask * scale,   dres = g*mask,
//     dscale[c] = sum_m g*mask*x,   dbias[c] = sum_m g*mask.
//
// Replaces the TPU kernel mxnet_tpu/pallas/fused_bn.py:_kernel (with a
// residual) and :_kernel_nores (without), and the XLA custom VJP
// _fused_vjp_bwd of the same file (one XLA fusion there, one pass here).
//
// Bound on the card: memory. The forward moves 2 or 3 elements an output
// element for 2-3 flops, the backward 5 (g, out and x read; dx and dres
// written; the residual is never read) for ~6, far below the H100's ~20
// flops/byte ridge in fp32, so the least time is those bytes over 3.35 TB/s.
//
// Design: a grid of 256-thread blocks over rows. Within a block, `lanes`
// threads cover one row's channel vectors and the block holds 256 / lanes
// rows side by side, so a warp reads consecutive 16-byte vectors of a row
// (or of neighbouring rows when C is small). Each thread loads 4
// independent 16-byte vectors (4 fp32 or 8 bf16; scalars when C or a
// pointer does not allow vectors) before it computes, with streaming cache
// hints (__ldcs / __stcs): every element is touched once. The forward's
// grid is sized from the SM count and the kernel's occupancy (a
// grid-stride loop over rows); the backward's block b takes its own range
// of whole rows, given by the wrapper from the shape alone.
//
// A thread keeps a fixed set of channels for its block's life, so the
// coefficients are read once a block (fp32, rounded in-register to the
// activation's type, as scale.to(x.dtype) rounds them) and the backward's
// per-channel partial sums stay in registers until one combine at the
// block's end. The backward writes those fp32 partials to a (blocks, 2, C)
// scratch; a finishing kernel sums them in a fixed order. No atomics are
// used, so the same inputs give the same bits on every run and every card.
//
// A TMA design (a ring of 1-D bulk copies through shared memory, bulk
// stores back) was measured against these kernels on an H100 and removed:
// bit-equal, within 3.5% at the ResNet-50 block tails, and slower at some
// of them in each direction (PERF.md, PR 20), while these kernels are
// needed anyway for a ragged C and offset views.
//
// Arithmetic matches the plain PyTorch versions: the forward in fp32 with
// separately rounded multiply and add (no FMA contraction), bit-equal for
// fp32 input, rounded once on store for bf16; ReLU is `y < 0 ? 0 : y`,
// which keeps a NaN as NaN like torch.clamp_min. The backward's dx is the
// masked gradient times scale rounded to the working type, rounded once
// (PyTorch's bf16 multiply), and dres the masked gradient itself, both
// bit-equal to the plain version in fp32 and bf16; the reductions run in
// fp32 in another order than PyTorch's. Indices are int64: at batch 32 the
// first ResNet-50 stage alone is 25.7 M elements.
//
// The launchers allocate nothing, launch on the caller's stream and return
// cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // vectors in flight a thread

// -- element access ----------------------------------------------------------
// VEC elements of T widened to fp32 (16 bytes when VEC * sizeof(T) == 16, else
// one element), loaded and stored with the evict-first (streaming) hints
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 w = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = __ldcs(p); }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) { __stcs(p, v[0]); }
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 w = __ldcs(reinterpret_cast<const uint4*>(p));
    v[0] = bf16_lo(w.x); v[1] = bf16_hi(w.x); v[2] = bf16_lo(w.y); v[3] = bf16_hi(w.y);
    v[4] = bf16_lo(w.z); v[5] = bf16_hi(w.z); v[6] = bf16_lo(w.w); v[7] = bf16_hi(w.w);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 w;
    w.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
    w.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
    w.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
    w.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
    __stcs(reinterpret_cast<uint4*>(p), w);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __uint_as_float(static_cast<uint32_t>(
                               __ldcs(reinterpret_cast<const unsigned short*>(p))) << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
    __stcs(reinterpret_cast<unsigned short*>(p), static_cast<unsigned short>(bf16_bits(v[0])));
  }
};

// v rounded to T and widened back: the value scale.to(T) holds
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __uint_as_float(bf16_bits(v) << 16);
}

__device__ __forceinline__ float relu(float y) { return y < 0.0f ? 0.0f : y; }

// -- the element-wise work ----------------------------------------------------
// forward: o = relu(x * s + b (+ r)), separately rounded
template <int VEC, bool RES>
__device__ __forceinline__ void fwd_math(const float (&x)[VEC], const float (&r)[VEC],
                                         const float* s, const float* b, float (&o)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    float y = __fadd_rn(__fmul_rn(x[k], s[k]), b[k]);
    if (RES) y = __fadd_rn(y, r[k]);
    o[k] = relu(y);
  }
}

// backward: gm = g * (out > 0); dx = gm * s (s already rounded to T; the
// caller's store rounds the product once); dres = gm; partial sums of
// gm * x and gm in fp32
template <int VEC>
__device__ __forceinline__ void bwd_math(const float (&g)[VEC], const float (&o)[VEC],
                                         const float (&x)[VEC], const float* s,
                                         float (&dx)[VEC], float (&gm)[VEC], float* acc_gx,
                                         float* acc_g) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    gm[k] = __fmul_rn(g[k], o[k] > 0.0f ? 1.0f : 0.0f);
    dx[k] = __fmul_rn(gm[k], s[k]);
    acc_gx[k] = __fmaf_rn(gm[k], x[k], acc_gx[k]);
    acc_g[k] = __fadd_rn(acc_g[k], gm[k]);
  }
}

// -- the kernels -------------------------------------------------------------
// grid-stride over rows; thread (tr, tj) takes channel vectors tj, tj +
// lanes, ... and, for each, rows row, row + step, ... kUnroll at a time
template <typename T, int VEC, bool RES>
__global__ void __launch_bounds__(kThreads)
scale_bias_add_relu_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                           const float* __restrict__ bias, const T* __restrict__ res,
                           T* __restrict__ out, int64_t rows, int64_t cols) {
  const int64_t vpr = cols / VEC;
  const int64_t lanes = vpr < kThreads ? vpr : kThreads;
  const int64_t rpp = kThreads / lanes;
  const int64_t tr = threadIdx.x / lanes;
  const int64_t tj = threadIdx.x - tr * lanes;
  if (tr >= rpp) return;
  const int64_t step = static_cast<int64_t>(gridDim.x) * rpp;
  for (int64_t j = tj; j < vpr; j += lanes) {
    float s[VEC], b[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s[k] = round_to<T>(scale[j * VEC + k]);
      b[k] = round_to<T>(bias[j * VEC + k]);
    }
    for (int64_t row = blockIdx.x * rpp + tr; row < rows; row += kUnroll * step) {
      float xv[kUnroll][VEC], rv[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t rr = row + u * step;
        if (rr < rows) {
          Vec<T, VEC>::load(x + rr * cols + j * VEC, xv[u]);
          if (RES) Vec<T, VEC>::load(res + rr * cols + j * VEC, rv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t rr = row + u * step;
        if (rr < rows) {
          float o[VEC];
          fwd_math<VEC, RES>(xv[u], rv[u], s, b, o);
          Vec<T, VEC>::store(out + rr * cols + j * VEC, o);
        }
      }
    }
  }
}

// the backward over block b's rows [b * rows_per_block, ...): thread (tr,
// tj) takes rows row_begin + tr, + rpp, ... at channel vectors tj, tj +
// lanes, ...
template <typename T, int VEC, bool RES>
__global__ void __launch_bounds__(kThreads)
scale_bias_add_relu_backward_kernel(const T* __restrict__ g, const T* __restrict__ o,
                                    const T* __restrict__ x, const float* __restrict__ scale,
                                    T* __restrict__ dx, T* __restrict__ dres,
                                    float* __restrict__ partial, int64_t rows, int64_t cols,
                                    int64_t rows_per_block) {
  __shared__ float red[2 * kThreads * VEC];
  const int64_t vpr = cols / VEC;
  const int64_t lanes = vpr < kThreads ? vpr : kThreads;
  const int64_t rpp = kThreads / lanes;
  const int64_t tr = threadIdx.x / lanes;
  const int64_t tj = threadIdx.x - tr * lanes;
  const bool active = tr < rpp;
  const int64_t row_begin = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t row_end = min(rows, row_begin + rows_per_block);
  float* part = partial + static_cast<int64_t>(blockIdx.x) * 2 * cols;
  for (int64_t j = tj; active && j < vpr; j += lanes) {
    float s[VEC], acc_gx[VEC], acc_g[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s[k] = round_to<T>(scale[j * VEC + k]);
      acc_gx[k] = 0.0f;
      acc_g[k] = 0.0f;
    }
    for (int64_t row = row_begin + tr; row < row_end; row += kUnroll * rpp) {
      float gv[kUnroll][VEC], ov[kUnroll][VEC], xv[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = (row + u * rpp) * cols + j * VEC;
        if (row + u * rpp < row_end) {
          Vec<T, VEC>::load(g + i, gv[u]);
          Vec<T, VEC>::load(o + i, ov[u]);
          Vec<T, VEC>::load(x + i, xv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = (row + u * rpp) * cols + j * VEC;
        if (row + u * rpp < row_end) {
          float d[VEC], gm[VEC];
          bwd_math<VEC>(gv[u], ov[u], xv[u], s, d, gm, acc_gx, acc_g);
          Vec<T, VEC>::store(dx + i, d);
          if (RES) Vec<T, VEC>::store(dres + i, gm);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (rpp == 1) {
        part[j * VEC + k] = acc_gx[k];
        part[cols + j * VEC + k] = acc_g[k];
      } else {   // one channel vector a thread: combined below
        red[(tr * 2 + 0) * cols + j * VEC + k] = acc_gx[k];
        red[(tr * 2 + 1) * cols + j * VEC + k] = acc_g[k];
      }
    }
  }
  if (rpp > 1) {
    __syncthreads();
    if (active && tr == 0) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float sx = 0.0f, sg = 0.0f;
        for (int64_t t = 0; t < rpp; ++t) {
          sx = __fadd_rn(sx, red[(t * 2 + 0) * cols + tj * VEC + k]);
          sg = __fadd_rn(sg, red[(t * 2 + 1) * cols + tj * VEC + k]);
        }
        part[tj * VEC + k] = sx;
        part[cols + tj * VEC + k] = sg;
      }
    }
  }
}

// dscale[c], dbias[c]: the blocks' partials summed in a fixed order (lane ty
// of 32 adds blocks ty, ty + 32, ... in order, then the 32 lane sums in
// order), so the result depends on the block count alone
__global__ void __launch_bounds__(1024)
scale_bias_add_relu_backward_finish(const float* __restrict__ partial, int64_t blocks,
                                    int64_t cols, float* __restrict__ dscale,
                                    float* __restrict__ dbias) {
  __shared__ float red[2][32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * 32 + tx;
  float sx = 0.0f, sg = 0.0f;
  if (c < cols) {
#pragma unroll 4
    for (int64_t b = ty; b < blocks; b += 32) {
      sx = __fadd_rn(sx, partial[(b * 2 + 0) * cols + c]);
      sg = __fadd_rn(sg, partial[(b * 2 + 1) * cols + c]);
    }
  }
  red[0][ty][tx] = sx;
  red[1][ty][tx] = sg;
  __syncthreads();
  if (ty == 0 && c < cols) {
    float tx_ = 0.0f, tg = 0.0f;
    for (int t = 0; t < 32; ++t) {
      tx_ = __fadd_rn(tx_, red[0][t][tx]);
      tg = __fadd_rn(tg, red[1][t][tx]);
    }
    dscale[c] = tx_;
    dbias[c] = tg;
  }
}


// -- launchers ---------------------------------------------------------------
bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// per (kernel, device): the blocks an SM holds; per device: the SM count
struct Occ {
  const void* fn;
  int dev, blocks;
};
std::mutex g_mu;
Occ g_occ[64];
int g_nocc = 0;
int g_sms[64] = {0};

cudaError_t occupancy(const void* fn, int* blocks, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_mu);
  if (dev < 64 && g_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = dev < 64 ? g_sms[dev] : 132;
  for (int i = 0; i < g_nocc; ++i)
    if (g_occ[i].fn == fn && g_occ[i].dev == dev) {
      *blocks = g_occ[i].blocks;
      return cudaSuccess;
    }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (*blocks < 1) return cudaErrorInvalidConfiguration;
  if (g_nocc < 64) g_occ[g_nocc++] = {fn, dev, *blocks};
  return cudaSuccess;
}

template <typename T, int VEC, bool RES>
cudaError_t launch_fwd(const void* x, const float* scale, const float* bias, const void* res,
                       void* out, int64_t rows, int64_t cols, cudaStream_t stream) {
  const int64_t vpr = cols / VEC;
  const int64_t lanes = vpr < kThreads ? vpr : kThreads;
  const int64_t rpp = kThreads / lanes;
  const void* fn = reinterpret_cast<const void*>(scale_bias_add_relu_kernel<T, VEC, RES>);
  int per_sm = 0, sms = 0;
  cudaError_t err = occupancy(fn, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  int64_t blocks = (rows + rpp * kUnroll - 1) / (rpp * kUnroll);
  const int64_t cap = static_cast<int64_t>(sms) * per_sm;
  if (blocks > cap) blocks = cap;
  scale_bias_add_relu_kernel<T, VEC, RES><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<const T*>(res), static_cast<T*>(out),
      rows, cols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const void* x, const float* scale, const float* bias, const void* res,
                    void* out, int64_t rows, int64_t cols, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = cols % VEC == 0 && aligned16(x) && aligned16(out) &&
                   (res == nullptr || aligned16(res));
  if (vec)
    return res != nullptr ? launch_fwd<T, VEC, true>(x, scale, bias, res, out, rows, cols, stream)
                          : launch_fwd<T, VEC, false>(x, scale, bias, res, out, rows, cols, stream);
  return res != nullptr ? launch_fwd<T, 1, true>(x, scale, bias, res, out, rows, cols, stream)
                        : launch_fwd<T, 1, false>(x, scale, bias, res, out, rows, cols, stream);
}

template <typename T, int VEC, bool RES>
cudaError_t launch_bwd(const void* g, const void* o, const void* x, const float* scale, void* dx,
                       void* dres, float* partial, int64_t rows, int64_t cols, int64_t blocks,
                       int64_t rows_per_block, cudaStream_t stream) {
  scale_bias_add_relu_backward_kernel<T, VEC, RES><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(o), static_cast<const T*>(x), scale,
      static_cast<T*>(dx), static_cast<T*>(dres), partial, rows, cols, rows_per_block);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* g, const void* o, const void* x, const float* scale, void* dx,
                     void* dres, float* partial, float* dscale, float* dbias, int64_t rows,
                     int64_t cols, int64_t blocks, int64_t rows_per_block, cudaStream_t stream) {
  // the partition must cover every row, with no block empty
  if (blocks < 1 || rows_per_block < 1 || blocks * rows_per_block < rows ||
      (blocks - 1) * rows_per_block >= rows || blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = cols % VEC == 0 && aligned16(g) && aligned16(o) && aligned16(x) &&
                   aligned16(dx) && (dres == nullptr || aligned16(dres));
  cudaError_t err;
  if (vec)
    err = dres != nullptr ? launch_bwd<T, VEC, true>(g, o, x, scale, dx, dres, partial, rows,
                                                     cols, blocks, rows_per_block, stream)
                          : launch_bwd<T, VEC, false>(g, o, x, scale, dx, dres, partial, rows,
                                                      cols, blocks, rows_per_block, stream);
  else
    err = dres != nullptr ? launch_bwd<T, 1, true>(g, o, x, scale, dx, dres, partial, rows, cols,
                                                   blocks, rows_per_block, stream)
                          : launch_bwd<T, 1, false>(g, o, x, scale, dx, dres, partial, rows, cols,
                                                    blocks, rows_per_block, stream);
  if (err != cudaSuccess) return err;
  const dim3 fin(32, 32);
  scale_bias_add_relu_backward_finish<<<static_cast<unsigned>((cols + 31) / 32), fin, 0, stream>>>(
      partial, blocks, cols, dscale, dbias);
  return cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. scale and bias are fp32 (C,).
// Returns a cudaError_t (0 = launched).
extern "C" int mx_sbar_forward(const void* x, const float* scale, const float* bias,
                               const void* residual, void* out, int64_t rows, int64_t cols,
                               int dtype_code, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0: return forward<float>(x, scale, bias, residual, out, rows, cols, s);
    case 1: return forward<__nv_bfloat16>(x, scale, bias, residual, out, rows, cols, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward: g, out, x (rows, cols) contiguous in the dtype; scale fp32
// (C,); dx (and dres, or null) written in the dtype; partial a (blocks, 2,
// C) fp32 scratch; dscale and dbias fp32 (C,). Block b takes rows
// [b * rows_per_block, min(rows, (b + 1) * rows_per_block)). Two launches:
// the pass and the finish.
extern "C" int mx_sbar_backward(const void* g, const void* out, const void* x,
                                const float* scale, void* dx, void* dres, float* partial,
                                float* dscale, float* dbias, int64_t rows, int64_t cols,
                                int64_t blocks, int64_t rows_per_block, int dtype_code,
                                void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return backward<float>(g, out, x, scale, dx, dres, partial, dscale, dbias, rows, cols,
                             blocks, rows_per_block, s);
    case 1:
      return backward<__nv_bfloat16>(g, out, x, scale, dx, dres, partial, dscale, dbias, rows,
                                     cols, blocks, rows_per_block, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
