// Fused GEMM forward for Hopper (sm_90a): y = act((x @ w) * scale + shift).
//
// Replaces src/repro/kernels/gemm.py::_gemm_kernel (launched by
// _gemm_forward), with and without its training residuals: a training
// forward also writes g = act'(u) (when an activation is fused) and the raw
// fp32 accumulator racc = x @ w (when a scale is fused), both from the
// registers the epilogue already holds, as _gemm_kernel writes g_ref and
// racc_ref from its VMEM tile.
//
// What bounds it on an H100: the Darknet main path's GEMMs are im2col
// convolutions with K from 27 to 2304 and N from 32 to 1000; at batch 8 every
// conv GEMM does 30 or more FLOPs per byte it must move, so under
// fp32_strict (no tensor cores, no TF32) the card's fp32 FFMA rate is the
// roof: about 67 TFLOP/s on the SXM part, 51 on PCIe.
//
// What the design does about it, kept simple and exact first:
//   * each block owns one BM x BN output tile and loops over K inside the
//     block (the TPU kernel's sequential "arbitrary" K grid axis), staging
//     BK-deep x and w tiles in shared memory as fp32;
//   * each thread keeps a 4 x 4 micro-tile of fp32 accumulators in registers
//     and reads its operands from shared memory as float4, so one pair of
//     shared loads feeds 16 FFMAs;
//   * tile loads are bounds-checked and zero-filled, so any (M, K, N) runs
//     without padding in memory (layer 1 has K = 27, the head M = 1 and
//     N = 1000);
//   * the epilogue (scale, shift, activation) runs on the registers and the
//     store is masked, so the output is written once;
//   * M tiles go on gridDim.x (gridDim.y is capped at 65,535);
//   * w may be stored transposed, (N, K) row-major (the TW flag, in the
//     serving and the training forward): a tied LM head reads the (V, D)
//     embedding table in place instead of a (D, V) copy of it.  The tile load then walks k
//     fastest, so neighbouring threads still read neighbouring addresses;
//     the arithmetic is the same fmaf chain, so the bits are those of the
//     row-major w.
// No split-K and no atomics: every output element is one thread's fmaf chain
// over k = 0..K-1 in order, whatever M, the tile size or the block, so rows
// padded into a larger serving batch are bitwise identical to the same rows
// run alone.  wgmma, TMA and 3xTF32 are later work.
//
// The batched GEMM bmm_fwd (out[b] = x[b] @ w[b], no epilogue) is the same
// kernel with the batch on gridDim.z: each block offsets x, w and y by
// blockIdx.z times M*K, K*N and M*N elements (int64), so batch slice b runs
// exactly the 2-D launch's arithmetic on that slice, bit for bit.  It
// replaces src/repro/kernels/gemm.py::_bmm_forward (its pallas_call runs
// _bwd_matmul_kernel with dims ((1,),(0,)) over a (B, M, N, K) grid); the
// TPU's sequential K axis is the same in-block loop as here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;  // K depth of one shared-memory stage
constexpr int TM = 4;   // accumulator rows per thread
constexpr int TN = 4;   // accumulator columns per thread
constexpr int XPAD = 4; // keeps the transposed x stores off one bank

enum Act { ACT_LINEAR = 0, ACT_RELU = 1, ACT_LEAKY = 2, ACT_SILU = 3, ACT_GELU = 4 };
enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Same formulas as kernels/common.py::apply_act: where-based relu/leaky with
// slope 0.1, silu as x*sigmoid(x), tanh-gelu with 0.044715.  The multiplies
// and adds are rounded one by one (no contraction) as PyTorch's separate
// elementwise ops round them.
__device__ __forceinline__ float activate(float u, int act) {
  switch (act) {
    case ACT_RELU:
      return u > 0.f ? u : 0.f;
    case ACT_LEAKY:
      return u > 0.f ? u : __fmul_rn(0.1f, u);
    case ACT_SILU:
      return __fmul_rn(u, 1.f / (1.f + expf(-u)));
    case ACT_GELU: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      const float cube = __fmul_rn(__fmul_rn(u, u), u);
      const float inner = __fmul_rn(c, __fadd_rn(u, __fmul_rn(0.044715f, cube)));
      return __fmul_rn(__fmul_rn(0.5f, u), __fadd_rn(1.f, tanhf(inner)));
    }
    default:
      return u;
  }
}

// d act(u) / du, as kernels/common.py::act_deriv: at exactly u = 0 relu
// gives 0 and leaky its slope 0.1; silu and gelu round op by op as
// PyTorch's separate elementwise ops do.
__device__ __forceinline__ float activate_deriv(float u, int act) {
  switch (act) {
    case ACT_RELU:
      return u > 0.f ? 1.f : 0.f;
    case ACT_LEAKY:
      return u > 0.f ? 1.f : 0.1f;
    case ACT_SILU: {
      const float s = 1.f / (1.f + expf(-u));
      return __fmul_rn(s, __fadd_rn(1.f, __fmul_rn(u, __fadd_rn(1.f, -s))));
    }
    case ACT_GELU: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      const float u2 = __fmul_rn(u, u);
      const float cube = __fmul_rn(u2, u);
      const float t =
          tanhf(__fmul_rn(c, __fadd_rn(u, __fmul_rn(0.044715f, cube))));
      // 0.5 (1 + t) + 0.5 u (1 - t^2) c (1 + 3 * 0.044715 u^2)
      const float lhs = __fmul_rn(0.5f, __fadd_rn(1.f, t));
      const float one_m_t2 = __fadd_rn(1.f, -__fmul_rn(t, t));
      const float poly = __fadd_rn(1.f, __fmul_rn(0.134145f, u2));
      const float rhs =
          __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(0.5f, u), one_m_t2), c), poly);
      return __fadd_rn(lhs, rhs);
    }
    default:
      return 1.f;
  }
}

// RES = false is the serving forward; RES = true also writes g and racc
// where those pointers are not null.  The arithmetic of y is the same in
// both, so a training forward's y has the serving forward's bits.  TW: w is
// stored (N, K) row-major instead of (K, N).
template <typename Tin, typename Tout, int BM, int BN, bool RES, bool TW>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_fused_fwd_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, Tout* __restrict__ y,
                      float* __restrict__ g, float* __restrict__ racc,
                      int M, int K, int N, int act) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int TCOLS = BN / TN;
  static_assert((BM * BK) % THREADS == 0, "x tile must split evenly");
  static_assert((BK * BN) % THREADS == 0, "w tile must split evenly");

  __shared__ __align__(16) float xs[BK][BM + XPAD];  // x tile, k-major
  // w tile; padded when TW, whose k-fastest stores would hit one bank
  __shared__ __align__(16) float ws[BK][BN + (TW ? XPAD : 0)];

  const int tid = threadIdx.x;
  const int tcol = tid % TCOLS;
  const int trow = tid / TCOLS;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;
  // Batch slice (bmm_fwd; 0 for the 2-D launches): int64 element offsets.
  const int64_t zb = blockIdx.z;
  x += zb * M * K;
  w += zb * K * N;
  y += zb * M * N;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int it = 0; it < BM * BK / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / BK, c = i % BK;
      const int64_t gr = row0 + r;
      const int gk = k0 + c;
      xs[c][r] = (gr < M && gk < K) ? to_f32(x[gr * K + gk]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < BK * BN / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = TW ? i % BK : i / BN, c = TW ? i / BK : i % BN;
      const int gk = k0 + r, gc = col0 + c;
      ws[r][c] = (gk < K && gc < N)
                     ? to_f32(TW ? w[static_cast<int64_t>(gc) * K + gk]
                                 : w[static_cast<int64_t>(gk) * N + gc])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][trow * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tcol * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float sc[TN], sh[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gc = col0 + tcol * TN + j;
    sc[j] = (scale != nullptr && gc < N) ? scale[gc] : 1.f;
    sh[j] = (shift != nullptr && gc < N) ? shift[gc] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = row0 + trow * TM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tcol * TN + j;
      if (gc >= N) continue;
      float u = acc[i][j];
      if (scale != nullptr) u = __fmul_rn(u, sc[j]);
      if (shift != nullptr) u = __fadd_rn(u, sh[j]);
      store(y + gr * N + gc, activate(u, act));
      if constexpr (RES) {
        if (g != nullptr) g[gr * N + gc] = activate_deriv(u, act);
        if (racc != nullptr) racc[gr * N + gc] = acc[i][j];
      }
    }
  }
}

template <typename Tin, typename Tout, int T, bool RES, bool TW>
cudaError_t launch_tile(const void* x, const void* w, const void* scale,
                        const void* shift, void* y, float* g, float* racc,
                        int M, int K, int N, int act, int batch,
                        cudaStream_t stream) {
  const unsigned grid_m = static_cast<unsigned>((static_cast<int64_t>(M) + T - 1) / T);
  const unsigned grid_n = static_cast<unsigned>((N + T - 1) / T);
  if (grid_n > 65535u || batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  gemm_fused_fwd_kernel<Tin, Tout, T, T, RES, TW>
      <<<dim3(grid_m, grid_n, static_cast<unsigned>(batch)),
         (T / TM) * (T / TN), 0, stream>>>(
          static_cast<const Tin*>(x), static_cast<const Tin*>(w),
          static_cast<const float*>(scale), static_cast<const float*>(shift),
          static_cast<Tout*>(y), g, racc, M, K, N, act);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, bool RES, bool TW>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   const void* shift, void* y, float* g, float* racc, int M,
                   int K, int N, int act, int tile, int batch,
                   cudaStream_t stream) {
  switch (tile) {
    case 64:
      return launch_tile<Tin, Tout, 64, RES, TW>(
          x, w, scale, shift, y, g, racc, M, K, N, act, batch, stream);
    case 32:
      return launch_tile<Tin, Tout, 32, RES, TW>(
          x, w, scale, shift, y, g, racc, M, K, N, act, batch, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool RES, bool TW>
int by_dtype(const void* x, const void* w, const void* scale,
             const void* shift, void* y, float* g, float* racc, int M, int K,
             int N, int in_dtype, int out_dtype, int act, int tile, int batch,
             cudaStream_t s) {
  if (in_dtype == DT_F32 && out_dtype == DT_F32)
    return launch<float, float, RES, TW>(x, w, scale, shift, y, g, racc, M, K,
                                         N, act, tile, batch, s);
  if (in_dtype == DT_F32 && out_dtype == DT_BF16)
    return launch<float, __nv_bfloat16, RES, TW>(
        x, w, scale, shift, y, g, racc, M, K, N, act, tile, batch, s);
  if (in_dtype == DT_BF16 && out_dtype == DT_F32)
    return launch<__nv_bfloat16, float, RES, TW>(
        x, w, scale, shift, y, g, racc, M, K, N, act, tile, batch, s);
  if (in_dtype == DT_BF16 && out_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16, RES, TW>(
        x, w, scale, shift, y, g, racc, M, K, N, act, tile, batch, s);
  return cudaErrorInvalidValue;
}

template <bool RES>
int dispatch(const void* x, const void* w, const void* scale,
             const void* shift, void* y, float* g, float* racc, int M, int K,
             int N, int in_dtype, int out_dtype, int act, int tile,
             int trans_w, int batch, void* stream) {
  if (M <= 0 || N <= 0 || batch == 0) return 0;
  if (K < 0 || act < ACT_LINEAR || act > ACT_GELU) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans_w)
    return by_dtype<RES, true>(x, w, scale, shift, y, g, racc, M, K, N,
                               in_dtype, out_dtype, act, tile, batch, s);
  return by_dtype<RES, false>(x, w, scale, shift, y, g, racc, M, K, N,
                              in_dtype, out_dtype, act, tile, batch, s);
}

}  // namespace

// x (M, K) row-major and w (K, N) row-major, or (N, K) row-major when
// `trans_w` is not 0, both in `in_dtype`; scale and shift fp32 (N,) or
// null; y (M, N) row-major in `out_dtype`.  `tile` is the square output
// tile (64 or 32).  Launches on `stream` and returns cudaGetLastError().
extern "C" int gemm_fused_fwd(const void* x, const void* w, const void* scale,
                              const void* shift, void* y, int M, int K, int N,
                              int in_dtype, int out_dtype, int act, int tile,
                              int trans_w, void* stream) {
  return dispatch<false>(x, w, scale, shift, y, nullptr, nullptr, M, K, N,
                         in_dtype, out_dtype, act, tile, trans_w, 1, stream);
}

// The training forward: as gemm_fused_fwd, and also g = act'(u) and
// racc = x @ w, both fp32 (M, N) row-major, each written where its pointer
// is not null (g when act is not linear, racc when a scale is fused, as
// _gemm_forward's want_g / want_acc).
extern "C" int gemm_fused_fwd_res(const void* x, const void* w,
                                  const void* scale, const void* shift,
                                  void* y, void* g, void* racc, int M, int K,
                                  int N, int in_dtype, int out_dtype, int act,
                                  int tile, int trans_w, void* stream) {
  return dispatch<true>(x, w, scale, shift, y, static_cast<float*>(g),
                        static_cast<float*>(racc), M, K, N, in_dtype,
                        out_dtype, act, tile, trans_w, 1, stream);
}

// The batched GEMM: x (B, M, K) and w (B, K, N) row-major in `in_dtype`,
// y (B, M, N) row-major in `out_dtype`, y[b] = x[b] @ w[b] with fp32
// accumulation and no epilogue.  B <= 65535 (gridDim.z).  `tile` as
// gemm_fused_fwd.  Launches on `stream` and returns cudaGetLastError().
extern "C" int bmm_fwd(const void* x, const void* w, void* y, int B, int M,
                       int K, int N, int in_dtype, int out_dtype, int tile,
                       void* stream) {
  if (B < 0) return cudaErrorInvalidValue;
  return dispatch<false>(x, w, nullptr, nullptr, y, nullptr, nullptr, M, K, N,
                         in_dtype, out_dtype, ACT_LINEAR, tile, 0, B, stream);
}

extern "C" const char* gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
