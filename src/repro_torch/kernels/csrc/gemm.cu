// Fused GEMM forward for Hopper (sm_90a): y = act((x @ w) * scale + shift).
//
// Replaces src/repro/kernels/gemm.py::_gemm_kernel (launched by
// _gemm_forward), with and without its training residuals: a training
// forward also writes g = act'(u) (when an activation is fused) and the raw
// fp32 accumulator racc = x @ w (when a scale is fused), both from the
// registers the epilogue already holds, as _gemm_kernel writes g_ref and
// racc_ref from its VMEM tile.  The batched GEMM bmm_fwd (out[b] = x[b] @
// w[b], no epilogue) is the same kernels with the batch on gridDim.z: each
// block offsets x, w and y by blockIdx.z times M*K, K*N and M*N elements
// (int64), so batch slice b runs exactly the 2-D launch's arithmetic.  It
// replaces src/repro/kernels/gemm.py::_bmm_forward (its pallas_call runs
// _bwd_matmul_kernel over a (B, M, N, K) grid).
//
// The invariant: every output element is one thread's fmaf chain over
// k = 0..K-1 in order, starting from 0.f, bf16 widened by
// __bfloat162float, then the rounded epilogue.  No split-K, no second
// partial sum, no reassociation; the zero terms that pad a ragged K are
// fmaf(0, 0, acc) == acc (acc is never -0: it starts at +0 and a sum that
// rounds to zero is +0).  So both regimes below, every plan and every
// launch give each output the same bits: a row alone equals that row in a
// larger M, a batch slice equals the 2-D launch, w read transposed equals
// its row-major copy, and the plan is chosen for speed alone.
//
// Two regimes, picked from the shape by kernels/gemm.py::plan_for (the
// plan ids of kernels/gemm.py::PLANS), both one kernel, gemm_fwd_kernel,
// over a ring of cp.async stages (gemm_common.cuh, shared with the
// backward in gemm_bwd.cu); a plan is its Tile:
//
// Regime A, up to 64 rows (LM serving dispatches, Mamba2 decode and slot
// prefills, a CNN's small heads).  What bounds it: the weight bytes
// (qwen2-0.5b's 494 M weights are 2 GB a dispatch) and, at a few rows,
// the latency of one K-long fmaf chain per output.  The design: a block
// holds 8 (or 64) rows of x and a 16- or 64-column slice of w, so the
// weights are streamed by as many blocks as N allows and read from DRAM
// about once; each thread owns one column and runs its 1-16 row chains
// (ILP from more outputs, never from split sums), so one row still has 16
// threads a block at work.  The K loop runs over a ring of 4-8 stages of
// 64 or 128 k filled by 16-byte cp.async.cg several stages ahead.
//
// Regime B, more rows (CNN and LM training, SSM prefill, CNN serving, the
// bmm expert GEMMs).  What bounds it: the fp32 FFMA rate (67 TFLOP/s on
// the SXM part; no tensor cores under fp32_strict).  The design: 128 x
// 128 output tiles with 8 x 8 accumulators a thread (a 16-byte shared
// load of x feeds 4 k of a row, one of w 4 columns: 64 FFMAs per 4
// loads), or 64 x 32 tiles with 4 x 4 where the 128 tiles are too few or
// the contraction short (the DARKNET19 layers: narrow N and many small
// blocks hide the latency better); 3 stages of 32 k in flight; at most
// 128 registers a thread, so two 256-thread blocks share an SM.
//
// Both: x is staged row-major (k fastest) and a row-major w as it lies;
// a transposed w (N, K) stays k-major and its threads own strided columns
// so the reads do not collide in a bank.  A 16-byte piece that is ragged
// or unaligned (K = 27, N = 99, an odd bf16 row) is copied element by
// element with zero fill, so any (M, K, N) and any alignment runs
// without padding in memory.  The epilogue (scale, shift, activation, and
// the residuals where their pointers are set) runs on the registers and
// the store is masked, so the output is written once; M tiles on
// gridDim.x, N tiles on gridDim.y (<= 65,535), the batch on z.  TF32,
// 3xTF32 and wgmma change the bits and the precision contract and are
// not used.

#include "gemm_common.cuh"

namespace {

using namespace gemm;

// The plans, in the order of kernels/gemm.py::PLANS.
enum PlanId { PLAN_A8 = 0, PLAN_A16 = 1, PLAN_A64 = 2, PLAN_B128 = 3, PLAN_B64 = 4 };

enum Act { ACT_LINEAR = 0, ACT_RELU = 1, ACT_LEAKY = 2, ACT_SILU = 3, ACT_GELU = 4 };

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

// The epilogue of one output (global row gr, column gc < N):
// u = acc * scale + shift, y = act(u) stored as fp32 or bf16; where their
// pointers are set, the residuals g = act'(u) and racc = acc.  Rounded op
// by op.
__device__ __forceinline__ void finish(float acc, int64_t gr, int gc, int N,
                                       const float* scale, float sc,
                                       const float* shift, float sh, void* y,
                                       bool y_bf16, float* g, float* racc,
                                       int act) {
  float u = acc;
  if (scale != nullptr) u = __fmul_rn(u, sc);
  if (shift != nullptr) u = __fadd_rn(u, sh);
  const int64_t at = gr * N + gc;
  if (y_bf16)
    store(static_cast<__nv_bfloat16*>(y) + at, activate(u, act));
  else
    store(static_cast<float*>(y) + at, activate(u, act));
  if (g != nullptr) g[at] = activate_deriv(u, act);
  if (racc != nullptr) racc[at] = acc;
}

// Regime A: a block holds up to 8 or 64 rows and BN columns, one column a
// thread, so a 1-row GEMM still has BN threads running chains.
using TileA8 = Tile<8, 16, 128, 1, 128, 6>;
using TileA16 = Tile<64, 16, 128, 1, 64, 8>;
using TileA64 = Tile<64, 64, 256, 1, 64, 4>;
// Regime B: 8 x 8 accumulators a thread, or 4 x 4 in 64 x 32 tiles.
using TileB128 = Tile<128, 128, 256, 8, 32, 3>;
using TileB64 = Tile<64, 32, 128, 4, 32, 3>;

template <typename Tin, typename T, bool TW>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
gemm_fwd_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                const float* __restrict__ scale,
                const float* __restrict__ shift, void* __restrict__ y,
                bool y_bf16, float* __restrict__ g, float* __restrict__ racc,
                int M, int K, int N, int act) {
  using L = Smem<Tin, T, TW>;
  constexpr int VEC = L::VEC, XS = L::XS, S = T::STAGES, BK = T::BK;
  constexpr int BN = T::BN, TM = T::TM, TN = T::TN, RG = T::RG;
  constexpr int KP = BK / VEC;  // 16-byte pieces along k per row
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  Tin* const smem = reinterpret_cast<Tin*>(gemm_smem);

  const int tid = threadIdx.x;
  const int cg = tid % T::CG, rg = tid / T::CG;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * T::BM;
  const int64_t left = M - row0;  // rows of x from this block's first on
  const int rows = left < T::BM ? static_cast<int>(left) : T::BM;
  const int col0 = blockIdx.y * BN;
  const int64_t zb = blockIdx.z;  // batch slice (bmm_fwd), else 0
  x += zb * M * K + row0 * K;
  w += zb * K * N;
  const int64_t yrow0 = zb * M + row0;  // y's row of this block's first
  const int stage = L::stage_elems(rows);
  const bool x_vec =
      K % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w_vec = (TW ? K % VEC == 0 : N % VEC == 0) &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int nk = (K + BK - 1) / BK;

  // Stage kt into ring slot kt % S: rows x BK of x, BK x BN of w.
  auto load_stage = [&](int kt) {
    Tin* xs = smem + (kt % S) * stage;
    Tin* ws = xs + rows * XS;
    const int k0 = kt * BK;
    for (int i = tid; i < rows * KP; i += T::THREADS) {
      const int r = i / KP, gk = k0 + (i % KP) * VEC;
      copy_piece(xs + r * XS + (i % KP) * VEC,
                 x + static_cast<int64_t>(r) * K + gk, x_vec, K - gk);
    }
    if constexpr (TW) {
      for (int i = tid; i < BN * KP; i += T::THREADS) {
        const int c = i / KP, gc = col0 + c, gk = k0 + (i % KP) * VEC;
        copy_piece(ws + c * XS + (i % KP) * VEC,
                   w + static_cast<int64_t>(gc) * K + gk, w_vec,
                   gc < N ? K - gk : 0);
      }
    } else {
      constexpr int NP = BN / VEC;  // pieces per k row
      for (int i = tid; i < BK * NP; i += T::THREADS) {
        const int r = i / NP, gk = k0 + r, gc = col0 + (i % NP) * VEC;
        copy_piece(ws + r * BN + (i % NP) * VEC,
                   w + static_cast<int64_t>(gk) * N + gc, w_vec,
                   gk < K ? N - gc : 0);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  int rr[TM];  // rows read (clamped: a row past the block's is not stored)
#pragma unroll
  for (int i = 0; i < TM; ++i) rr[i] = min(rg + i * RG, rows - 1);
  const bool active = rg < rows;

  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();  // this thread's pieces of stage kt are in
    __syncthreads();         // everyone's are; slot (kt - 1) % S is free
    if (kt + S - 1 < nk) load_stage(kt + S - 1);
    cp_async_commit();
    if (!active) continue;
    const Tin* xs = smem + (kt % S) * stage;
    const Tin* ws = xs + rows * XS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];  // x at k = kk..kk+3 of each of this thread's rows
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = load4(xs + rr[i] * XS + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[TN];  // w at k = kk + q, this thread's columns
        if (TW || TN == 1) {
#pragma unroll
          for (int j = 0; j < TN; ++j)
            b[j] = TW ? to_f32(ws[col_of<T, TW>(cg, j) * XS + kk + q])
                      : to_f32(ws[(kk + q) * BN + col_of<T, TW>(cg, j)]);
        } else {
#pragma unroll
          for (int j = 0; j < TN; j += 4) {
            const float4 v = load4(ws + (kk + q) * BN + col_of<T, TW>(cg, j));
            b[j] = v.x;
            b[j + 1] = v.y;
            b[j + 2] = v.z;
            b[j + 3] = v.w;
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y
                         : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  int gc[TN];
  float sc[TN], sh[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    gc[j] = col0 + col_of<T, TW>(cg, j);
    sc[j] = (scale != nullptr && gc[j] < N) ? scale[gc[j]] : 1.f;
    sh[j] = (shift != nullptr && gc[j] < N) ? shift[gc[j]] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = rg + i * RG;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (gc[j] < N)
        finish(acc[i][j], yrow0 + r, gc[j], N, scale, sc[j], shift, sh[j],
               y, y_bf16, g, racc, act);
  }
}

// --------------------------------------------------------------- launch ---

struct Args {
  const void* x;
  const void* w;
  const float* scale;
  const float* shift;
  void* y;
  bool y_bf16;
  float* g;
  float* racc;
  int M, K, N, act, batch;
};

template <typename Tin, typename T, bool TW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Smem<Tin, T, TW>;
  const auto kernel = gemm_fwd_kernel<Tin, T, TW>;
  static bool sized = false;  // once per instantiation, before its launch
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes(T::BM)));
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const unsigned grid_m =
      static_cast<unsigned>((static_cast<int64_t>(a.M) + T::BM - 1) / T::BM);
  const unsigned grid_n = static_cast<unsigned>((a.N + T::BN - 1) / T::BN);
  if (grid_n > 65535u) return cudaErrorInvalidValue;
  kernel<<<dim3(grid_m, grid_n, static_cast<unsigned>(a.batch)), T::THREADS,
           L::bytes(a.M < T::BM ? a.M : T::BM), stream>>>(
      static_cast<const Tin*>(a.x), static_cast<const Tin*>(a.w), a.scale,
      a.shift, a.y, a.y_bf16, a.g, a.racc, a.M, a.K, a.N, a.act);
  return cudaGetLastError();
}

template <typename Tin, bool TW>
cudaError_t by_plan(const Args& a, int plan, cudaStream_t s) {
  switch (plan) {
    case PLAN_A8:
      return launch<Tin, TileA8, TW>(a, s);
    case PLAN_A16:
      return launch<Tin, TileA16, TW>(a, s);
    case PLAN_A64:
      return launch<Tin, TileA64, TW>(a, s);
    case PLAN_B128:
      return launch<Tin, TileB128, TW>(a, s);
    case PLAN_B64:
      return launch<Tin, TileB64, TW>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool TW>
cudaError_t by_dtype(const Args& a, int in_dtype, int plan, cudaStream_t s) {
  if (in_dtype == DT_F32) return by_plan<float, TW>(a, plan, s);
  if (in_dtype == DT_BF16) return by_plan<__nv_bfloat16, TW>(a, plan, s);
  return cudaErrorInvalidValue;
}

int dispatch(Args a, int in_dtype, int out_dtype, int plan, int trans_w,
             void* stream) {
  if (a.M <= 0 || a.N <= 0 || a.batch == 0) return 0;
  if (a.K < 0 || a.batch < 0 || a.batch > 65535 || a.act < ACT_LINEAR ||
      a.act > ACT_GELU || (out_dtype != DT_F32 && out_dtype != DT_BF16))
    return cudaErrorInvalidValue;
  a.y_bf16 = out_dtype == DT_BF16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans_w) return by_dtype<true>(a, in_dtype, plan, s);
  return by_dtype<false>(a, in_dtype, plan, s);
}

}  // namespace

// x (M, K) row-major and w (K, N) row-major, or (N, K) row-major when
// `trans_w` is not 0, both in `in_dtype`; scale and shift fp32 (N,) or
// null; y (M, N) row-major in `out_dtype`.  `plan` is an index into
// kernels/gemm.py::PLANS (PlanId).  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int gemm_fused_fwd(const void* x, const void* w, const void* scale,
                              const void* shift, void* y, int M, int K, int N,
                              int in_dtype, int out_dtype, int act, int plan,
                              int trans_w, void* stream) {
  const Args a{x, w, static_cast<const float*>(scale),
               static_cast<const float*>(shift), y, false, nullptr, nullptr,
               M, K, N, act, 1};
  return dispatch(a, in_dtype, out_dtype, plan, trans_w, stream);
}

// The training forward: as gemm_fused_fwd, and also g = act'(u) and
// racc = x @ w, both fp32 (M, N) row-major, each written where its pointer
// is not null (g when act is not linear, racc when a scale is fused, as
// _gemm_forward's want_g / want_acc).  y has the serving launch's bits.
extern "C" int gemm_fused_fwd_res(const void* x, const void* w,
                                  const void* scale, const void* shift,
                                  void* y, void* g, void* racc, int M, int K,
                                  int N, int in_dtype, int out_dtype, int act,
                                  int plan, int trans_w, void* stream) {
  const Args a{x, w, static_cast<const float*>(scale),
               static_cast<const float*>(shift), y, false,
               static_cast<float*>(g), static_cast<float*>(racc), M, K, N,
               act, 1};
  return dispatch(a, in_dtype, out_dtype, plan, trans_w, stream);
}

// The batched GEMM: x (B, M, K) and w (B, K, N) row-major in `in_dtype`,
// y (B, M, N) row-major in `out_dtype`, y[b] = x[b] @ w[b] with fp32
// accumulation and no epilogue.  B <= 65535 (gridDim.z).  `plan` as
// gemm_fused_fwd.  Launches on `stream` and returns cudaGetLastError().
extern "C" int bmm_fwd(const void* x, const void* w, void* y, int B, int M,
                       int K, int N, int in_dtype, int out_dtype, int plan,
                       void* stream) {
  const Args a{x, w, nullptr, nullptr, y, false, nullptr, nullptr, M, K, N,
               ACT_LINEAR, B};
  return dispatch(a, in_dtype, out_dtype, plan, 0, stream);
}

extern "C" const char* gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
