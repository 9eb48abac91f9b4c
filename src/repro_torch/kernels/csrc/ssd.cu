// Mamba2 SSD (state-space duality) chunk scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd.py::_ssd_kernel (launched by ssd_scan,
// pallas_call at ssd.py:97).  For one (batch, head) the sequence is cut
// into chunks of Q rows; with x̄ = x·dt and cs = cumsum(dA) within a chunk,
//   y_q   = Σ_{k<=q} (C_q·B_k) exp(cs_q − cs_k) x̄_k  +  exp(cs_q) (C_q·stateᵀ)
//   state ← exp(cs_last) state + Σ_k (x̄_k exp(cs_last − cs_k))ᵀ B_k
// with a (P, N) fp32 state carried from chunk to chunk (zero, or
// `init`, before the first).  The kernel also writes the final state, which
// the prefill keeps as the layer's SSM cache.
//
// What bounds it on an H100: at mamba2-1.3b's prefill (Q 256, N 128, P 64)
// the function needs, per chunk and head, Q²P/2 FMAs for the scores times
// x̄ and 2QNP for the state's term and update, and Q²N/2 for C·Bᵀ once
// per group (G = 1: one product serves all 64 heads), against Q P inputs:
// it is bound by operations (the FFMA rate, 67 TFLOP/s on the SXM part),
// far above the bytes of x, y, B and C.  This kernel forms C·Bᵀ for every
// head, as the TPU kernel does, so it issues about 1.7 times those FMAs.
//
// What the design does about it (a simple kernel first; speed is later
// work):
//   * the TPU grid (BH, S/Q) runs its chunk axis in order with a VMEM
//     state; here one block per (P slice of 32 rows, head, batch) loops over
//     the chunks itself and keeps its (32, N) fp32 state slice in shared
//     memory.  The rows of P are independent (y[:, p] reads only x̄[:, p] and
//     state[p, :]), so the slice changes no bits; at batch 1, 64 heads of
//     64 give 128 blocks for 132 SMs;
//   * the chunk is tiled in 64-row pieces as the flash kernels are: for
//     query tile i and key tiles j <= i the 64 x 64 scores S_ij =
//     C_i·B_jᵀ ∘ exp(cs_i − cs_j) (0 above the diagonal) are formed in
//     shared memory, 4 x 4 per thread, then y_i += S_ij·x̄_j; the whole
//     (Q, Q) scores and (Q, N) B and C of the JAX kernel (128 KB each for B
//     and C at Q 256) never exist;
//   * cs is summed by one thread in row order, so two runs give the same
//     bits (no atomics anywhere);
//   * B and C are read by group through strides: head h reads group
//     h / (H / G), with no per-head copy;
//   * the ragged last chunk is masked: rows at or past S read as dt = 0,
//     B = C = 0 (exact, as the JAX padding) and write no y;
//   * every product is an fp32 FFMA (no TF32); bf16 x, B, C are widened on
//     load, y is written in x's dtype.
// Sharing C·Bᵀ across the heads of a group (G = 1 at full width: one
// product for 64 heads) and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TQ = 64;        // rows of a query or key tile
constexpr int PB = 32;        // rows of P one block owns
constexpr int SLD = TQ + 16;  // row stride of the score tile (no conflicts)
constexpr int MAX_SMEM = 232448;

enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Args {
  const void* x;      // (Bt, S, H, P), strides xs*
  const float* dt;    // (Bt, S, H), strides ds*
  const float* da;    // dt * A, same layout as dt
  const void* b;      // (Bt, S, G, N), strides bs*
  const void* c;      // (Bt, S, G, N), strides cs*
  const float* init;  // (Bt, H, P, N) contiguous, or null for zeros
  void* y;            // (Bt, S, H, P) contiguous, x's dtype
  float* state;       // (Bt, H, P, N) contiguous
  int S, H, G, P, Q;
  long long xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg, csb, css, csg;
};

// Floats of dynamic shared memory: cs (Q), the C and B tiles (64 x N, rows
// padded by one float), x̄ (64 x 32), the score tile (64 x SLD) and the
// state slice (32 x N, padded).
inline size_t smem_floats(int N, int Q) {
  return static_cast<size_t>(Q) + 2 * TQ * (N + 1) + TQ * PB + TQ * SLD +
         PB * (N + 1);
}

// Rows [r0, r0 + 64) of a (S, N) operand of this chunk into a padded tile;
// rows at or past `rows` (the chunk's live rows) read 0.
template <typename T, int N>
__device__ __forceinline__ void load_bc(float* tile, const T* src, long long rs,
                                        int c0, int r0, int rows) {
  for (int i = threadIdx.x; i < TQ * N; i += THREADS) {
    const int r = i / N, n = i % N;
    float v = 0.f;
    if (r0 + r < rows) v = to_f32(src[(c0 + r0 + r) * rs + n]);
    tile[r * (N + 1) + n] = v;
  }
}

// x̄ = x·dt for rows [r0, r0 + 64) of the chunk and this block's 32 rows of
// P, times exp(cs_last − cs_k) when `decay`; 0 past the live rows or P.
template <typename T>
__device__ __forceinline__ void load_xbar(float* xt, const T* x, const float* dt,
                                          const float* cs, const Args& a, int c0,
                                          int r0, int rows, int p0, bool decay,
                                          float cs_last) {
  for (int i = threadIdx.x; i < TQ * PB; i += THREADS) {
    const int r = i / PB, p = i % PB;
    float v = 0.f;
    if (r0 + r < rows && p0 + p < a.P) {
      const long long row = c0 + r0 + r;
      v = __fmul_rn(to_f32(x[row * a.xss + p]), dt[row * a.dss]);
      if (decay) v = __fmul_rn(v, expf(__fsub_rn(cs_last, cs[r0 + r])));
    }
    xt[i] = v;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS) ssd_kernel(Args a) {
  extern __shared__ float sm[];
  constexpr int LDN = N + 1;
  constexpr int NS = PB * N / THREADS;  // state elements per thread
  float* cs = sm;
  float* ct = cs + a.Q;
  float* bt = ct + TQ * LDN;
  float* xt = bt + TQ * LDN;
  float* st = xt + TQ * PB;
  float* ss = st + TQ * SLD;

  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tr = t / 16, tc = t % 16;  // the 4 x 4 score micro-tile
  const T* x = static_cast<const T*>(a.x) + b * a.xsb + h * a.xsh + p0;
  const float* dt = a.dt + b * a.dsb + h * a.dsh;
  const float* da = a.da + b * a.dsb + h * a.dsh;
  const T* bm = static_cast<const T*>(a.b) + b * a.bsb + g * a.bsg;
  const T* cm = static_cast<const T*>(a.c) + b * a.csb + g * a.csg;
  const long long yrow = static_cast<long long>(a.H) * a.P;
  T* y = static_cast<T*>(a.y) + b * a.S * yrow + h * a.P + p0;
  const long long sbase = (static_cast<long long>(b) * a.H + h) * a.P * N;

  for (int i = t; i < PB * N; i += THREADS) {
    const int p = i / N, n = i % N;
    float v = 0.f;
    if (a.init != nullptr && p0 + p < a.P) v = a.init[sbase + (p0 + p) * N + n];
    ss[p * LDN + n] = v;
  }

  for (int c0 = 0; c0 < a.S; c0 += a.Q) {
    const int rows = min(a.Q, a.S - c0);
    __syncthreads();  // the previous chunk is done with cs
    for (int i = t; i < rows; i += THREADS) cs[i] = da[(c0 + i) * a.dss];
    __syncthreads();
    if (t == 0) {  // one fixed order: row by row
      float run = 0.f;
      for (int i = 0; i < rows; ++i) {
        run = __fadd_rn(run, cs[i]);
        cs[i] = run;
      }
    }
    __syncthreads();
    const float cs_last = cs[rows - 1];
    const int ntiles = (rows + TQ - 1) / TQ;

    for (int it = 0; it < ntiles; ++it) {
      const int q0 = it * TQ;
      __syncthreads();  // the previous tile is done with ct
      load_bc<T, N>(ct, cm, a.css, c0, q0, rows);
      float acc[TQ / 8];
#pragma unroll
      for (int r = 0; r < TQ / 8; ++r) acc[r] = 0.f;
      for (int jt = 0; jt <= it; ++jt) {
        const int k0 = jt * TQ;
        __syncthreads();  // the previous key tile is done with bt, xt, st
        load_bc<T, N>(bt, bm, a.bss, c0, k0, rows);
        load_xbar<T>(xt, x, dt, cs, a, c0, k0, rows, p0, false, 0.f);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = ct[(tr + 16 * i) * LDN + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bt[(tc + 16 * j) * LDN + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(cv[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + tr + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + tc + 16 * j;
            float w = 0.f;
            if (q < rows && k <= q)
              w = __fmul_rn(s[i][j], expf(__fsub_rn(cs[q], cs[k])));
            st[(tr + 16 * i) * SLD + tc + 16 * j] = w;
          }
        }
        __syncthreads();
        for (int k = 0; k < TQ; ++k) {
          const float xv = xt[k * PB + lane];
#pragma unroll
          for (int r = 0; r < TQ / 8; ++r)
            acc[r] = __fmaf_rn(st[(warp + 8 * r) * SLD + k], xv, acc[r]);
        }
      }
      // the carried state's share: exp(cs_q) (C_q · state[p, :])
#pragma unroll
      for (int r = 0; r < TQ / 8; ++r) {
        const int ql = warp + 8 * r, q = q0 + ql;
        float yo = 0.f;
        for (int n = 0; n < N; ++n)
          yo = __fmaf_rn(ct[ql * LDN + n], ss[lane * LDN + n], yo);
        if (q < rows && p0 + lane < a.P)
          store(y + (c0 + q) * yrow + lane,
                __fadd_rn(acc[r], __fmul_rn(expf(cs[q]), yo)));
      }
    }

    // state ← exp(cs_last) state + Σ_k (x̄_k exp(cs_last − cs_k))ᵀ B_k;
    // thread t owns rows p = t / N + r (THREADS / N), column n = t % N.
    float nw[NS];
#pragma unroll
    for (int r = 0; r < NS; ++r) nw[r] = 0.f;
    const int n = t % N;
    for (int jt = 0; jt < ntiles; ++jt) {
      const int k0 = jt * TQ;
      __syncthreads();  // y is done with ss and ct; bt and xt are free
      load_bc<T, N>(bt, bm, a.bss, c0, k0, rows);
      load_xbar<T>(xt, x, dt, cs, a, c0, k0, rows, p0, true, cs_last);
      __syncthreads();
      for (int k = 0; k < TQ; ++k) {
        const float bv = bt[k * LDN + n];
#pragma unroll
        for (int r = 0; r < NS; ++r)
          nw[r] = __fmaf_rn(xt[k * PB + t / N + r * (THREADS / N)], bv, nw[r]);
      }
    }
    const float dec = expf(cs_last);
#pragma unroll
    for (int r = 0; r < NS; ++r) {
      float* sp = ss + (t / N + r * (THREADS / N)) * LDN + n;
      *sp = __fadd_rn(__fmul_rn(dec, *sp), nw[r]);
    }
  }
  __syncthreads();
  for (int i = t; i < PB * N; i += THREADS) {
    const int p = i / N, nn = i % N;
    if (p0 + p < a.P) a.state[sbase + (p0 + p) * N + nn] = ss[p * LDN + nn];
  }
}

template <typename T, int N>
cudaError_t launch(const Args& a, int Bt, cudaStream_t stream) {
  static size_t allowed = 0;
  auto kernel = ssd_kernel<T, N>;
  const size_t bytes = smem_floats(N, a.Q) * sizeof(float);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  const dim3 grid((a.P + PB - 1) / PB, a.H, Bt);
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(int N, const Args& a, int Bt, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, 16>(a, Bt, stream);
    case 32: return launch<T, 32>(a, Bt, stream);
    case 64: return launch<T, 64>(a, Bt, stream);
    case 128: return launch<T, 128>(a, Bt, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (Bt, S, H, P) and B, C (Bt, S, G, N) in x's dtype (float32 or
// bfloat16), contiguous along their last dim, with element strides
// (batch, position, head or group) in `strides` (x, dt / dA, B, C in turn);
// dt and dA = dt·A (Bt, S, H) float32; init (Bt, H, P, N) float32
// contiguous or null; y (Bt, S, H, P) in x's dtype and state (Bt, H, P, N)
// float32, contiguous.  N is 16, 32, 64 or 128; H % G == 0; S >= 1.
extern "C" int ssd_scan(const void* x, const void* dt, const void* da, const void* b,
                        const void* c, const void* init, void* y, void* state,
                        int Bt, int S, int H, int G, int P, int N, int Q,
                        const long long* strides, int dtype, void* stream) {
  if (Bt < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 || Q < 1)
    return cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(da), b, c,
         static_cast<const float*>(init), y, static_cast<float*>(state),
         S, H, G, P, Q,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return dispatch_n<float>(N, a, Bt, s);
  if (dtype == DT_BF16) return dispatch_n<__nv_bfloat16>(N, a, Bt, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
