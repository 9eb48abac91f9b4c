// Grouped flash-attention backward for Hopper (sm_90a): two kernels that
// recompute the probability tiles from (q, k, lse) and never form the
// Sq x Skv matrix, as the forward.
//
//   flash_attention_bwd_dq    dQ = (P o (dO V^T - Delta)) K
//   flash_attention_bwd_dkv   dV = P^T dO,  dK = (P o (dO V^T - Delta))^T Q
//
// with P = exp(s - lse) on the live (query, key) pairs and exact 0 elsewhere,
// s = q . k, q already scaled by sm_scale (the scale is folded into q in
// fp32 outside the kernels, so it is an ordinary differentiable multiply),
// lse the forward's per-row residual (flash_attention.cu, LSE flag) and
// Delta = rowsum(dO o O), both fp32 (B, H, Sq), computed by the caller.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_bwd_dq_kernel
// (pallas_call at flash_attention.py:409) and ::_flash_bwd_dkv_kernel
// (pallas_call at flash_attention.py:441), with their contract: grouped KV
// (query head h reads kv-head h // G), causal queries right-aligned to
// kv_len - Sq (or Skv - Sq without kv_len), keys at or past a per-batch
// kv_len masked, dead tiles skipped, and rows with no live key give
// exact-0 gradients, never NaN: P is set to 0 by the mask, not by
// exp(-inf), and such a row has lse = Delta = 0.
//
// What bounds them on an H100: on qwen2-0.5b's training shape (batch 8,
// 512 positions, 14 query heads over 2 kv-heads of 64, fp32 under
// fp32_strict) the two kernels do 14 D FLOPs per live (query, key) pair
// and head (6 D in dQ: s, dO V^T, dS K; 8 D in dK / dV: s, dO V^T, P^T dO,
// dS^T Q) and move q, k, v, dO and the outputs about once, so the card's
// fp32 FFMA rate (about 67 TFLOP/s on the SXM part) is the bound.  No
// tensor cores: under fp32_strict there is no TF32.
//
// What the design does about it, kept simple and exact first:
//   * dQ: one block per (batch, kv-head, 16 RT query rows of the G heads),
//     as the forward (position-major rows, RT from pick_rt), the key tiles
//     a loop inside the block.  Per tile: s and dO V^T as 4 x 4 register
//     micro-tiles over D in one fmaf chain each (s the forward's chain, so
//     P agrees with the forward's normalisation), dS to shared memory, then
//     dQ += dS K into RT x D/16 fp32 registers per thread;
//   * dK / dV: one block per (batch, kv-head, 64-key tile).  A loop inside
//     the block walks every live 64-row chunk of the G Sq query rows (all G
//     heads of the group), so the group's reduction happens in the block
//     and dK / dV come out compact (B, Skv, KV, D) with no H-broadcast and
//     no atomics: each output element is one thread's fmaf chain in a
//     fixed order, so the bits are the same run to run.  At batch 8, two
//     kv-heads and 512 keys that is 128 blocks on the 132 SMs;
//   * q, k, v and dO are read in the engine layout (B, S, heads, D)
//     through strides; keys past Skv read as 0 and are masked; chunks and
//     tiles dead for the whole block are skipped.
// wgmma, TMA and double buffering are later work.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int QR = 64;  // query rows of one dK / dV chunk

// Dynamic shared memory of a backward block, in floats: `ROWS` query rows
// of q and dO, the k and v tile, the P and dS tiles (P only for dK / dV),
// per-row lse, Delta and row_end.  Rows padded by one float, as Smem.
template <int D, int ROWS, bool WITH_P>
struct BwdSmem {
  static constexpr int LD = D + 1;
  static constexpr int PLD = BKV + 1;
  static constexpr int Q = 0;
  static constexpr int DO = Q + ROWS * LD;
  static constexpr int K = DO + ROWS * LD;
  static constexpr int V = K + BKV * LD;
  static constexpr int DS = V + BKV * LD;
  static constexpr int P = DS + ROWS * PLD;
  static constexpr int LSE = P + (WITH_P ? ROWS * PLD : 0);
  static constexpr int DELTA = LSE + ROWS;
  static constexpr int END = DELTA + ROWS;  // int row_end[ROWS]
  static constexpr size_t bytes = (END + ROWS) * sizeof(float);
};

struct Strides {  // element strides (batch, position, head) of one operand
  int64_t b, s, h;
};

// Stage the query rows [r0, r0 + nrows) of the group's position-major row
// set (row gr is position gr / G of head kvh * G + gr % G): q and dO rows
// as fp32, lse, Delta and each row's key bound.  Rows past nrows are 0
// with bound 0 (masked).
template <typename T, int D, int ROWS, bool WITH_P>
__device__ __forceinline__ void stage_rows(
    float* sm, const T* __restrict__ q, Strides qs, const T* __restrict__ dout,
    Strides ds, const float* __restrict__ lse, const float* __restrict__ delta,
    int b, int kvh, int G, int H, int Sq, int r0, int nrows, int kvlen,
    int causal) {
  using S = BwdSmem<D, ROWS, WITH_P>;
  int* row_end = reinterpret_cast<int*>(sm + S::END);
  for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int gr = r0 + r;
    const int h = kvh * G + gr % G, pos = gr / G;
    const bool in = r < nrows;
    sm[S::Q + r * S::LD + d] =
        in ? to_f32(q[b * qs.b + pos * qs.s + h * qs.h + d]) : 0.f;
    sm[S::DO + r * S::LD + d] =
        in ? to_f32(dout[b * ds.b + pos * ds.s + h * ds.h + d]) : 0.f;
  }
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    const int gr = r0 + r;
    const int h = kvh * G + gr % G, pos = gr / G;
    const bool in = r < nrows;
    const int64_t at = (static_cast<int64_t>(b) * H + h) * Sq + pos;
    sm[S::LSE + r] = in ? lse[at] : 0.f;
    sm[S::DELTA + r] = in ? delta[at] : 0.f;
    row_end[r] = in ? (causal ? kvlen - Sq + pos + 1 : kvlen) : 0;
  }
}

// The key bound of rows [r0, r0 + nrows): the last row's (rows are
// position-major, so the bound does not fall along them).
__device__ __forceinline__ int rows_end(int r0, int nrows, int G, int Sq,
                                        int kvlen, int causal) {
  const int last = (r0 + nrows - 1) / G;
  return causal ? kvlen - Sq + last + 1 : kvlen;
}

// P and dS of the staged rows (thread (tr, tc) computes rows tr + 16 i,
// keys tc + 16 j of the staged tile starting at key t0) into shared
// memory: s = q . k and dp = dO . v as one fmaf chain over d each (s the
// forward's chain), p = exp(s - lse) where the pair is live and exact 0
// elsewhere, ds = p (dp - Delta).
template <int D, int ROWS, bool WITH_P>
__device__ __forceinline__ void probs(float* sm, int t0) {
  using S = BwdSmem<D, ROWS, WITH_P>;
  constexpr int RT = ROWS / 16;
  const int* row_end = reinterpret_cast<const int*>(sm + S::END);
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float s[RT][4], dp[RT][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[RT], o[RT], kk[4], vv[4];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      a[i] = sm[S::Q + (tr + 16 * i) * S::LD + d];
      o[i] = sm[S::DO + (tr + 16 * i) * S::LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kk[j] = sm[S::K + (tc + 16 * j) * S::LD + d];
      vv[j] = sm[S::V + (tc + 16 * j) * S::LD + d];
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __fmaf_rn(a[i], kk[j], s[i][j]);
        dp[i][j] = __fmaf_rn(o[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = tr + 16 * i;
    const float lse = sm[S::LSE + r], delta = sm[S::DELTA + r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tc + 16 * j;
      const float p =
          t0 + c < row_end[r] ? expf(__fadd_rn(s[i][j], -lse)) : 0.f;
      sm[S::DS + r * S::PLD + c] = __fmul_rn(p, __fadd_rn(dp[i][j], -delta));
      if constexpr (WITH_P) sm[S::P + r * S::PLD + c] = p;
    }
  }
}

template <typename T, int D, int RT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_len, T* __restrict__ dq,
                    int Sq, int Skv, int H, int KV, Strides qst, Strides kst,
                    Strides vst, Strides dst, int causal) {
  constexpr int ROWS = 16 * RT;
  using S = BwdSmem<D, ROWS, false>;
  constexpr int NJ = D / 16;
  extern __shared__ float sm[];
  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int r0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, G * Sq - r0);
  const int kvlen = kv_len ? kv_len[b] : Skv;
  stage_rows<T, D, ROWS, false>(sm, q, qst, dout, dst, lse, delta, b, kvh, G,
                                H, Sq, r0, nrows, kvlen, causal);
  const int hi = min(rows_end(r0, nrows, G, Sq, kvlen, causal), Skv);
  const T* kb = k + b * kst.b + kvh * kst.h;
  const T* vb = v + b * vst.b + kvh * vst.h;
  const bool vec = kv_vec(kb, vb, kst.s, vst.s);
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[RT][NJ];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int t0 = 0; t0 < hi; t0 += BKV) {
    __syncthreads();  // rows staged / the last tile's reads done
    stage_kv<T, D>(sm + S::K, sm + S::V, S::LD, kb, vb, kst.s, vst.s, t0, Skv,
                   vec);
    __syncthreads();
    probs<D, ROWS, false>(sm, t0);
    __syncthreads();
    // dQ += dS K, one fmaf chain over the tile's keys in order
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float dsv[RT], kk[NJ];
#pragma unroll
      for (int i = 0; i < RT; ++i) dsv[i] = sm[S::DS + (tr + 16 * i) * S::PLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = sm[S::K + c * S::LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = __fmaf_rn(dsv[i], kk[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = tr + 16 * i;
    if (r >= nrows) continue;
    const int gr = r0 + r;
    const int h = kvh * G + gr % G;
    T* row = dq + ((static_cast<int64_t>(b) * Sq + gr / G) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(row + tc + 16 * j, acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ kv_len, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Skv, int H, int KV,
                     Strides qst, Strides kst, Strides vst, Strides dst,
                     int causal) {
  using S = BwdSmem<D, QR, true>;
  constexpr int NJ = D / 16;
  constexpr int KT = BKV / 16;  // keys per thread
  extern __shared__ float sm[];
  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int t0 = blockIdx.x * BKV;
  const int kvlen = kv_len ? kv_len[b] : Skv;
  const int rows = G * Sq;
  const T* kb = k + b * kst.b + kvh * kst.h;
  const T* vb = v + b * vst.b + kvh * vst.h;
  stage_kv<T, D>(sm + S::K, sm + S::V, S::LD, kb, vb, kst.s, vst.s, t0, Skv,
                 kv_vec(kb, vb, kst.s, vst.s));
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float dka[KT][NJ], dva[KT][NJ];  // keys tr + 16 i, columns tc + 16 j
#pragma unroll
  for (int i = 0; i < KT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;
  // Under causal masking the first rows see no key of this tile: start at
  // the chunk holding the first position whose bound passes t0.
  const int first = causal ? max(0, t0 - kvlen + Sq) * G : 0;
  for (int r0 = t0 < kvlen ? first / QR * QR : rows; r0 < rows; r0 += QR) {
    const int nrows = min(QR, rows - r0);
    if (rows_end(r0, nrows, G, Sq, kvlen, causal) <= t0) continue;
    __syncthreads();  // the tile is staged / the last chunk's reads done
    stage_rows<T, D, QR, true>(sm, q, qst, dout, dst, lse, delta, b, kvh, G,
                               H, Sq, r0, nrows, kvlen, causal);
    __syncthreads();
    probs<D, QR, true>(sm, t0);
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q, one fmaf chain over the rows in order
#pragma unroll 2
    for (int r = 0; r < nrows; ++r) {
      float p[KT], dsv[KT], o[NJ], qq[NJ];
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        p[i] = sm[S::P + r * S::PLD + tr + 16 * i];
        dsv[i] = sm[S::DS + r * S::PLD + tr + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        o[j] = sm[S::DO + r * S::LD + tc + 16 * j];
        qq[j] = sm[S::Q + r * S::LD + tc + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < KT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dva[i][j] = __fmaf_rn(p[i], o[j], dva[i][j]);
          dka[i][j] = __fmaf_rn(dsv[i], qq[j], dka[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < KT; ++i) {
    const int key = t0 + tr + 16 * i;
    if (key >= Skv) continue;
    const int64_t at = ((static_cast<int64_t>(b) * Skv + key) * KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      store(dk + at + tc + 16 * j, dka[i][j]);
      store(dv + at + tc + 16 * j, dva[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* kv_len;
  int B, Sq, Skv, H, KV;
  Strides st[4];  // q, k, v, dO
  int causal;
  cudaStream_t stream;
};

template <typename T, int D, int RT>
cudaError_t launch_dq(const Args& a, void* dq) {
  static bool smem_set = false;
  auto kernel = flash_bwd_dq_kernel<T, D, RT>;
  const size_t bytes = BwdSmem<D, 16 * RT, false>::bytes;
  cudaError_t err = allow_smem(kernel, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const int rows = (a.H / a.KV) * a.Sq;
  const dim3 grid((rows + 16 * RT - 1) / (16 * RT), a.B * a.KV);
  kernel<<<grid, THREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.kv_len, static_cast<T*>(dq), a.Sq, a.Skv, a.H, a.KV,
      a.st[0], a.st[1], a.st[2], a.st[3], a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  static bool smem_set = false;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const size_t bytes = BwdSmem<D, QR, true>::bytes;
  cudaError_t err = allow_smem(kernel, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + BKV - 1) / BKV, a.B * a.KV);
  kernel<<<grid, THREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.kv_len, static_cast<T*>(dk), static_cast<T*>(dv), a.Sq,
      a.Skv, a.H, a.KV, a.st[0], a.st[1], a.st[2], a.st[3], a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(const Args& a, void* dq, void* dk, void* dv) {
  if (dq == nullptr) return launch_dkv<T, D>(a, dk, dv);
  const long long blocks64 = ((a.H / a.KV) * static_cast<long long>(a.Sq) + 63) / 64 * a.B * a.KV;
  return pick_rt(blocks64) == 4 ? launch_dq<T, D, 4>(a, dq)
                                : launch_dq<T, D, 1>(a, dq);
}

template <typename T>
cudaError_t run_d(int D, const Args& a, void* dq, void* dk, void* dv) {
  switch (D) {
    case 32:
      return run<T, 32>(a, dq, dk, dv);
    case 64:
      return run<T, 64>(a, dq, dk, dv);
    case 128:
      return run<T, 128>(a, dq, dk, dv);
    default:
      return cudaErrorInvalidValue;
  }
}

// dq != null launches the dQ kernel, else the dK / dV kernel.
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, const void* kv_len,
             void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H,
             int KV, int D, const long long* st, int causal, int dtype,
             void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int*>(kv_len),
         B, Sq, Skv, H, KV, {}, causal, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < 4; ++i)
    a.st[i] = {static_cast<int64_t>(st[3 * i]), static_cast<int64_t>(st[3 * i + 1]),
               static_cast<int64_t>(st[3 * i + 2])};
  if (dtype == DT_F32) return run_d<float>(D, a, dq, dk, dv);
  if (dtype == DT_BF16) return run_d<__nv_bfloat16>(D, a, dq, dk, dv);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, H, D), k / v (B, Skv, KV, D) and dO (B, Sq, H, D) in the engine
// layout, each with element strides (batch, position, head) in `strides`
// (q, k, v, dO in turn) and contiguous along D; lse and delta (B, H, Sq)
// fp32 contiguous; kv_len a (B,) int32 device array clamped to Skv, or
// null.  dq (B, Sq, H, D) contiguous, in the operands' dtype.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* kv_len, void* dq, int B,
                                      int Sq, int Skv, int H, int KV, int D,
                                      const long long* strides, int causal,
                                      int dtype, void* stream) {
  return dispatch(q, k, v, dout, lse, delta, kv_len, dq, nullptr, nullptr, B,
                  Sq, Skv, H, KV, D, strides, causal, dtype, stream);
}

// As flash_attention_bwd_dq; dk and dv (B, Skv, KV, D) contiguous, in the
// operands' dtype.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* kv_len, void* dk, void* dv,
                                       int B, int Sq, int Skv, int H, int KV,
                                       int D, const long long* strides,
                                       int causal, int dtype, void* stream) {
  return dispatch(q, k, v, dout, lse, delta, kv_len, nullptr, dk, dv, B, Sq,
                  Skv, H, KV, D, strides, causal, dtype, stream);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
