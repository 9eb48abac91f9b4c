// Shared pieces of the two attention kernels for Hopper (sm_90a): the
// grouped flash-attention forward (flash_attention.cu) and the split-KV
// decode kernel (flash_decode.cu).
//
// Both kernels walk 64-key tiles of one (batch, kv-head) pair for a tile of
// up to 16 * RT query rows (RT, the rows per thread, is 4 or 1) and update
// each row's online-softmax state (m, l) and its fp32 accumulator with
// `tile_step` below.  The per-row arithmetic of a tile depends on nothing
// but that row's data:
//   * a score is one fmaf chain over d = 0..D-1 in order;
//   * the row max is exact (max does not round);
//   * p = exp(s - m_new), zeroed where s <= -5e29 (a masked key), as the
//     Pallas kernels do, so a fully-masked row keeps l == 0 and comes out
//     exact 0, never NaN (m starts at -1e30, not -inf);
//   * the row sum of p is a fixed butterfly over the 32 lanes of one warp;
//   * acc = acc * alpha + sum_c p_c v_c, the sum one fmaf chain over the
//     tile's keys in order.
// Every rounding is an explicit intrinsic (__fmaf_rn, __fmul_rn, __fadd_rn),
// so the compiler cannot contract the two kernels differently.  Hence the
// decode kernel at one split gives the forward kernel's bits on the same
// problem (flash_decode.py at n_splits = 1 equals flash_attention.py, the
// property `test_single_split_degenerates_bit_identically` pins in the JAX
// package), and a row's bits do not depend on the other rows of its tile,
// on the batch size, on the tile a row lands in or on RT.
//
// RT is picked per launch from the grid alone (`pick_rt`): 64-row blocks
// when they give at least every other SM a block, else 16-row blocks,
// four times as many.  A 64-token prefill chunk of qwen2-0.5b at batch 1
// has 7 * 64 rows per kv-head, 14 blocks of 64 rows on 132 SMs, each
// walking the whole key extent; 16-row blocks make that 56.  Where the
// 64-row grid is already near a wave, 16-row blocks are slower: each
// thread then does 4 FFMAs per 5 shared loads instead of 16 per 8 (a
// 512-token prompt, 112 blocks of 64 rows, ran 0.082 ms on 64-row and
// 0.092 ms on 16-row blocks on an H100 SXM).
//
// Keys are masked per row by one bound: key j is live for row r iff
// j < row_end[r], where row_end = kv_len (or Skv) without causal masking and
// kv_len - Sq + i + 1 for query position i under causal masking (queries
// right-aligned against the live extent).  A tile that is dead for every row
// of the block is skipped; skipping it leaves (m, l, acc) bit for bit as an
// update would (p = 0, alpha = 1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int BKV = 64;       // keys of one tile
constexpr int THREADS = 256;  // 16 x 16 threads; 8 warps
constexpr int SMS = 132;      // streaming multiprocessors of an H100 SXM
constexpr float NEG = -1e30f;
constexpr float NEG_HALF = -5e29f;
constexpr unsigned FULL = 0xffffffffu;

enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Rows per thread of a launch whose grid has `blocks64` blocks at 64 rows
// per block: 4 when those cover half the SMs or more, else 1.
inline int pick_rt(long long blocks64) { return 2 * blocks64 >= SMS ? 4 : 1; }

// Dynamic shared memory of one block, in floats: q rows, the k and v tile
// (rows padded by one float so column reads hit distinct banks), the score /
// probability tile, and per-row m, l, alpha and row_end.
template <int D, int RT>
struct Smem {
  static constexpr int ROWS = 16 * RT;  // query rows of one block
  static constexpr int LD = D + 1;
  static constexpr int PLD = BKV + 1;
  static constexpr int Q = 0;
  static constexpr int K = Q + ROWS * LD;
  static constexpr int V = K + BKV * LD;
  static constexpr int P = V + BKV * LD;
  static constexpr int M = P + ROWS * PLD;
  static constexpr int L = M + ROWS;
  static constexpr int ALPHA = L + ROWS;
  static constexpr int END = ALPHA + ROWS;  // int row_end[ROWS]
  static constexpr size_t bytes = (END + ROWS) * sizeof(float);
};

// Load the query rows [r0, r0 + nrows) of the group's (position, head) row
// set and set each row's state.  Rows are position-major: row gr is query
// position gr / G of head kvh * G + gr % G, so a block's largest position
// is its last row's.  Returns the key bound of the whole block (the largest
// row_end), which may be <= 0 when every row is fully masked.
template <typename T, int D, int RT>
__device__ __forceinline__ int load_rows(float* sm, const T* __restrict__ q,
                                         int64_t qsb, int64_t qss, int64_t qsh,
                                         int b, int kvh, int G, int Sq,
                                         int r0, int nrows, int kvlen,
                                         int causal) {
  using S = Smem<D, RT>;
  float* qs = sm + S::Q;
  int* row_end = reinterpret_cast<int*>(sm + S::END);
  for (int i = threadIdx.x; i < nrows * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int gr = r0 + r;
    const int h = kvh * G + gr % G;
    qs[r * S::LD + d] = to_f32(q[b * qsb + (gr / G) * qss + h * qsh + d]);
  }
  for (int r = threadIdx.x; r < S::ROWS; r += THREADS) {
    sm[S::M + r] = NEG;
    sm[S::L + r] = 0.f;
    const int pos = (r0 + r) / G;
    row_end[r] = r < nrows ? (causal ? kvlen - Sq + pos + 1 : kvlen) : 0;
  }
  const int last = (r0 + nrows - 1) / G;
  return causal ? kvlen - Sq + last + 1 : kvlen;
}

// Stage keys [t0, t0 + BKV) of one (batch, kv-head) into `ks` / `vs`
// (rows of `ld` floats) as fp32; keys at or past Skv read as 0 (they are
// masked by row_end <= Skv).  fp32 rows are read as float4 where `vec`
// says the rows are 16-byte aligned (the same values, a quarter of the
// load instructions).
template <typename T, int D>
__device__ __forceinline__ void stage_kv(float* ks, float* vs, int ld,
                                         const T* __restrict__ k,
                                         const T* __restrict__ v,
                                         int64_t kss, int64_t vss, int t0,
                                         int skv, bool vec) {
  if constexpr (sizeof(T) == sizeof(float)) {
    if (vec) {
      constexpr int D4 = D / 4;
      for (int i = threadIdx.x; i < BKV * D4; i += THREADS) {
        const int c = i / D4, d = (i % D4) * 4;
        const int j = t0 + c;
        float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
        if (j < skv) {
          kk = *reinterpret_cast<const float4*>(k + j * kss + d);
          vv = *reinterpret_cast<const float4*>(v + j * vss + d);
        }
        float* kr = ks + c * ld + d;
        float* vr = vs + c * ld + d;
        kr[0] = kk.x; kr[1] = kk.y; kr[2] = kk.z; kr[3] = kk.w;
        vr[0] = vv.x; vr[1] = vv.y; vr[2] = vv.z; vr[3] = vv.w;
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < BKV * D; i += THREADS) {
    const int c = i / D, d = i % D;
    const int j = t0 + c;
    const bool in = j < skv;
    ks[c * ld + d] = in ? to_f32(k[j * kss + d]) : 0.f;
    vs[c * ld + d] = in ? to_f32(v[j * vss + d]) : 0.f;
  }
}

// Whether fp32 K / V rows may be read as float4.
template <typename T>
__device__ __forceinline__ bool kv_vec(const T* k, const T* v, int64_t kss,
                                       int64_t vss) {
  return ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
              16 == 0) &&
         kss % 4 == 0 && vss % 4 == 0;
}

// Stage a key tile into the forward / decode block's shared memory.
template <typename T, int D, int RT>
__device__ __forceinline__ void load_kv_tile(float* sm, const T* __restrict__ k,
                                             const T* __restrict__ v,
                                             int64_t kss, int64_t vss, int t0,
                                             int skv, bool vec) {
  using S = Smem<D, RT>;
  stage_kv<T, D>(sm + S::K, sm + S::V, S::LD, k, v, kss, vss, t0, skv, vec);
}

// One online-softmax update of rows [0, nrows) with the staged tile of keys
// [t0, t0 + BKV).  Thread (tr, tc) = (tid / 16, tid % 16) owns rows
// tr + 16 i (i < RT) and, in the accumulator, columns tc + 16 j (j < D / 16).
template <int D, int RT>
__device__ __forceinline__ void tile_step(float* sm, int t0, int nrows,
                                          float (&acc)[RT][D / 16]) {
  using S = Smem<D, RT>;
  constexpr int NJ = D / 16;
  const float* qs = sm + S::Q;
  const float* ks = sm + S::K;
  const float* vs = sm + S::V;
  float* ps = sm + S::P;
  const int* row_end = reinterpret_cast<const int*>(sm + S::END);
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;

  // 1. scores s = q . k, masked to -1e30
  if (tr < nrows) {
    float s[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RT], bb[4];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = qs[(tr + 16 * i) * S::LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ks[(tc + 16 * j) * S::LD + d];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(a[i], bb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = tr + 16 * i;
      if (r < nrows) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tc + 16 * j;
          ps[r * S::PLD + c] = t0 + c < row_end[r] ? s[i][j] : NEG;
        }
      }
    }
  }
  __syncthreads();

  // 2. row statistics, one warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < nrows; r += THREADS / 32) {
    const float s0 = ps[r * S::PLD + lane];
    const float s1 = ps[r * S::PLD + lane + 32];
    float mc = fmaxf(s0, s1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mc = fmaxf(mc, __shfl_xor_sync(FULL, mc, off));
    const float mp = sm[S::M + r];
    const float mn = fmaxf(mp, mc);
    const float p0 = s0 > NEG_HALF ? expf(__fadd_rn(s0, -mn)) : 0.f;
    const float p1 = s1 > NEG_HALF ? expf(__fadd_rn(s1, -mn)) : 0.f;
    ps[r * S::PLD + lane] = p0;
    ps[r * S::PLD + lane + 32] = p1;
    float sum = __fadd_rn(p0, p1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, off));
    if (lane == 0) {
      const float al = expf(__fadd_rn(mp, -mn));
      sm[S::ALPHA + r] = al;
      sm[S::L + r] = __fadd_rn(__fmul_rn(sm[S::L + r], al), sum);
      sm[S::M + r] = mn;
    }
  }
  __syncthreads();

  // 3. acc = acc * alpha + P V
  if (tr < nrows) {
    float pv[RT][NJ];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) pv[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[RT], vv[NJ];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = tr + 16 * i;
        p[i] = r < nrows ? ps[r * S::PLD + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = vs[c * S::LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) pv[i][j] = __fmaf_rn(p[i], vv[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = tr + 16 * i;
      if (r < nrows) {
        const float al = sm[S::ALPHA + r];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], al), pv[i][j]);
      }
    }
  }
  __syncthreads();
}

// Walk the tiles [lo, hi) (lo a multiple of BKV) of one (batch, kv-head)
// for the staged rows, skipping every tile at or past the block's key bound.
template <typename T, int D, int RT>
__device__ __forceinline__ void walk(float* sm, const T* __restrict__ k,
                                     const T* __restrict__ v, int64_t kss,
                                     int64_t vss, int skv, int lo, int hi,
                                     int nrows, float (&acc)[RT][D / 16]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  const bool vec = kv_vec(k, v, kss, vss);
  __syncthreads();  // the rows and their state are staged
  for (int t0 = lo; t0 < hi; t0 += BKV) {
    load_kv_tile<T, D, RT>(sm, k, v, kss, vss, t0, skv, vec);
    __syncthreads();
    tile_step<D, RT>(sm, t0, nrows, acc);
  }
}

// Set a kernel's dynamic shared-memory limit once per instantiation.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace attn
