// Grouped flash-attention backward for Hopper (sm_90a): two kernels that
// recompute the probability tiles from (q, k, lse) and never form the
// Sq x Skv matrix, as the forward.
//
//   flash_attention_bwd_dq    dQ = (P o (dO V^T - Delta)) K
//   flash_attention_bwd_dkv   dV = P^T dO,  dK = (P o (dO V^T - Delta))^T Q
//
// with P = exp(s - lse) on the live (query, key) pairs and exact 0 elsewhere,
// s = q . k, q already scaled by sm_scale (folded into q in fp32 outside the
// kernels), lse the forward's per-row residual (flash_attention.cu, LSE
// flag) and Delta = rowsum(dO o O), both fp32 (B, H, Sq), from the caller.
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
// What bounds them on an H100: per live (query, key) pair and head, dQ does
// 6 D FLOPs (s, dO V^T, dS K) and dK / dV 8 D (s, dO V^T, P^T dO, dS^T Q),
// and both move q, k, v, dO and their outputs about once, so the card's
// fp32 FFMA rate (67 TFLOP/s on the SXM part) is the bound; under
// fp32_strict there are no tensor cores (no TF32).  Next to it, shared
// memory: an SM issues 128 FFMAs a clock but its shared memory delivers 128
// bytes a clock, and a warp's 16-byte read takes four of those clocks
// whatever its lanes share, so what counts is the FFMAs a thread does per
// float it reads: 2 for a 4 x 4 register tile, 2.67 for 8 x 4.  And dK / dV
// have few elements (512 keys x 64 columns per kv-head at the training
// shape), so 256 threads of a 32-key block hold 16 of them each, a 4 x 4
// tile at most.
//
// What the design does about it:
//   * register tiles fed by 16-byte shared reads, operand rows padded by
//     16 bytes (aligned for vector reads, eight consecutive rows on
//     distinct banks): s and dp are split between the warp halves (warps
//     0-3 s, 4-7 dp), 8 x 4 a thread (4 x 4 or 2 x 4 where the rows are
//     few), and each half finishes p and ds for half of its rows, the other
//     half's s or dp passed on through shared memory, so both halves run
//     the same number of expf; the dK / dV update is split the same way
//     (warps 0-3 dV = P^T dO, 4-7 dK = dS^T Q, 4 keys x D/16 columns a
//     thread: runs of 4 columns 64 apart, then a tail, as the forward's
//     columns, so head dims 80, 112 and 192 read 4 + 1, 4 + 3 and
//     4 + 4 + 4 columns, the runs as 16-byte reads); the dQ update gives
//     each thread CN columns of ROWS / RG rows over CL column lanes: up to
//     head dim 128 one run of 4 columns (CL = D/4, D/16 warps across the
//     columns and 8 / (D/16) down the rows), at 192 three runs of 4
//     columns 64 apart (CL = 16: 4 warps across, 2 down), so every (row,
//     column) has one owner: at head dims 32, 64, 128 and 192 all 256
//     threads, at 80 and 112 the first 5 and 7 warps (8 row groups of 8
//     rows in the 64-row plan, of 2 in the 16-row one; 16 groups of one
//     row at 192);
//   * operands are staged by 16-byte cp.async (gemm_common.cuh), the next
//     tile or chunk while the current one computes, bf16 copied raw and
//     widened as it is read, unaligned or ragged rows element by element
//     with zeros past the edge, piece i of a tile to thread i % 256 as in
//     the forward (a row of 80 or 112 columns is 20 or 28 pieces in fp32,
//     which do not divide the 256 threads); a thread steps through its q
//     and dO rows with one division by G per chunk;
//   * head dims 32, 64, 80, 112, 128 and 192 (run_d); shared memory of
//     one fp32 block, dQ's 64-row plan / dK / dV: 147,456 / 126,976 bytes
//     at 80, 196,608 / 167,936 at 112, 221,184 / 188,416 at 128; at 192
//     (MLA's prefill) the 64-row dQ block would need 319,488 bytes, so
//     only the 16-row plan is instantiated there (231,936 bytes), in both
//     dtypes (`admitted`, one rule as the forward's), and dK / dV take
//     32-row chunks (160,256 bytes; 64 rows would need 270,336);
//   * dK / dV: one block per (batch, kv-head) and 32-key tile, its loop
//     walking the live chunks (128 rows up to head dim 64, 64 up to 128,
//     32 beyond) of
//     the G Sq query rows of the group, so the group's reduction happens in
//     the block with no atomics: 256 blocks at the training shape;
//   * dQ: one block per (batch, kv-head) and 16 or 64 query rows of the
//     G heads (position-major), the 64-key tiles a loop inside it;
//   * under causal masking a block's work grows with its query positions
//     (dQ) or falls with its keys (dK / dV), so both grids list the
//     heaviest blocks first: no heavy block starts last, and the card,
//     which hands out blocks as SMs free up, fills the tail with light
//     ones (a block of key tiles i and n-1-i, equal work per block, ran no
//     faster);
//   * the plan, dQ's rows per block, is picked from the shape in Python
//     (flash_attention.py::bwd_plan_for), for speed only.
//
// The invariant every plan keeps, so that every output has the bits of
// any other plan and of the earlier one-tile-per-block kernels:
//   * s = q . k and dp = dO . v are each one __fmaf_rn chain over
//     d = 0 .. D-1 in order from +0 (s the forward's chain, so P agrees with
//     the forward's lse); p = expf(__fadd_rn(s, -lse)) on a live pair,
//     exact 0 otherwise; ds = __fmul_rn(p, __fadd_rn(dp, -Delta));
//   * each dQ element is one __fmaf_rn chain over the keys in ascending
//     order, across all tiles;
//   * each dK and dV element is one __fmaf_rn chain over the group's
//     position-major rows in ascending order (row gr is position gr / G of
//     head kvh * G + gr % G): this is how the G heads of a group are summed;
//   * bf16 operands are widened by __bfloat162float, outputs rounded by
//     __float2bfloat16_rn.
// Rows and keys are skipped only where every pair is dead, whose products
// are exact zeros that leave a sum as it is.  No atomics, no split of a
// chain, no tensor-core product.

#include "attention_common.cuh"
#include "gemm_common.cuh"

namespace {

using attn::allow_smem;
using attn::DT_BF16;
using attn::DT_F32;
using attn::THREADS;  // 256: 8 warps
using gemm::copy_piece;
using gemm::cp_async4;
using gemm::cp_async_commit;
using gemm::cp_async_wait;
using gemm::lane4;
using gemm::load4;

constexpr int KEYS = 32;  // keys of a dK / dV tile
constexpr int BKV = 64;   // keys of a dQ tile
constexpr size_t SM_BYTES = 233472;  // shared memory of an H100 SM

// The instantiated plans, by id (kernels/flash_attention.py::BWD_PLANS in
// the same order): dQ's query rows per block.
constexpr int PLAN_ROWS[] = {64, 16};
constexpr int N_PLANS = sizeof(PLAN_ROWS) / sizeof(PLAN_ROWS[0]);

// Row stride, in elements, of a staged operand tile: D padded by 16 bytes.
template <typename T, int D>
__host__ __device__ constexpr int ld() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// Blocks per SM that `bytes` of shared memory allow, capped at 2: the
// launch bound that keeps their registers within the SM's.
constexpr int min_blocks(size_t bytes) {
  return 2 * (bytes + 1024) <= SM_BYTES ? 2 : 1;
}

struct Strides {  // element strides (batch, position, head) of one operand
  int64_t b, s, h;
};

// Whether every row of an operand may be copied in 16-byte pieces.
template <typename T>
__device__ __forceinline__ bool rows_vec(const T* p, Strides st) {
  constexpr int VEC = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % VEC == 0 &&
         st.s % VEC == 0 && st.h % VEC == 0;
}

// Row r of two operands that are staged together (q and dO, k and v):
// where each starts, or null for a row of zeros.
template <typename T>
struct RowPair {
  const T* a;
  const T* b;
};

// The rows one thread stages lie row_step() apart, or one more where a
// row's 16-byte pieces do not divide the block's threads (head dims 80
// and 112: 12.8 and 9.1 rows in fp32, 25.6 and 18.3 in bf16).
template <typename T, int D>
__host__ __device__ constexpr int row_step() {
  return THREADS / (D / (16 / static_cast<int>(sizeof(T))));
}

// Copy ROWS rows of D elements of two operands into shared rows of
// ld<T, D>() elements, in 16-byte pieces spread over the block as the
// forward stages (flash_attention.cu): piece i of the flat ROWS x PIECES
// range to thread i % THREADS, row r from where(r), one call for both
// operands, each thread asking for its rows in ascending order.
// Asynchronous: visible after cp_async_wait and a barrier.
template <typename T, int D, int ROWS, typename Where>
__device__ __forceinline__ void stage_rows(T* dst_a, T* dst_b, Where where,
                                           bool vec_a, bool vec_b) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PIECES = D / VEC;
  static_assert(D % VEC == 0, "a row is whole 16-byte pieces");
  for (int i = threadIdx.x; i < ROWS * PIECES; i += THREADS) {
    const int r = i / PIECES, e = i % PIECES * VEC;
    const RowPair<T> src = where(r);
    const int at = r * ld<T, D>() + e;
    copy_piece(dst_a + at, src.a ? src.a + e : src.a, vec_a, src.a ? VEC : 0);
    copy_piece(dst_b + at, src.b ? src.b + e : src.b, vec_b, src.b ? VEC : 0);
  }
}

// Rows r0 + r (r < nrows; zeros past) of q and dO in a group's
// position-major row set: row gr is position gr / G of head kvh * G + gr % G,
// `a` and `b` q and dO at (batch, head kvh * G, position 0).  A where() of
// stage_rows: the first row costs a division by G, each next one, `step`
// = step_pos * G + step_g rows on (row_step()) or one row more, adds.
template <typename T>
struct GroupRows {
  const T *a, *b;
  Strides sa, sb;
  int r0, nrows, G, step, step_pos, step_g;
  int prev = -1, pos = 0, g = 0;
  __device__ __forceinline__ RowPair<T> operator()(int r) {
    if (prev < 0) {
      pos = (r0 + r) / G;
      g = r0 + r - pos * G;
    } else {
      pos += step_pos;
      g += step_g;
      if (g >= G) {
        g -= G;
        ++pos;
      }
      if (r - prev > step && ++g == G) {
        g = 0;
        ++pos;
      }
    }
    prev = r;
    if (r >= nrows) return {nullptr, nullptr};
    return {a + pos * sa.s + g * sa.h, b + pos * sb.s + g * sb.h};
  }
};

// acc[i][j] = a[ra + 8 i] . b[kb + 4 j] over d = 0 .. D-1, one fmaf chain
// each in order from +0, the rows read 4 elements at a time.
template <int D, int TR, int TK, typename T>
__device__ __forceinline__ void dot_tile(const T* a, const T* b, int ra,
                                         int kb, float (&acc)[TR][TK]) {
  constexpr int LD = ld<T, D>();
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TK; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[TR], y[TK];
#pragma unroll
    for (int i = 0; i < TR; ++i) x[i] = load4(a + (ra + 8 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < TK; ++j) y[j] = load4(b + (kb + 4 * j) * LD + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j)
          acc[i][j] = __fmaf_rn(lane4(x[i], e), lane4(y[j], e), acc[i][j]);
  }
}

// Index of element j of the N values a thread holds in group g of the
// LANES groups of a row, the forward's column rule (flash_attention.cu
// col): N / 4 runs of 4 consecutive elements, 4 LANES apart (each run one
// 16-byte read), then a tail of N % 4 consecutive elements past the runs'
// 4 LANES (N / 4).  dK / dV's columns (LANES 16): 4 at head dim 64, 4 + 4
// at 128, a tail of 2 at 32, 4 + 1 at 80 (a run over columns 0-63, the
// tail over 64-79), 4 + 3 at 112 (the tail over 64-111); dQ's rows of dS^T
// (LANES the row groups) the same way.
template <int N, int LANES>
__host__ __device__ constexpr int elem(int g, int j) {
  constexpr int RUNS = N / 4, TAIL = N % 4;
  return j < 4 * RUNS ? (j / 4) * 4 * LANES + 4 * g + j % 4
                      : 4 * RUNS * LANES + TAIL * g + (j - 4 * RUNS);
}

// out[j] = row[elem<N, LANES>(g, j)] as fp32: the runs as 16-byte (fp32)
// or 8-byte (bf16) vectors, the tail element by element.
template <int N, int LANES, typename T>
__device__ __forceinline__ void load_n(const T* row, int g, float (&out)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = load4(row + q * 4 * LANES + g * 4);
    out[4 * q] = v.x;
    out[4 * q + 1] = v.y;
    out[4 * q + 2] = v.z;
    out[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int j = N / 4 * 4; j < N; ++j)
    out[j] = attn::to_f32(row[elem<N, LANES>(g, j)]);
}

// Store 4 consecutive fp32 values (p 16-byte aligned for fp32, 8 for bf16).
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo, hi;
  lo.x = __float2bfloat16_rn(v[0]);
  lo.y = __float2bfloat16_rn(v[1]);
  hi.x = __float2bfloat16_rn(v[2]);
  hi.y = __float2bfloat16_rn(v[3]);
  reinterpret_cast<__nv_bfloat162*>(p)[0] = lo;
  reinterpret_cast<__nv_bfloat162*>(p)[1] = hi;
}

// Store a thread's N values of one output row at the columns of load_n:
// the runs 4 at a time, the tail element by element (so its pieces need
// no alignment beyond the element's, bf16 included).
template <int N, int LANES, typename T>
__device__ __forceinline__ void store_n(T* row, int g, const float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float w[4] = {v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]};
    store4(row + q * 4 * LANES + g * 4, w);
  }
#pragma unroll
  for (int j = N / 4 * 4; j < N; ++j)
    attn::store(row + elem<N, LANES>(g, j), v[j]);
}

// Shared memory of a dQ block, in bytes: q and dO rows (T), two stages of
// the k and v tile (T), and dS transposed (fp32, keys by rows), which also
// carries s or dp from one warp half to the other.
template <typename T, int D, int ROWS>
struct DqSmem {
  static constexpr int LD = ld<T, D>();
  static constexpr int DLD = ROWS + 8;  // dS^T row stride: no bank conflict
  static constexpr size_t TILE = static_cast<size_t>(BKV) * LD * sizeof(T);
  static constexpr size_t Q = 0;
  static constexpr size_t DO = Q + ROWS * LD * sizeof(T);
  static constexpr size_t K = DO + ROWS * LD * sizeof(T);
  static constexpr size_t V = K + 2 * TILE;
  static constexpr size_t DS = V + 2 * TILE;
  static constexpr size_t bytes = DS + BKV * DLD * sizeof(float);
  static constexpr int MIN_BLOCKS = min_blocks(bytes);
};

// dQ of ROWS position-major query rows of one (batch, kv-head).  Block x
// is row block nrb - 1 - x / nbh (the highest positions, which see the
// most keys, first) of (batch, kv-head) x % nbh.
template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(THREADS, DqSmem<T, D, ROWS>::MIN_BLOCKS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_len, T* __restrict__ dq,
                    int nbh, int Sq, int Skv, int H, int KV, Strides qst,
                    Strides kst, Strides vst, Strides dst, int causal) {
  using S = DqSmem<T, D, ROWS>;
  constexpr int LD = S::LD;
  constexpr int TR = ROWS / 8;            // rows of s or dp a thread holds
  constexpr int CL = D / 4 <= 32 ? D / 4 : 16;  // column lanes of dQ
  constexpr int CN = D / CL;              // columns of dQ a thread holds
  constexpr int WD = CL / 4;              // warps across the columns
  constexpr int WR = THREADS / 32 / WD;   // warps down the rows
  constexpr int RG = WR * 8 < ROWS ? WR * 8 : ROWS;  // row groups
  constexpr int RC = ROWS / RG;           // rows of dQ a thread holds
  static_assert(D % 16 == 0 && CN % 4 == 0 && CN * CL == D && WD >= 1 &&
                WD <= THREADS / 32,
                "dQ's column lanes fill whole warps of 4 lanes, each lane "
                "whole runs of 4 columns");
  static_assert(RG % 8 == 0 && RG * RC == ROWS,
                "every dQ row has exactly one row group");
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + S::Q);
  T* dos = reinterpret_cast<T*>(smem + S::DO);
  T* ks = reinterpret_cast<T*>(smem + S::K);
  T* vs = reinterpret_cast<T*>(smem + S::V);
  float* dst_s = reinterpret_cast<float*>(smem + S::DS);

  const int G = H / KV;
  const int bh = blockIdx.x % nbh;
  const int nrb = gridDim.x / nbh;
  const int b = bh / KV, kvh = bh % KV;
  const int r0 = (nrb - 1 - static_cast<int>(blockIdx.x) / nbh) * ROWS;
  const int nrows = min(ROWS, G * Sq - r0);
  const int kvlen = kv_len ? kv_len[b] : Skv;
  const int last = (r0 + nrows - 1) / G;
  const int hi = min(causal ? kvlen - Sq + last + 1 : kvlen, Skv);
  const int ntiles = hi > 0 ? (hi + BKV - 1) / BKV : 0;

  const T* kb = k + b * kst.b + kvh * kst.h;
  const T* vb = v + b * vst.b + kvh * vst.h;
  const bool kvec = rows_vec(k, kst), vvec = rows_vec(v, vst);
  auto stage_tile = [&](int t) {
    const int t0 = t * BKV;
    const size_t off = (t & 1) * static_cast<size_t>(BKV) * LD;
    stage_rows<T, D, BKV>(ks + off, vs + off, [&](int c) {
      if (t0 + c >= Skv) return RowPair<T>{nullptr, nullptr};
      return RowPair<T>{kb + (t0 + c) * kst.s, vb + (t0 + c) * vst.s};
    }, kvec, vvec);
  };
  if (ntiles > 0) {
    constexpr int STEP = row_step<T, D>();
    stage_rows<T, D, ROWS>(
        qs, dos,
        GroupRows<T>{q + b * qst.b + kvh * G * qst.h,
                     dout + b * dst.b + kvh * G * dst.h, qst, dst, r0, nrows,
                     G, STEP, STEP / G, STEP % G},
        rows_vec(q, qst), rows_vec(dout, dst));
    stage_tile(0);
  }
  cp_async_commit();

  // s (warps 0-3, `half` 0) or dp (warps 4-7): rows ra + 8 i (i < TR),
  // keys ka + 4 j (j < 4) of the tile.  Each half finishes p and ds for
  // half of those rows (its own: i0 <= i < i0 + TR / 2), with the other
  // half's s or dp passed through dS^T; row_* are those rows' lse, Delta
  // and key bound.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = warp / 4, i0 = half * (TR / 2);
  const int ra = lane % 8, ka = (warp % 4) * 16 + lane / 8;
  float row_lse[TR / 2], row_delta[TR / 2];
  int row_end[TR / 2];
#pragma unroll
  for (int i = 0; i < TR / 2; ++i) {
    const int r = ra + 8 * (i0 + i), gr = r0 + r, pos = gr / G;
    const bool in = r < nrows;
    const int64_t at = (static_cast<int64_t>(b) * H + kvh * G + gr % G) * Sq + pos;
    row_lse[i] = in ? lse[at] : 0.f;
    row_delta[i] = in ? delta[at] : 0.f;
    row_end[i] = in ? (causal ? kvlen - Sq + pos + 1 : kvlen) : 0;
  }
  // dQ: rows elem<RC, RG>(rg, i), columns elem<CN, CL>(dg, j), each
  // (row, column) one thread's: the first WD * WR warps, WD across the
  // columns (2 at head dim 32, 4 at 64, 5 at 80, 7 at 112, 8 at 128, 4 at
  // 192) and WR down the rows (4, 2, 1, 1, 1, 2); at 80 and 112 the last
  // 3 and 1 warps hold no dQ
  const int dg = (warp % WD) * 4 + lane % 4;
  const int rg = (warp / WD) * 8 + lane / 4;
  const bool owns = warp < WD * WR && rg < RG;
  float acc[RC][CN];
#pragma unroll
  for (int i = 0; i < RC; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; tile t-1's reads are done
    if (t + 1 < ntiles) stage_tile(t + 1);
    cp_async_commit();
    const T* kt = ks + (t & 1) * static_cast<size_t>(BKV) * LD;
    const T* vt = vs + (t & 1) * static_cast<size_t>(BKV) * LD;
    const int t0 = t * BKV;
    {
      float a[TR][4];
      dot_tile<D, TR, 4>(half ? dos : qs, half ? vt : kt, ra, ka, a);
      // pass the other half's rows on, through the element of dS^T that
      // the thread finishing them rewrites
#pragma unroll
      for (int i = 0; i < TR; ++i)
        if (i < i0 || i >= i0 + TR / 2)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dst_s[(ka + 4 * j) * S::DLD + ra + 8 * i] = a[i][j];
      __syncthreads();  // every s and dp is at hand
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        if (i < i0 || i >= i0 + TR / 2) continue;
        const int h = i % (TR / 2);  // the row's index in row_*
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ka + 4 * j;
          float* at = dst_s + c * S::DLD + ra + 8 * i;
          const float s = half ? *at : a[i][j];
          const float dp = half ? a[i][j] : *at;
          const float p =
              t0 + c < row_end[h] ? expf(__fadd_rn(s, -row_lse[h])) : 0.f;
          *at = __fmul_rn(p, __fadd_rn(dp, -row_delta[h]));
        }
      }
    }
    __syncthreads();  // dS^T is complete
    if (owns) {
      // dQ += dS K, one fmaf chain over the tile's keys in order
#pragma unroll 8
      for (int c = 0; c < BKV; ++c) {
        float dsv[RC], kk[CN];
        load_n<RC, RG>(dst_s + c * S::DLD, rg, dsv);
        load_n<CN, CL>(kt + c * LD, dg, kk);
#pragma unroll
        for (int i = 0; i < RC; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j)
            acc[i][j] = __fmaf_rn(dsv[i], kk[j], acc[i][j]);
      }
    }
  }
  if (!owns) return;
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    const int r = elem<RC, RG>(rg, i);
    if (r >= nrows) continue;
    const int gr = r0 + r;
    T* row = dq + ((static_cast<int64_t>(b) * Sq + gr / G) * H + kvh * G + gr % G) * D;
    store_n<CN, CL>(row, dg, acc[i]);
  }
}

// Shared memory of a dK / dV block, in bytes: the k and v tile (T), two
// stages of a chunk's q and dO rows (T) and of its lse and Delta (fp32),
// and P and dS (fp32, rows by keys).  A chunk has 128 query rows up to
// head dim 64, 64 up to 128 and 32 beyond, within the SM's shared memory.
template <typename T, int D>
struct DkvSmem {
  static constexpr int QR = D <= 64 ? 128 : D <= 128 ? 64 : 32;
  static constexpr int LD = ld<T, D>();
  static constexpr int PLD = KEYS + 4;  // P / dS row stride: aligned, no conflict
  static constexpr size_t CHUNK = static_cast<size_t>(QR) * LD * sizeof(T);
  static constexpr size_t K = 0;
  static constexpr size_t V = K + KEYS * LD * sizeof(T);
  static constexpr size_t Q = V + KEYS * LD * sizeof(T);
  static constexpr size_t DO = Q + 2 * CHUNK;
  static constexpr size_t LSE = DO + 2 * CHUNK;
  static constexpr size_t DELTA = LSE + 2 * QR * sizeof(float);
  static constexpr size_t P = DELTA + 2 * QR * sizeof(float);
  static constexpr size_t DS = P + QR * PLD * sizeof(float);
  static constexpr size_t bytes = DS + QR * PLD * sizeof(float);
  static constexpr int MIN_BLOCKS = min_blocks(bytes);
};

// dK and dV of the 32 keys of tile x / nbh of (batch, kv-head) x % nbh
// (tile 0, which the most rows see under causal masking, first): the loop
// walks the chunks of the group's rows from the first live one.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, DkvSmem<T, D>::MIN_BLOCKS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ kv_len, T* __restrict__ dk,
                     T* __restrict__ dv, int nbh, int Sq, int Skv, int H,
                     int KV, Strides qst, Strides kst, Strides vst,
                     Strides dst, int causal) {
  using S = DkvSmem<T, D>;
  constexpr int LD = S::LD;
  constexpr int QR = S::QR;
  constexpr int TR = QR / 16;  // rows of s or dp a thread holds
  constexpr int NC = D / 16;   // columns of an update a thread holds
  static_assert(KEYS == 32, "an update's warp spans 8 groups of 4 keys");
  static_assert(NC >= 1 && NC * 16 == D,
                "an update's 16 column groups split the head dim");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem + S::K);
  T* vs = reinterpret_cast<T*>(smem + S::V);
  T* qs = reinterpret_cast<T*>(smem + S::Q);
  T* dos = reinterpret_cast<T*>(smem + S::DO);
  float* lses = reinterpret_cast<float*>(smem + S::LSE);
  float* deltas = reinterpret_cast<float*>(smem + S::DELTA);
  float* ps = reinterpret_cast<float*>(smem + S::P);
  float* dss = reinterpret_cast<float*>(smem + S::DS);

  const int t0 = static_cast<int>(blockIdx.x) / nbh * KEYS;
  const int bh = blockIdx.x % nbh;
  const int b = bh / KV, kvh = bh % KV;
  const int kvlen = kv_len ? kv_len[b] : Skv;
  const int G = H / KV;
  const int rows = G * Sq;
  // rows before `first` see no key of this tile
  const int first =
      t0 < kvlen ? (causal ? max(0, t0 - kvlen + Sq) * G : 0) : rows;
  const int nchunks = (rows - first + QR - 1) / QR;
  const bool qvec = rows_vec(q, qst), dvec = rows_vec(dout, dst);
  const T* q_grp = q + b * qst.b + kvh * G * qst.h;
  const T* do_grp = dout + b * dst.b + kvh * G * dst.h;
  constexpr int STEP = row_step<T, D>();
  const int step_pos = STEP / G, step_g = STEP % G;
  auto stage_chunk = [&](int n) {
    const int r0 = first + n * QR, nrows = min(QR, rows - r0);
    const size_t off = (n & 1) * static_cast<size_t>(QR) * LD;
    stage_rows<T, D, QR>(qs + off, dos + off,
                         GroupRows<T>{q_grp, do_grp, qst, dst, r0, nrows, G,
                                      STEP, step_pos, step_g},
                         qvec, dvec);
    for (int i = threadIdx.x; i < 2 * QR; i += THREADS) {
      const int r = i % QR;
      float* to = (i < QR ? lses : deltas) + (n & 1) * QR + r;
      if (r < nrows) {
        const int gr = r0 + r;
        const int64_t at =
            (static_cast<int64_t>(b) * H + kvh * G + gr % G) * Sq + gr / G;
        cp_async4(to, (i < QR ? lse : delta) + at);
      } else {
        *to = 0.f;
      }
    }
  };

  if (nchunks > 0) {
    const T* kb = k + b * kst.b + kvh * kst.h;
    const T* vb = v + b * vst.b + kvh * vst.h;
    stage_rows<T, D, KEYS>(ks, vs, [&](int c) {
      if (t0 + c >= Skv) return RowPair<T>{nullptr, nullptr};
      return RowPair<T>{kb + (t0 + c) * kst.s, vb + (t0 + c) * vst.s};
    }, rows_vec(k, kst), rows_vec(v, vst));
    stage_chunk(0);
  }
  cp_async_commit();

  // s (warps 0-3, `role` 0) or dp (warps 4-7): rows ra + 8 i (i < TR) of
  // the chunk, keys ka + 4 j (j < 4).  Each half finishes p and ds for
  // half of those rows (i0 <= i < i0 + TR / 2), with the other half's s or
  // dp passed through P or dS.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ra = (warp % 2) * 8 * TR + lane % 8;
  const int ka = (warp % 4 / 2) * 16 + lane / 8;
  // the update: warps 0-3 dV = P^T dO, warps 4-7 dK = dS^T Q; keys
  // kg * 4 .. kg * 4 + 3, columns elem<NC, 16>(dg, j) (16 groups)
  const int role = warp / 4, i0 = role * (TR / 2);
  const int kg = lane % 8, dg = warp % 4 * 4 + lane / 8;
  const float* upd_a = role ? dss : ps;
  const T* upd_b = role ? qs : dos;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  for (int n = 0; n < nchunks; ++n) {
    cp_async_wait<0>();
    __syncthreads();  // chunk n landed; chunk n-1's reads are done
    if (n + 1 < nchunks) stage_chunk(n + 1);
    cp_async_commit();
    const int r0 = first + n * QR, nrows = min(QR, rows - r0);
    const size_t off = (n & 1) * static_cast<size_t>(QR) * LD;
    {
      float a[TR][4];
      dot_tile<D, TR, 4>((role ? dos : qs) + off, role ? vs : ks, ra, ka, a);
      float* pass = role ? dss : ps;  // where the other half reads it
#pragma unroll
      for (int i = 0; i < TR; ++i)
        if (i < i0 || i >= i0 + TR / 2)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            pass[(ra + 8 * i) * S::PLD + ka + 4 * j] = a[i][j];
      __syncthreads();  // every s and dp is at hand
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        if (i < i0 || i >= i0 + TR / 2) continue;
        const int r = ra + 8 * i;
        const float l = lses[(n & 1) * QR + r];
        const float dl = deltas[(n & 1) * QR + r];
        const int end =
            r < nrows ? (causal ? kvlen - Sq + (r0 + r) / G + 1 : kvlen) : 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = r * S::PLD + ka + 4 * j;
          const float s = role ? ps[at] : a[i][j];
          const float dp = role ? a[i][j] : dss[at];
          const float p =
              t0 + ka + 4 * j < end ? expf(__fadd_rn(s, -l)) : 0.f;
          ps[at] = p;
          dss[at] = __fmul_rn(p, __fadd_rn(dp, -dl));
        }
      }
    }
    __syncthreads();  // P and dS are complete
    // one fmaf chain over the chunk's rows in order
    const T* bm = upd_b + off;
#pragma unroll 8
    for (int r = 0; r < nrows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(upd_a + r * S::PLD + kg * 4);
      float col[NC];
      load_n<NC, 16>(bm + r * LD, dg, col);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j)
          acc[i][j] = __fmaf_rn(lane4(a, i), col[j], acc[i][j]);
    }
  }
  T* out = role ? dk : dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = t0 + kg * 4 + i;
    if (key < Skv)
      store_n<NC, 16>(out + ((static_cast<int64_t>(b) * Skv + key) * KV + kvh) * D,
                      dg, acc[i]);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* kv_len;
  int B, Sq, Skv, H, KV;
  Strides st[4];  // q, k, v, dO
  int causal;
  int rows;  // dQ's plan
  cudaStream_t stream;
};

template <typename T, int D, int ROWS>
cudaError_t launch_dq(const Args& a, void* dq) {
  static bool smem_set = false;
  auto kernel = flash_bwd_dq_kernel<T, D, ROWS>;
  const size_t bytes = DqSmem<T, D, ROWS>::bytes;
  cudaError_t err = allow_smem(kernel, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const long long nrb = (static_cast<long long>(a.H / a.KV) * a.Sq + ROWS - 1) / ROWS;
  const long long blocks = nrb * a.B * a.KV;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), THREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.kv_len, static_cast<T*>(dq), a.B * a.KV, a.Sq, a.Skv, a.H,
      a.KV, a.st[0], a.st[1], a.st[2], a.st[3], a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  static bool smem_set = false;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const size_t bytes = DkvSmem<T, D>::bytes;
  cudaError_t err = allow_smem(kernel, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>((a.Skv + KEYS - 1) / KEYS) * a.B * a.KV;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), THREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.kv_len, static_cast<T*>(dk), static_cast<T*>(dv),
      a.B * a.KV, a.Sq, a.Skv, a.H, a.KV, a.st[0], a.st[1], a.st[2], a.st[3],
      a.causal);
  return cudaGetLastError();
}

// Shared memory one block may use on an H100.
constexpr size_t MAX_SMEM = 232448;

// A dQ plan is instantiated at D where its fp32 block fits in shared
// memory (one rule for both dtypes): both plans up to head dim 128, the
// 16-row plan alone at 192.  flash_attention.py::bwd_plans_at states the
// same rule and refuses the others first.
template <int D, int ROWS>
constexpr bool admitted() {
  return DqSmem<float, D, ROWS>::bytes <= MAX_SMEM;
}

template <typename T, int D, int ROWS>
cudaError_t launch_dq_if_admitted(const Args& a, void* dq) {
  if constexpr (admitted<D, ROWS>()) {
    return launch_dq<T, D, ROWS>(a, dq);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t run(const Args& a, void* dq, void* dk, void* dv) {
  static_assert(DkvSmem<float, D>::bytes <= MAX_SMEM,
                "the dK / dV block fits in shared memory");
  if (dq == nullptr) return launch_dkv<T, D>(a, dk, dv);
  return a.rows == 64 ? launch_dq_if_admitted<T, D, 64>(a, dq)
                      : launch_dq_if_admitted<T, D, 16>(a, dq);
}

template <typename T>
cudaError_t run_d(int D, const Args& a, void* dq, void* dk, void* dv) {
  switch (D) {
    case 32:
      return run<T, 32>(a, dq, dk, dv);
    case 64:
      return run<T, 64>(a, dq, dk, dv);
    case 80:
      return run<T, 80>(a, dq, dk, dv);
    case 112:
      return run<T, 112>(a, dq, dk, dv);
    case 128:
      return run<T, 128>(a, dq, dk, dv);
    case 192:
      return run<T, 192>(a, dq, dk, dv);
    default:
      return cudaErrorInvalidValue;
  }
}

// dq != null launches the dQ kernel under plan `plan`, else the dK / dV
// kernel.
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, const void* kv_len,
             void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H,
             int KV, int D, const long long* st, int causal, int dtype,
             int plan, void* stream) {
  if (plan < 0 || plan >= N_PLANS) return cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<const int*>(kv_len),
         B, Sq, Skv, H, KV, {}, causal, PLAN_ROWS[plan],
         static_cast<cudaStream_t>(stream)};
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
// null; `plan` an index of PLAN_ROWS.  dq (B, Sq, H, D) contiguous, in the
// operands' dtype.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* kv_len, void* dq, int B,
                                      int Sq, int Skv, int H, int KV, int D,
                                      const long long* strides, int causal,
                                      int dtype, int plan, void* stream) {
  return dispatch(q, k, v, dout, lse, delta, kv_len, dq, nullptr, nullptr, B,
                  Sq, Skv, H, KV, D, strides, causal, dtype, plan, stream);
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
                  Skv, H, KV, D, strides, causal, dtype, 0, stream);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
