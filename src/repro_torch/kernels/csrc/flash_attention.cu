// Grouped flash-attention forward for Hopper (sm_90a):
// o = softmax(q k^T) v per query head, with q already scaled by sm_scale.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (launched by
// _forward, pallas_call at flash_attention.py:354): grouped KV (head h reads
// kv-head h // G), causal queries right-aligned against the live key extent
// (kv_len - Sq, or Skv - Sq without kv_len), keys at or past a per-batch
// kv_len masked, dead key tiles skipped, fully-masked rows exact 0.
//
// What bounds it on an H100: on the LM's prefill and training paths
// (qwen2-0.5b: 14 query heads over 2 kv-heads, head dim 64, fp32 under
// fp32_strict) the kernel does 4 D FLOPs per live (query, key) pair and
// head and moves only q, k, v and o once, so it sits far above the memory
// roof: the card's fp32 FFMA rate (about 67 TFLOP/s on the SXM part) is the
// bound.  No tensor cores, as under fp32_strict there is no TF32.  Next to
// it, shared memory: an SM issues 128 FFMAs a clock but reads 32 floats a
// clock, so what counts is the FFMAs a thread does per float it reads.
//
// What the design does about it:
//   * the TPU grid's sequential KV axis becomes a loop inside the block; a
//     block owns one (batch, kv-head) pair and ROWS of its G * Sq query rows
//     (position-major), so the G query heads that share a kv-head read each
//     K / V tile once from device memory;
//   * each query row belongs to LPR lanes of one warp (8, 16 or 32), lane
//     j holding the row's scores of keys j, j + LPR, ... of a 64-key tile:
//     a lane keeps RT rows by 64 / LPR keys of scores and RT rows by
//     NC = D / LPR columns of the accumulator (runs of 4 columns, 4 LPR
//     apart, then a tail of NC % 4 consecutive ones: at head dim 80 and 8
//     lanes, 4 + 4 + 2, at 112, 4 + 4 + 4 + 2, at 192 and 32 lanes, 4 +
//     2, at 576 and 32 lanes, 4 + 4 + 4 + 4 + 2; a plan whose lanes do not
//     divide D is refused, and so is one whose fp32 block does not fit in
//     shared memory: at 192, MLA's prefill head dim, and at 576, its
//     latent, only the 8-row plan of 32 lanes a row fits),
//     reads operands as 16-byte vectors from
//     rows padded by 16 bytes, and the row's max, sum and rescaling run in
//     registers with shuffles among the row's lanes, so a tile needs no
//     shared-memory round trip for its statistics and one barrier;
//   * the probabilities reach the P V product by shuffles from the lane
//     that holds them, so P never goes to shared memory;
//   * K / V tiles are staged by 16-byte cp.async (gemm_common.cuh) a tile
//     ahead, q rows once, bf16 copied raw and widened as it is read, an
//     unaligned row element by element;
//   * at head dim 576 (MLA's absorbed attention over its latent: G = 16
//     query heads over one kv-head of c_kv 512 + k_rope 64, where a decode
//     is too shallow or a chunk too long for the split-KV kernel) one fp32
//     stage of a K and a V tile is 315 KB, past the 227 KB a block may
//     use, so K and V stream through two 32-key half tiles (FwdSmem::HALVES,
//     flash_decode.cu's layout; 167 KB in fp32): one half lands while the
//     block scores or multiplies the other, lane j scores key j from K's
//     first half and key j + 32 from its second, and P V runs its chains
//     over V's first half and on over the second, so the 64-key tile's
//     arithmetic, and its bits, are those of the whole-tile loop; four
//     barriers a tile;
//   * the plan, rows and threads a block and lanes a row, is picked from
//     the shape in Python (flash_attention.py::plan_for): few rows a block,
//     and many lanes a row, where the grid would leave SMs idle (a 64-token
//     prefill chunk at batch 1 is 896 query rows per launch), more rows,
//     and more of them a lane, where it fills the card;
//   * under causal masking a block's work grows with its positions, so the
//     grid lists the heaviest blocks first;
//   * q, k and v are read in the engine layout (B, S, heads, D) through
//     strides, so the caller neither transposes nor pads; ragged edges are
//     masked in the kernel (keys past Skv read as 0 and are masked);
//   * the training launch (a non-null lse) also writes each row's fp32
//     softmax residual lse = m + log l to a (B, H, Sq) tensor, 0 for a row
//     with no live key (as _finish), for the backward kernels of
//     flash_attention_bwd.cu; o is computed the same way with or without it.
//
// The invariant every plan keeps, so that each row has the bits of the
// earlier one-warp-per-row kernel and of the decode kernel at one split
// (flash_decode.cu keeps the same per-tile arithmetic):
//   * a score is one __fmaf_rn chain over d = 0 .. D-1 from 0, masked to
//     -1e30 by row_end; the tile max is exact;
//   * p = expf(s - m_new), zeroed where s <= -5e29;
//   * the tile's sum is p[j] + p[j + 32] for j < 32, then the xor butterfly
//     over j by 16, 8, 4, 2, 1 (__fadd_rn): here the steps of LPR keys and
//     more are adds inside a lane and the smaller ones shuffles, the same
//     tree;
//   * l = l alpha + sum; P V is one chain over the tile's 64 keys in order
//     from 0, then acc = acc alpha + pv;
//   * o = __fdiv_rn(acc, l) (0 for a dead row), lse = m + logf(l);
//   * 64-key tiles run in order; tiles dead for every row of the block are
//     skipped, which leaves a row as an update would (p = 0, alpha = 1), so
//     a row's bits do not depend on the plan, the other rows of its block
//     or the batch.
// wgmma and TMA are later work.

#include "attention_common.cuh"
#include "gemm_common.cuh"

namespace {

using attn::allow_smem;
using attn::BKV;
using attn::DT_BF16;
using attn::DT_F32;
using attn::FULL;
using attn::NEG;
using attn::NEG_HALF;
using gemm::copy_piece;
using gemm::cp_async_commit;
using gemm::cp_async_wait;
using gemm::lane4;
using gemm::load4;

// One plan: THREADS threads, each query row held by the LPR lanes of one
// group of a warp, each lane RT rows (ROWS = RT * THREADS / LPR).
template <int ROWS_, int THREADS_, int LPR_>
struct Plan {
  static constexpr int ROWS = ROWS_, THREADS = THREADS_, LPR = LPR_;
  static constexpr int RPW = 32 / LPR;                // rows of a warp at once
  static constexpr int RT = ROWS * LPR / THREADS;     // rows of a lane
  static constexpr int KPL = 64 / LPR;                // keys of a lane
  static_assert(RT * THREADS == ROWS * LPR && RT >= 1, "rows split over lanes");
  static_assert(LPR == 8 || LPR == 16 || LPR == 32, "a row's lanes");
};

// The instantiated plans, by id (kernels/flash_attention.py::PLANS in the
// same order): query rows a block, threads a block, lanes a row.
using P0 = Plan<64, 256, 8>;
using P1 = Plan<128, 256, 8>;
using P2 = Plan<8, 256, 32>;
constexpr int N_PLANS = 3;

struct Strides {  // element strides (batch, position, head) of one operand
  int64_t b, s, h;
};

// Row stride, in elements, of a staged operand: D padded by 16 bytes.
template <typename T, int D>
__host__ __device__ constexpr int ld() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// Whether every row of an operand may be copied in 16-byte pieces.
template <typename T>
__device__ __forceinline__ bool rows_vec(const T* p, Strides st) {
  constexpr int VEC = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % VEC == 0 &&
         st.s % VEC == 0 && st.h % VEC == 0;
}

// Shared memory one block may use on an H100.
constexpr size_t MAX_SMEM = 232448;

// Shared memory of a block, in elements of T: the q rows and two stages of
// the k and v tile, or, where one fp32 stage of a k and a v tile does not
// fit (HALVES: head dim 576, (8 + 128) x 580 x 4 = 315,520 bytes), two
// 32-key half tiles that k and v stream through (flash_decode.cu's
// DecSmem rule, one rule for both dtypes).  flash_attention.py's
// fwd_smem_bytes states the same sizes.
template <typename T, int D, typename P>
struct FwdSmem {
  static constexpr int LD = ld<T, D>();
  static constexpr int TILE = BKV * LD;
  static constexpr int HK = BKV / 2;  // keys of a half tile
  static constexpr int HALF_TILE = HK * LD;
  static constexpr bool HALVES =
      static_cast<size_t>(P::ROWS + 2 * BKV) * ld<float, D>() * 4 > MAX_SMEM;
  static constexpr int Q = 0;
  static constexpr int K = Q + P::ROWS * LD;
  static constexpr int V = K + 2 * TILE;  // the whole-tile layout's
  static constexpr size_t bytes =
      static_cast<size_t>(HALVES ? K + TILE : V + 2 * TILE) * sizeof(T);
};

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

// Column e of the NC a lane j holds of a D-wide row (D = NC * LPR): NC / 4
// runs of 4 columns, 4 LPR apart, then a tail of NC % 4 consecutive
// columns past the runs' 4 LPR (NC / 4) (NC <= 2: NC consecutive columns;
// head dim 80 at 8 lanes: two runs over columns 0-63, a tail of 2 over
// 64-79; 112: three runs over 0-95, a tail of 2 over 96-111).  The mapping
// moves no bit: each column is one chain over the keys whichever lane
// holds it.  The tail is stored element by element, so its 2-column pieces
// need no alignment beyond the element's (bf16 included).
template <int NC, int LPR>
__host__ __device__ constexpr int col(int j, int e) {
  constexpr int RUNS = NC / 4, TAIL = NC % 4;
  return e < 4 * RUNS ? (e / 4) * 4 * LPR + 4 * j + e % 4
                      : 4 * RUNS * LPR + TAIL * j + (e - 4 * RUNS);
}

// out[e] = row[col<NC, LPR>(j, e)] as fp32: the runs as 16-byte (fp32) or
// 8-byte (bf16) vectors, the tail element by element.
template <int NC, int LPR, typename T>
__device__ __forceinline__ void load_cols(const T* row, int j, float (&out)[NC]) {
#pragma unroll
  for (int c = 0; c < NC / 4; ++c) {
    const float4 v = load4(row + 4 * LPR * c + 4 * j);
    out[4 * c] = v.x;
    out[4 * c + 1] = v.y;
    out[4 * c + 2] = v.z;
    out[4 * c + 3] = v.w;
  }
#pragma unroll
  for (int e = NC / 4 * 4; e < NC; ++e)
    out[e] = attn::to_f32(row[col<NC, LPR>(j, e)]);
}

// Scores of a lane's keys j + LPR n, N0 <= n < N1, with key row r staged
// at kt + (r - koff) LD: s[i][n] = q . k, one chain over d in order.
template <typename P, int D, int N0, int N1, typename T>
__device__ __forceinline__ void score_keys(float (&s)[P::RT][P::KPL],
                                           const T* qrow, const T* kt,
                                           int koff, int j) {
  constexpr int LD = ld<T, D>();
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qf[P::RT];
#pragma unroll
    for (int i = 0; i < P::RT; ++i) qf[i] = load4(qrow + P::RPW * i * LD + d);
#pragma unroll
    for (int n = N0; n < N1; ++n) {  // one k vector live at a time
      const float4 kf = load4(kt + (j + P::LPR * n - koff) * LD + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < P::RT; ++i)
          s[i][n] = __fmaf_rn(lane4(qf[i], e), lane4(kf, e), s[i][n]);
    }
  }
}

// The row statistics of the 64-key tile at t0 in the row's lanes: keys at
// or past a row's bound masked, the exact max, p replacing s, the sum's
// tree, then m, l and the rescaling alpha of each row.
template <typename P>
__device__ __forceinline__ void tile_stats(float (&s)[P::RT][P::KPL],
                                           float (&m)[P::RT], float (&l)[P::RT],
                                           float (&alpha)[P::RT],
                                           const int (&row_end)[P::RT], int t0,
                                           int j) {
  constexpr int LPR = P::LPR, KPL = P::KPL;
#pragma unroll
  for (int i = 0; i < P::RT; ++i) {
    float mc = NEG;
#pragma unroll
    for (int n = 0; n < KPL; ++n) {
      if (t0 + j + LPR * n >= row_end[i]) s[i][n] = NEG;
      mc = fmaxf(mc, s[i][n]);
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      mc = fmaxf(mc, __shfl_xor_sync(FULL, mc, off));
    const float mn = fmaxf(m[i], mc);
    float a[KPL / 2];
#pragma unroll
    for (int n = 0; n < KPL; ++n)
      s[i][n] = s[i][n] > NEG_HALF ? expf(__fadd_rn(s[i][n], -mn)) : 0.f;
    // keys j + LPR n: n and n + KPL / 2 are 32 apart, then each halving
    // 16, 8, ... down to LPR apart, then lanes LPR / 2, ..., 1 apart
#pragma unroll
    for (int n = 0; n < KPL / 2; ++n) a[n] = __fadd_rn(s[i][n], s[i][n + KPL / 2]);
#pragma unroll
    for (int half = KPL / 4; half > 0; half >>= 1)
#pragma unroll
      for (int n = 0; n < half; ++n) a[n] = __fadd_rn(a[n], a[n + half]);
    float sum = a[0];
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, off));
    alpha[i] = expf(__fadd_rn(m[i], -mn));
    l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), sum);
    m[i] = mn;
  }
}

// pv += P V over the keys LPR n + jj (jj < LPR), N0 <= n < N1, in order,
// with key row r staged at vt + (r - koff) LD; each key's p comes by
// shuffle from the lane that holds it (lane base | jj of the row's group).
template <typename P, int D, int N0, int N1, typename T>
__device__ __forceinline__ void pv_keys(const float (&s)[P::RT][P::KPL],
                                        float (&pv)[P::RT][D / P::LPR],
                                        const T* vt, int koff, int j,
                                        int base) {
  constexpr int LD = ld<T, D>(), LPR = P::LPR, NC = D / LPR;
#pragma unroll
  for (int n = N0; n < N1; ++n) {
#pragma unroll
    for (int jj = 0; jj < LPR; ++jj) {
      float pc[P::RT], vv[NC];
#pragma unroll
      for (int i = 0; i < P::RT; ++i) pc[i] = __shfl_sync(FULL, s[i][n], base | jj);
      load_cols<NC, LPR>(vt + (LPR * n + jj - koff) * LD, j, vv);
#pragma unroll
      for (int e = 0; e < NC; ++e)
#pragma unroll
        for (int i = 0; i < P::RT; ++i)
          pv[i][e] = __fmaf_rn(pc[i], vv[e], pv[i][e]);
    }
  }
}

// ROWS position-major query rows of one (batch, kv-head): row gr is position
// gr / G of head kvh * G + gr % G.  Block x is row block nrb - 1 - x / nbh
// (the highest positions, which see the most keys, first) of (batch,
// kv-head) x % nbh.  Lane j of row group rw of warp wp holds rows
// wp * RT * RPW + RPW i + rw (i < RT), keys j + LPR m (m < KPL) of a tile
// and the accumulator columns col<D / LPR, LPR>(j, e).
// The launch bound names one block an SM: ptxas then gives the 128-row
// plan 168 registers at D 64 in fp32, not 198, and it ran 2 % faster (a
// bound of two blocks spills).
template <typename T, int D, typename P>
__global__ void __launch_bounds__(P::THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_len,
                 T* __restrict__ o, float* __restrict__ lse, int nbh, int Sq,
                 int Skv, int H, int KV, Strides qst, Strides kst,
                 Strides vst, int causal) {
  using S = FwdSmem<T, D, P>;
  constexpr int LD = S::LD, RT = P::RT, THREADS = P::THREADS;
  constexpr int LPR = P::LPR, RPW = P::RPW, KPL = P::KPL;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PIECES = D / VEC;  // 16-byte pieces of a row
  constexpr int NC = D / LPR;      // accumulator columns of a lane
  static_assert(NC >= 1 && NC * LPR == D && D % VEC == 0, "columns of a lane");
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem) + S::Q;
  T* ks = reinterpret_cast<T*>(smem) + S::K;
  T* vs = reinterpret_cast<T*>(smem) + S::V;

  const int G = H / KV;
  const int bh = blockIdx.x % nbh;
  const int nrb = gridDim.x / nbh;
  const int b = bh / KV, kvh = bh % KV;
  const int r0 = (nrb - 1 - static_cast<int>(blockIdx.x) / nbh) * P::ROWS;
  const int nrows = min(P::ROWS, G * Sq - r0);
  const int kvlen = kv_len ? kv_len[b] : Skv;
  const int last = (r0 + nrows - 1) / G;
  const int hi = min(causal ? kvlen - Sq + last + 1 : kvlen, Skv);
  const int ntiles = hi > 0 ? (hi + BKV - 1) / BKV : 0;

  const int tid = threadIdx.x;
  const T* kb = k + b * kst.b + kvh * kst.h;
  const T* vb = v + b * vst.b + kvh * vst.h;
  const bool kvec = rows_vec(k, kst), vvec = rows_vec(v, vst);
  auto stage_tile = [&](int t) {
    const int t0 = t * BKV;
    T* kd = ks + (t & 1) * S::TILE;
    T* vd = vs + (t & 1) * S::TILE;
    for (int i = tid; i < BKV * PIECES; i += THREADS) {
      const int c = i / PIECES, e = i % PIECES * VEC;
      const bool in = t0 + c < Skv;
      copy_piece(kd + c * LD + e, in ? kb + (t0 + c) * kst.s + e : k, kvec,
                 in ? VEC : 0);
      copy_piece(vd + c * LD + e, in ? vb + (t0 + c) * vst.s + e : v, vvec,
                 in ? VEC : 0);
    }
  };
  // HALVES: piece h of the key extent is tile h / 4's k keys 0-31, k keys
  // 32-63, v keys 0-31 or v keys 32-63 (h % 4), into half buffer h % 2
  auto stage_half = [&](int h) {
    const bool isk = (h & 3) < 2;
    const T* src = isk ? kb : vb;
    const int64_t rs = isk ? kst.s : vst.s;
    const bool vec = isk ? kvec : vvec;
    const int t0 = (h >> 2) * BKV + (h & 1) * S::HK;
    T* dst = ks + (h & 1) * S::HALF_TILE;
    for (int i = tid; i < S::HK * PIECES; i += THREADS) {
      const int c = i / PIECES, e = i % PIECES * VEC;
      const bool in = t0 + c < Skv;
      copy_piece(dst + c * LD + e, in ? src + (t0 + c) * rs + e : src, vec,
                 in ? VEC : 0);
    }
  };
  if (ntiles > 0) {
    const T* qb = q + b * qst.b + kvh * G * qst.h;
    const bool qvec = rows_vec(q, qst);
    for (int i = tid; i < P::ROWS * PIECES; i += THREADS) {
      const int r = i / PIECES, e = i % PIECES * VEC;
      const int gr = r0 + r;
      const bool in = r < nrows;
      copy_piece(qs + r * LD + e,
                 in ? qb + (gr / G) * qst.s + (gr % G) * qst.h + e : q, qvec,
                 in ? VEC : 0);
    }
    if constexpr (S::HALVES)
      stage_half(0);
    else
      stage_tile(0);
  }
  cp_async_commit();

  const int warp = tid / 32, lane = tid % 32;
  const int rw = lane / LPR, j = lane % LPR, base = lane & ~(LPR - 1);
  const int row0 = warp * RT * RPW + rw;  // the lane's row i is row0 + RPW i
  int row_end[RT];
  float m[RT], l[RT], acc[RT][NC];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = row0 + RPW * i;
    row_end[i] = r < nrows ? (causal ? kvlen - Sq + (r0 + r) / G + 1 : kvlen) : 0;
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NC; ++e) acc[i][e] = 0.f;
  }
  const T* qrow = qs + row0 * LD;

  for (int t = 0; t < ntiles; ++t) {
    float s[RT][KPL], alpha[RT], pv[RT][NC];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int n = 0; n < KPL; ++n) s[i][n] = 0.f;
#pragma unroll
      for (int e = 0; e < NC; ++e) pv[i][e] = 0.f;
    }
    if constexpr (S::HALVES) {
      // one half tile in flight while the block works on the other, one
      // barrier a half: the scores of keys j + LPR n from k's half 0 (n <
      // KPL / 2) and half 1, the tile's statistics, then P V's chains over
      // v's half 0 and on over half 1, so the arithmetic of the whole-tile
      // loop below, key for key
      auto next = [&](int h) {  // half h landed; half h + 1 in flight
        cp_async_wait<0>();
        __syncthreads();  // and half h - 1's reads are done
        if (h + 1 < 4 * ntiles) stage_half(h + 1);
        cp_async_commit();
        return ks + (h & 1) * S::HALF_TILE;
      };
      score_keys<P, D, 0, KPL / 2>(s, qrow, next(4 * t), 0, j);
      score_keys<P, D, KPL / 2, KPL>(s, qrow, next(4 * t + 1), S::HK, j);
      tile_stats<P>(s, m, l, alpha, row_end, t * BKV, j);
      pv_keys<P, D, 0, KPL / 2>(s, pv, next(4 * t + 2), 0, j, base);
      pv_keys<P, D, KPL / 2, KPL>(s, pv, next(4 * t + 3), S::HK, j, base);
    } else {
      cp_async_wait<0>();
      __syncthreads();  // tile t landed; tile t-1's reads are done
      if (t + 1 < ntiles) stage_tile(t + 1);
      cp_async_commit();
      // scores s = q . k, the row statistics (p replaces s), then
      // acc = acc * alpha + P V, one chain over the tile's keys in order
      score_keys<P, D, 0, KPL>(s, qrow, ks + (t & 1) * S::TILE, 0, j);
      tile_stats<P>(s, m, l, alpha, row_end, t * BKV, j);
      pv_keys<P, D, 0, KPL>(s, pv, vs + (t & 1) * S::TILE, 0, j, base);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int e = 0; e < NC; ++e)
        acc[i][e] = __fadd_rn(__fmul_rn(acc[i][e], alpha[i]), pv[i][e]);
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = row0 + RPW * i;
    if (r >= nrows) continue;
    const int gr = r0 + r;
    const int h = kvh * G + gr % G;
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((static_cast<int64_t>(b) * Sq + gr / G) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC / 4; ++c) {
      const float w[4] = {__fdiv_rn(acc[i][4 * c], lsafe),
                          __fdiv_rn(acc[i][4 * c + 1], lsafe),
                          __fdiv_rn(acc[i][4 * c + 2], lsafe),
                          __fdiv_rn(acc[i][4 * c + 3], lsafe)};
      store4(orow + col<NC, LPR>(j, 4 * c), w);
    }
#pragma unroll
    for (int e = NC / 4 * 4; e < NC; ++e)
      attn::store(orow + col<NC, LPR>(j, e), __fdiv_rn(acc[i][e], lsafe));
    if (lse != nullptr && j == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + gr / G] =
          l[i] > 0.f ? __fadd_rn(m[i], logf(l[i])) : 0.f;
  }
}

struct Args {
  const void *q, *k, *v;
  const int* kv_len;
  void* o;
  float* lse;
  int B, Sq, Skv, H, KV;
  Strides st[3];  // q, k, v
  int causal;
  cudaStream_t stream;
};

template <typename T, int D, typename P>
cudaError_t launch(const Args& a) {
  static bool smem_set = false;
  auto kernel = flash_fwd_kernel<T, D, P>;
  const size_t bytes = FwdSmem<T, D, P>::bytes;
  cudaError_t err = allow_smem(kernel, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const long long nrb =
      (static_cast<long long>(a.H / a.KV) * a.Sq + P::ROWS - 1) / P::ROWS;
  const long long blocks = nrb * a.B * a.KV;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), P::THREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.kv_len, static_cast<T*>(a.o), a.lse,
      a.B * a.KV, a.Sq, a.Skv, a.H, a.KV, a.st[0], a.st[1], a.st[2],
      a.causal);
  return cudaGetLastError();
}

// A plan is instantiated at D where its lanes split D evenly and its fp32
// blocks fit in shared memory (one rule for both dtypes): not the 32-lane
// plan at head dims 80 and 112, only the 32-lane plan at 192 (the 64- and
// 128-row plans there need 250,880 and 301,056 bytes in fp32) and at 576
// (167,040 bytes in half tiles; the 64- and 128-row plans' half-tile
// blocks need 296,960 and 445,440).
// flash_attention.py::plans_at states the same rule and refuses the
// others first.
template <int D, typename P>
constexpr bool admitted() {
  return D % P::LPR == 0 && FwdSmem<float, D, P>::bytes <= MAX_SMEM;
}

template <typename T, int D, typename P>
cudaError_t launch_if_admitted(const Args& a) {
  if constexpr (admitted<D, P>()) {
    return launch<T, D, P>(a);
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t run_plan(int plan, const Args& a) {
  switch (plan) {
    case 0: return launch_if_admitted<T, D, P0>(a);
    case 1: return launch_if_admitted<T, D, P1>(a);
    case 2: return launch_if_admitted<T, D, P2>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run_d(int D, int plan, const Args& a) {
  switch (D) {
    case 32:
      return run_plan<T, 32>(plan, a);
    case 64:
      return run_plan<T, 64>(plan, a);
    case 80:
      return run_plan<T, 80>(plan, a);
    case 112:
      return run_plan<T, 112>(plan, a);
    case 128:
      return run_plan<T, 128>(plan, a);
    case 192:
      return run_plan<T, 192>(plan, a);
    case 576:
      return run_plan<T, 576>(plan, a);
    default:
      return cudaErrorInvalidValue;
  }
}

int dispatch(const void* q, const void* k, const void* v, const void* kv_len,
             void* o, float* lse, int B, int Sq, int Skv, int H, int KV,
             int D, const long long* st, int causal, int dtype, int plan,
             void* stream) {
  if (plan < 0 || plan >= N_PLANS) return cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || Skv < 0) return cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const int*>(kv_len), o, lse, B, Sq, Skv, H, KV,
         {}, causal, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < 3; ++i)
    a.st[i] = {static_cast<int64_t>(st[3 * i]), static_cast<int64_t>(st[3 * i + 1]),
               static_cast<int64_t>(st[3 * i + 2])};
  if (dtype == DT_F32) return run_d<float>(D, plan, a);
  if (dtype == DT_BF16) return run_d<__nv_bfloat16>(D, plan, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, H, D), k / v (B, Skv, KV, D) in the engine layout, each with
// element strides (batch, position, head) in `strides` (q, k, v in turn) and
// contiguous along D; kv_len a (B,) int32 device array clamped to Skv, or
// null; o (B, Sq, H, D) contiguous, written in the operands' dtype; `plan`
// an id of the instantiated plans.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_len, void* o, int B, int Sq,
                                   int Skv, int H, int KV, int D,
                                   const long long* strides, int causal,
                                   int dtype, int plan, void* stream) {
  return dispatch(q, k, v, kv_len, o, nullptr, B, Sq, Skv, H, KV, D, strides,
                  causal, dtype, plan, stream);
}

// The training forward: as flash_attention_fwd, and also lse (B, H, Sq)
// fp32 contiguous, each row's m + log l (0 for a row with no live key).
extern "C" int flash_attention_fwd_lse(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       void* o, void* lse, int B, int Sq,
                                       int Skv, int H, int KV, int D,
                                       const long long* strides, int causal,
                                       int dtype, int plan, void* stream) {
  return dispatch(q, k, v, kv_len, o, static_cast<float*>(lse), B, Sq, Skv, H,
                  KV, D, strides, causal, dtype, plan, stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
