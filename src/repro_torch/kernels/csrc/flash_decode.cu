// Split-KV flash-decoding for Hopper (sm_90a): the partials, and their
// merge in the same launch.
//
// Replaces src/repro/kernels/flash_decode.py::_decode_kernel (launched by
// flash_decode, pallas_call at flash_decode.py:168) and the plain merge
// that follows it there (flash_decode.py::combine): the key extent is cut
// into n_splits spans of `span` keys; each span reduces to a partial
// (o, lse) in fp32, the span-normalised softmax-weighted value sum and the
// log-sum-exp of the span's scores.  An empty span (entirely at or past
// kv_len) gives lse = -1e30 and a zero partial.  Queries (Sq <= 8 on the
// path) right-align causally against kv_len.  With an output, the last
// block of each row group to finish also merges that group's partials, as
// PyTorch's `combine` does, bit for bit.
//
// What bounds it on an H100: decode reads the whole live K / V extent once
// and does 4 * D FLOPs per key and query row, under one FLOP per byte, so
// the card's memory rate (3.35 TB/s on the SXM part) is the bound: 8.4 MB
// of K / V, 2.5 us, at qwen2-0.5b's batch 8 against 1024 keys.  At
// qwen2-0.5b (2 kv-heads) the split count (kernels/ops.py::decode_splits)
// gives spans of one 64-key tile, so a block's time is one tile's critical
// path: its load, a 64-long chain per score and per output column, and the
// row statistics between them; a merge launched apart would add its own
// launch and its own wait on device memory.
//
// What the design does about it:
//   * one block per (split, batch * kv-head, 16 rows) serves the G query
//     heads of the group, G * Sq rows (7 at qwen2-0.5b's decode), so each
//     K / V tile is read once, not G times as under the JAX index map;
//   * a block is shaped for decode's rows: one warp a row, so the rows'
//     statistics run side by side; a lane holds keys j and j + 32 of the
//     tile, so a row's max and sum run in registers with shuffles, and in
//     P V a lane owns D / 32 columns and reads V as one vector per key;
//   * a span's first K / V tile is put in flight by 16-byte cp.async
//     (gemm_common.cuh) before anything else, kv_len and q (vector loads)
//     included; K and V are two groups, so the scores run while V lands,
//     and a span of several tiles keeps the next tile in flight; two
//     barriers a tile;
//   * the merge needs no launch of its own: each block counts itself done
//     on a per-group counter after a fence, and the last one reads the
//     group's partials back (from L2) and merges them, one warp a row; it
//     then zeroes the counter for the next launch;
//   * the split count and span come from the shape alone, so a result has
//     the same bits run to run and whatever the batch;
//   * K and V are read in the engine layout (B, S, KV, D) through strides.
// The per-tile arithmetic is the forward kernel's (flash_attention.cu's
// header): a score one __fmaf_rn chain over d; the exact max; p =
// expf(s - m), 0 where s <= -5e29; the sum p[j] + p[j + 32] then the xor
// butterfly over 16, 8, 4, 2, 1; P V one chain over the tile's 64 keys;
// acc = acc * alpha + pv.  So at n_splits = 1 the partial o is bit for bit
// the forward kernel's output on the same problem, and choosing the decode
// formulation cannot change a token.

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
using gemm::load4;

constexpr int ROWS = 16;              // query rows of a block, a warp each
// Splits the merge takes: its sums match PyTorch's up to here (held on an
// H100); a warp reads two splits a lane, so 64 at most.  The same as
// flash_decode.py's MERGE_MAX_SPLITS.
constexpr int MERGE_MAX_SPLITS = 48;
constexpr int MERGE_STEP = 8;  // splits a warp of the merge loads at once
static_assert(MERGE_STEP % 4 == 0, "a step feeds the four accumulators in turn");

// Shared memory of a block: q rows (fp32, padded by 16 bytes), `stages`
// K / V tiles (x's dtype, rows padded by 16 bytes) and each warp's
// probabilities (64 keys).
template <typename T, int D>
struct DecSmem {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int QLD = D + 4;
  static constexpr int LD = D + VEC;
  static constexpr int TILE = BKV * LD;  // elements of a K or V tile
  static size_t bytes(int rows, int stages) {
    return static_cast<size_t>(rows) * QLD * 4 +
           static_cast<size_t>(stages) * 2 * TILE * sizeof(T) +
           static_cast<size_t>(rows) * BKV * 4;
  }
};

// The D / 32 columns lane `lane` owns in P V, as consecutive values
// (D 32: 1, 64: 2, 128: 4) read at once.
template <int D>
__device__ __forceinline__ void load_cols(const float* row, int lane,
                                          float (&v)[D / 32]) {
  constexpr int NC = D / 32;
  if constexpr (NC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + 4 * lane);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (NC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(row + 2 * lane);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = row[lane];
  }
}
template <int D>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* row, int lane,
                                          float (&v)[D / 32]) {
  constexpr int NC = D / 32;
  if constexpr (NC == 4) {
    const float4 x = load4(row + 4 * lane);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (NC == 2) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(row + 2 * lane));
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = __bfloat162float(row[lane]);
  }
}

__device__ __forceinline__ float dot4(float s, float4 a, float4 b) {
  s = __fmaf_rn(a.x, b.x, s);
  s = __fmaf_rn(a.y, b.y, s);
  s = __fmaf_rn(a.z, b.z, s);
  return __fmaf_rn(a.w, b.w, s);
}

// One row's merge by one warp, in the summation orders PyTorch's `sum`
// over the split axis takes on the card, so the result is `combine`'s:
// m = max lse; alpha_s = exp(lse_s - m); the denominator, when the split
// axis is innermost (Sq == 1), as a contiguous reduction: lane j sums
// splits j and j + 32 from 0, then the shuffle tree of offsets 16, 8, 4,
// 2, 1; otherwise, and for each column's numerator sum_s o_s alpha_s, as
// one thread's sum: four accumulators from 0, split s into accumulator
// s % 4 in order, then ((a0 + a1) + a2) + a3.  `l` and `o` point at split
// 0 of the row (split s at s * Sq and s * Sq * D); the partials are read
// past L1, as other blocks wrote them.
template <typename T, int D>
__device__ __forceinline__ void merge_row(const float* l, const float* o,
                                          T* dst, int NS, int Sq, int lane) {
  constexpr int NC = D / 32;
  const float none = __int_as_float(0xff800000);  // -inf: below every lse
  const float l0 = lane < NS ? __ldcg(l + static_cast<long long>(lane) * Sq)
                             : none;
  const float l1 = lane + 32 < NS
                       ? __ldcg(l + static_cast<long long>(lane + 32) * Sq)
                       : none;
  float m = fmaxf(l0, l1);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  const float a0 = lane < NS ? expf(__fsub_rn(l0, m)) : 0.f;
  const float a1 = lane + 32 < NS ? expf(__fsub_rn(l1, m)) : 0.f;
  float v = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(0.f, a0),
                                          __fadd_rn(0.f, a1)), 0.f), 0.f);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(FULL, v, off));
  float acc[NC][4], dacc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dacc[j] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c][j] = 0.f;
  }
  // MERGE_STEP splits a step, split s into accumulator s % 4: static
  // indices keep the accumulators in registers, and a step's loads are all
  // issued before its sums
  for (int s0 = 0; s0 < NS; s0 += MERGE_STEP) {
    float al[MERGE_STEP], ov[MERGE_STEP][NC];
#pragma unroll
    for (int j = 0; j < MERGE_STEP; ++j) {
      const int s = s0 + j;
      al[j] = __shfl_sync(FULL, s < 32 ? a0 : a1, s & 31);
      const float* os = o + static_cast<long long>(s) * Sq * D + lane;
#pragma unroll
      for (int c = 0; c < NC; ++c) ov[j][c] = s < NS ? __ldcg(os + 32 * c) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < MERGE_STEP; ++j) {
      if (s0 + j < NS) {
        dacc[j % 4] = __fadd_rn(dacc[j % 4], al[j]);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[c][j % 4] = __fadd_rn(acc[c][j % 4], __fmul_rn(ov[j][c], al[j]));
      }
    }
  }
  const float den =
      Sq == 1 ? __shfl_sync(FULL, v, 0)
              : __fadd_rn(__fadd_rn(__fadd_rn(dacc[0], dacc[1]), dacc[2]), dacc[3]);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float num =
        __fadd_rn(__fadd_rn(__fadd_rn(acc[c][0], acc[c][1]), acc[c][2]), acc[c][3]);
    attn::store(dst + lane + 32 * c, __fdiv_rn(num, den));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(ROWS * 32, 1)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ o_part, float* __restrict__ lse_part,
                    T* __restrict__ out, int* __restrict__ counters, int Sq,
                    int Skv, int H, int KV, int64_t qsb, int64_t qss,
                    int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                    int64_t vsb, int64_t vss, int64_t vsh, int causal,
                    int n_splits, int span, int stages, bool kvec) {
  using S = DecSmem<T, D>;
  constexpr int VEC = S::VEC;
  constexpr int NC = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  const int G = H / KV;
  const int split = blockIdx.x;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int r0 = blockIdx.z * ROWS;
  const int nrows = min(ROWS, G * Sq - r0);
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* qs = reinterpret_cast<float*>(smem);
  T* kv = reinterpret_cast<T*>(smem + static_cast<size_t>(nrows) * S::QLD * 4);
  float* ps = reinterpret_cast<float*>(
                  reinterpret_cast<unsigned char*>(kv) +
                  static_cast<size_t>(stages) * 2 * S::TILE * sizeof(T)) +
              warp * BKV;

  const int lo = split * span;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  // keys [t0, t0 + 64) of K or V into stage `st`; keys past Skv read 0
  auto stage = [&](const T* src, int64_t rs, int t0, int st, int which) {
    T* dst = kv + (st * 2 + which) * S::TILE;
    constexpr int PC = D / VEC;
    for (int i = tid; i < BKV * PC; i += nthreads) {
      const int c = i / PC, pc = i % PC;
      copy_piece(dst + c * S::LD + pc * VEC, src + (t0 + c) * rs + pc * VEC,
                 kvec, t0 + c < Skv ? VEC : 0);
    }
  };
  // the span's first tile goes in flight before kv_len is read
  stage(kb, kss, lo, 0, 0);
  cp_async_commit();
  stage(vb, vss, lo, 0, 1);
  cp_async_commit();
  const int kvlen = kv_len[b];
  // the block's largest key bound: its last row has the largest position
  const int last = (r0 + nrows - 1) / G;
  const int end = causal ? kvlen - Sq + last + 1 : kvlen;
  const int hi = min(min(lo + span, Skv), end);
  const int ntiles = hi > lo ? (hi - lo + BKV - 1) / BKV : 0;

  // q rows, position-major: row gr is query position gr / G of head
  // kvh * G + gr % G
  constexpr int Q4 = D / 4;
  for (int i = tid; i < nrows * Q4; i += nthreads) {
    const int r = i / Q4, d = (i % Q4) * 4;
    const int gr = r0 + r;
    const T* src = q + b * qsb + (gr / G) * qss + (kvh * G + gr % G) * qsh + d;
    float4 x;
    if constexpr (sizeof(T) == 4) {
      x = (reinterpret_cast<uintptr_t>(src) % 16 == 0)
              ? *reinterpret_cast<const float4*>(src)
              : make_float4(src[0], src[1], src[2], src[3]);
    } else {
      x = make_float4(attn::to_f32(src[0]), attn::to_f32(src[1]),
                      attn::to_f32(src[2]), attn::to_f32(src[3]));
    }
    *reinterpret_cast<float4*>(qs + r * S::QLD + d) = x;
  }

  // this warp's row, live while warp < nrows
  const bool live = warp < nrows;
  const int pos = (r0 + warp) / G;
  const int row_end = causal ? kvlen - Sq + pos + 1 : kvlen;
  float m = NEG, l = 0.f, acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int t0 = lo + t * BKV;
    const int st = stages > 1 ? t & 1 : 0;
    cp_async_wait<1>();  // K of tile t (V of tile t may still be landing)
    __syncthreads();
    const bool more = t + 1 < ntiles;
    if (more) {  // the next tile into the other stage, read last at t - 1
      stage(kb, kss, t0 + BKV, st ^ 1, 0);
      cp_async_commit();
      stage(vb, vss, t0 + BKV, st ^ 1, 1);
      cp_async_commit();
    }
    const T* ks = kv + (st * 2) * S::TILE;
    const T* vs = kv + (st * 2 + 1) * S::TILE;

    float al = 1.f;
    if (live) {
      // scores of keys lane and lane + 32
      float s0 = 0.f, s1 = 0.f;
      const float* qr = qs + warp * S::QLD;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + d);
        s0 = dot4(s0, qv, load4(ks + lane * S::LD + d));
        s1 = dot4(s1, qv, load4(ks + (lane + 32) * S::LD + d));
      }
      const float a0 = t0 + lane < row_end ? s0 : NEG;
      const float a1 = t0 + lane + 32 < row_end ? s1 : NEG;
      float mc = fmaxf(a0, a1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(FULL, mc, off));
      const float mn = fmaxf(m, mc);
      const float p0 = a0 > NEG_HALF ? expf(__fadd_rn(a0, -mn)) : 0.f;
      const float p1 = a1 > NEG_HALF ? expf(__fadd_rn(a1, -mn)) : 0.f;
      ps[lane] = p0;
      ps[lane + 32] = p1;
      float sum = __fadd_rn(p0, p1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, off));
      al = expf(__fadd_rn(m, -mn));
      l = __fadd_rn(__fmul_rn(l, al), sum);
      m = mn;
    }
    // V of tile t
    if (more)
      cp_async_wait<2>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (live) {
      // acc = acc * alpha + P V, one chain over the tile's keys per column
      float pv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) pv[j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < BKV; ++c) {
        float vv[NC];
        load_cols<D>(vs + c * S::LD, lane, vv);
        const float p = ps[c];
#pragma unroll
        for (int j = 0; j < NC; ++j) pv[j] = __fmaf_rn(p, vv[j], pv[j]);
      }
#pragma unroll
      for (int j = 0; j < NC; ++j)
        acc[j] = __fadd_rn(__fmul_rn(acc[j], al), pv[j]);
    }
  }
  cp_async_wait<0>();  // a span with no live key leaves its loads unread

  const int gr = r0 + warp;
  const int h = kvh * G + gr % G;
  // (B, H, n_splits, Sq) row index of the partials at split 0
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * n_splits * Sq + pos;
  if (live) {
    const float lsafe = l == 0.f ? 1.f : l;
    const int64_t row = row0 + static_cast<int64_t>(split) * Sq;
    float* o = o_part + row * D + NC * lane;
#pragma unroll
    for (int j = 0; j < NC; ++j) o[j] = __fdiv_rn(acc[j], lsafe);
    if (lane == 0) lse_part[row] = l > 0.f ? __fadd_rn(m, logf(lsafe)) : NEG;
  }
  if (out == nullptr) return;

  // the last block of this row group to finish merges the group's rows
  __threadfence();
  __syncthreads();
  int* count = counters + blockIdx.y * gridDim.z + blockIdx.z;
  if (tid == 0) last_block = atomicAdd(count, 1) == n_splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  if (live)
    merge_row<T, D>(lse_part + row0, o_part + row0 * D,
                    out + ((static_cast<int64_t>(b) * Sq + pos) * H + h) * D,
                    n_splits, Sq, lane);
  if (tid == 0) *count = 0;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, float* o_part, float* lse_part,
                   void* out, int* counters, int B, int Sq, int Skv, int H,
                   int KV, const long long* st, int causal, int n_splits,
                   int span, cudaStream_t stream) {
  static bool smem_set = false;
  auto kernel = flash_decode_kernel<T, D>;
  using S = DecSmem<T, D>;
  const int rows = (H / KV) * Sq;
  const int brows = rows < ROWS ? rows : ROWS;
  const int stages = span > BKV ? 2 : 1;
  cudaError_t err = allow_smem(kernel, S::bytes(ROWS, 2), smem_set);
  if (err != cudaSuccess) return err;
  constexpr long long VEC = S::VEC;
  const bool kvec = (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(v) % 16 == 0) &&
                    st[3] % VEC == 0 && st[4] % VEC == 0 && st[5] % VEC == 0 &&
                    st[6] % VEC == 0 && st[7] % VEC == 0 && st[8] % VEC == 0;
  const dim3 grid(n_splits, B * KV, (rows + ROWS - 1) / ROWS);
  kernel<<<grid, brows * 32, S::bytes(brows, stages), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, o_part, lse_part, static_cast<T*>(out),
      counters, Sq, Skv, H, KV, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], causal, n_splits, span, stages, kvec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* kv_len, float* o_part, float* lse_part,
                       void* out, int* counters, int B, int Sq, int Skv, int H,
                       int KV, const long long* st, int causal, int n_splits,
                       int span, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, kv_len, o_part, lse_part, out, counters, B, Sq,
                           Skv, H, KV, st, causal, n_splits, span, stream);
    case 64:
      return launch<T, 64>(q, k, v, kv_len, o_part, lse_part, out, counters, B, Sq,
                           Skv, H, KV, st, causal, n_splits, span, stream);
    case 128:
      return launch<T, 128>(q, k, v, kv_len, o_part, lse_part, out, counters, B, Sq,
                            Skv, H, KV, st, causal, n_splits, span, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k / v (B, Skv, KV, D) in the engine layout with element
// strides (batch, position, head) in `strides` (q, k, v in turn),
// contiguous along D; kv_len a (B,) int32 device array clamped to Skv;
// o_part (B, H, n_splits, Sq, D) and lse_part (B, H, n_splits, Sq) fp32,
// contiguous.  `span` is a multiple of 64 keys and n_splits * span >= Skv.
// With `out` (B, Sq, H, D) contiguous in q's dtype, the partials are also
// merged there; then n_splits <= MERGE_MAX_SPLITS and `counters` holds
// B * KV * ceil(G * Sq / 16) zeroed ints, which the launch leaves zeroed.
extern "C" int flash_decode_partials(const void* q, const void* k, const void* v,
                                     const void* kv_len, void* o_part,
                                     void* lse_part, void* out, void* counters,
                                     int B, int Sq, int Skv, int H, int KV, int D,
                                     const long long* strides, int causal,
                                     int n_splits, int span, int dtype,
                                     void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* kvl = static_cast<const int*>(kv_len);
  auto* op = static_cast<float*>(o_part);
  auto* lp = static_cast<float*>(lse_part);
  auto* cnt = static_cast<int*>(counters);
  if (span % BKV != 0) return cudaErrorInvalidValue;
  if (out != nullptr && (cnt == nullptr || n_splits > MERGE_MAX_SPLITS))
    return cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return dispatch_d<float>(D, q, k, v, kvl, op, lp, out, cnt, B, Sq, Skv, H, KV,
                             strides, causal, n_splits, span, s);
  if (dtype == DT_BF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, kvl, op, lp, out, cnt, B, Sq, Skv,
                                     H, KV, strides, causal, n_splits, span, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
