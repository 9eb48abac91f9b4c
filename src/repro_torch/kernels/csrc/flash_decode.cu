// Split-KV flash-decoding partials for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_decode.py::_decode_kernel (launched by
// flash_decode, pallas_call at flash_decode.py:168): the key extent is cut
// into n_splits spans of `span` keys; each span reduces to a partial
// (o, lse) in fp32, the span-normalised softmax-weighted value sum and the
// log-sum-exp of the span's scores.  An empty span (entirely at or past
// kv_len) gives lse = -1e30 and a zero partial.  Queries (Sq <= 8 on the
// path) right-align causally against kv_len.  The partials merge outside
// the kernel (flash_decode.py::combine, plain PyTorch, as in JAX).
//
// What bounds it on an H100: decode reads the whole live K / V extent once
// and does 4 * D FLOPs per key and query row, under one FLOP per byte, so
// the card's memory rate (3.35 TB/s on the SXM part) is the bound.  At
// qwen2-0.5b (2 kv-heads) and batch 1 the (batch, head) grid alone gives too
// few blocks to keep the memory system busy; splitting the key extent is
// what fills the card.
//
// What the design does about it:
//   * one block per (split, batch * kv-head) serves all G query heads of the
//     group (G * Sq rows; a third grid axis takes rows past a block's 64,
//     or 16 when the 64-row grid covers less than half the SMs: pick_rt),
//     so each K / V tile is read once, not G times as under the JAX index
//     map (which walks one query head per program);
//   * the split count and span come from the shape alone
//     (kernels/ops.py::decode_splits), so a result has the same bits run to
//     run and whatever the batch;
//   * the tile update is attention_common.cuh::tile_step, shared with the
//     forward kernel: at n_splits = 1 the partial o is bit for bit the
//     forward kernel's output on the same problem, so choosing the decode
//     formulation cannot change a token;
//   * K and V are read in the engine layout (B, S, KV, D) through strides.
// Double-buffered tile loads and a fused merge are later work.

#include "attention_common.cuh"

namespace {

using namespace attn;

template <typename T, int D, int RT>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ o_part, float* __restrict__ lse_part,
                    int Sq, int Skv, int H, int KV, int64_t qsb, int64_t qss,
                    int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                    int64_t vsb, int64_t vss, int64_t vsh, int causal,
                    int n_splits, int span) {
  using S = Smem<D, RT>;
  extern __shared__ float sm[];
  const int G = H / KV;
  const int split = blockIdx.x;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int r0 = blockIdx.z * S::ROWS;
  const int nrows = min(S::ROWS, G * Sq - r0);
  const int kvlen = kv_len[b];
  const int end = load_rows<T, D, RT>(sm, q, qsb, qss, qsh, b, kvh, G, Sq,
                                      r0, nrows, kvlen, causal);
  const int lo = split * span;
  const int hi = min(min(lo + span, Skv), end);
  float acc[RT][D / 16];
  walk<T, D, RT>(sm, k + b * ksb + kvh * ksh, v + b * vsb + kvh * vsh, kss,
                 vss, Skv, lo, hi, nrows, acc);

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = tr + 16 * i;
    if (r >= nrows) continue;
    const int gr = r0 + r;
    const int h = kvh * G + gr % G;
    const int pos = gr / G;
    const float l = sm[S::L + r];
    const float lsafe = l == 0.f ? 1.f : l;
    // (B, H, n_splits, Sq) row index of the partials
    const int64_t row =
        ((static_cast<int64_t>(b) * H + h) * n_splits + split) * Sq + pos;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      o_part[row * D + tc + 16 * j] = __fdiv_rn(acc[i][j], lsafe);
    if (tc == 0)
      lse_part[row] = l > 0.f ? __fadd_rn(sm[S::M + r], logf(lsafe)) : NEG;
  }
}

template <typename T, int D, int RT>
cudaError_t launch_rt(const void* q, const void* k, const void* v,
                      const int* kv_len, float* o_part, float* lse_part,
                      int B, int Sq, int Skv, int H, int KV,
                      const long long* st, int causal, int n_splits, int span,
                      cudaStream_t stream) {
  static bool smem_set = false;
  auto kernel = flash_decode_kernel<T, D, RT>;
  const size_t bytes = Smem<D, RT>::bytes;
  cudaError_t err = allow_smem(kernel, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const int rows = (H / KV) * Sq;
  constexpr int ROWS = Smem<D, RT>::ROWS;
  const dim3 grid(n_splits, B * KV, (rows + ROWS - 1) / ROWS);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, o_part, lse_part, Sq, Skv, H, KV,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      n_splits, span);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, float* o_part, float* lse_part, int B,
                   int Sq, int Skv, int H, int KV, const long long* st,
                   int causal, int n_splits, int span, cudaStream_t stream) {
  const long long blocks64 =
      static_cast<long long>(n_splits) * B * KV * (((H / KV) * Sq + 63) / 64);
  if (pick_rt(blocks64) == 4)
    return launch_rt<T, D, 4>(q, k, v, kv_len, o_part, lse_part, B, Sq, Skv, H, KV,
                              st, causal, n_splits, span, stream);
  return launch_rt<T, D, 1>(q, k, v, kv_len, o_part, lse_part, B, Sq, Skv, H, KV,
                            st, causal, n_splits, span, stream);
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* kv_len, float* o_part, float* lse_part,
                       int B, int Sq, int Skv, int H, int KV,
                       const long long* st, int causal, int n_splits,
                       int span, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, kv_len, o_part, lse_part, B, Sq, Skv, H, KV, st,
                           causal, n_splits, span, stream);
    case 64:
      return launch<T, 64>(q, k, v, kv_len, o_part, lse_part, B, Sq, Skv, H, KV, st,
                           causal, n_splits, span, stream);
    case 128:
      return launch<T, 128>(q, k, v, kv_len, o_part, lse_part, B, Sq, Skv, H, KV, st,
                            causal, n_splits, span, stream);
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
extern "C" int flash_decode_partials(const void* q, const void* k, const void* v,
                                     const void* kv_len, void* o_part,
                                     void* lse_part, int B, int Sq, int Skv,
                                     int H, int KV, int D,
                                     const long long* strides, int causal,
                                     int n_splits, int span, int dtype,
                                     void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* kvl = static_cast<const int*>(kv_len);
  auto* op = static_cast<float*>(o_part);
  auto* lp = static_cast<float*>(lse_part);
  if (span % BKV != 0) return cudaErrorInvalidValue;
  if (dtype == DT_F32)
    return dispatch_d<float>(D, q, k, v, kvl, op, lp, B, Sq, Skv, H, KV, strides,
                             causal, n_splits, span, s);
  if (dtype == DT_BF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, kvl, op, lp, B, Sq, Skv, H, KV,
                                     strides, causal, n_splits, span, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
