// Grouped flash-attention forward for Hopper (sm_90a):
// o = softmax(q k^T) v per query head, with q already scaled by sm_scale.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (launched by
// _forward, pallas_call at flash_attention.py:354): grouped KV (head h reads
// kv-head h // G), causal queries right-aligned against the live key extent
// (kv_len - Sq, or Skv - Sq without kv_len), keys at or past a per-batch
// kv_len masked, dead key tiles skipped, fully-masked rows exact 0.
//
// What bounds it on an H100: on the LM's prefill path (qwen2-0.5b: 14 query
// heads over 2 kv-heads, head dim 64, fp32 under fp32_strict) the kernel
// does about Sq/2 * Skv * 4 * D FLOPs per head for causal prefill and moves
// only q, k, v and o once, so it sits far above the memory roof: the card's
// fp32 FFMA rate (about 67 TFLOP/s on the SXM part) is the bound.  No tensor
// cores, as under fp32_strict there is no TF32.
//
// What the design does about it, kept simple and exact first:
//   * the TPU grid's sequential KV axis becomes a loop inside the block; a
//     block owns one (batch, kv-head) pair and 64 of its G * Sq query rows
//     (position-major), so the G query heads that share a kv-head read each
//     K / V tile once from device memory;
//   * short queries would leave the card idle (a 64-token prefill chunk at
//     batch 1 is 14 such blocks on 132 SMs, each walking every live key
//     tile in turn), so a launch whose 64-row grid covers less than half
//     the SMs takes 16-row blocks instead, four times as many
//     (attention_common.cuh::pick_rt); the bits are the same either way;
//   * q, k and v are read in the engine layout (B, S, heads, D) through
//     strides, so the caller neither transposes nor pads; ragged edges are
//     masked in the kernel (keys past Skv read as 0 and are masked);
//   * scores, probabilities and the accumulator stay in shared memory and
//     registers; each thread's 4 x 4 score micro-tile and 4 x D/16
//     accumulator micro-tile get two FFMAs per shared load;
//   * the tile update is attention_common.cuh::tile_step, shared with the
//     decode kernel, so the two give the same bits at one split;
//   * the training launch (the LSE template flag, as gemm.cu's RES flag)
//     also writes each row's fp32 softmax residual lse = m + log l to a
//     (B, H, Sq) tensor, 0 for a row with no live key (as _finish), for the
//     backward kernels of flash_attention_bwd.cu.  o is computed the same
//     way with or without it, so the serving launch keeps its bits.
// wgmma, TMA and double buffering are later work.

#include "attention_common.cuh"

namespace {

using namespace attn;

template <typename T, int D, int RT, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_len,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Skv,
                 int H, int KV,
                 int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
                 int64_t kss, int64_t ksh, int64_t vsb, int64_t vss,
                 int64_t vsh, int causal) {
  using S = Smem<D, RT>;
  extern __shared__ float sm[];
  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int r0 = blockIdx.x * S::ROWS;
  const int nrows = min(S::ROWS, G * Sq - r0);
  const int kvlen = kv_len ? kv_len[b] : Skv;
  const int end = load_rows<T, D, RT>(sm, q, qsb, qss, qsh, b, kvh, G, Sq,
                                      r0, nrows, kvlen, causal);
  float acc[RT][D / 16];
  walk<T, D, RT>(sm, k + b * ksb + kvh * ksh, v + b * vsb + kvh * vsh, kss,
                 vss, Skv, 0, min(end, Skv), nrows, acc);

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = tr + 16 * i;
    if (r >= nrows) continue;
    const int gr = r0 + r;
    const int h = kvh * G + gr % G;
    const float l = sm[S::L + r];
    const float lsafe = l == 0.f ? 1.f : l;
    T* orow = o + ((static_cast<int64_t>(b) * Sq + gr / G) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      store(orow + tc + 16 * j, __fdiv_rn(acc[i][j], lsafe));
    if constexpr (LSE) {
      if (tc == 0)
        lse[(static_cast<int64_t>(b) * H + h) * Sq + gr / G] =
            l > 0.f ? __fadd_rn(sm[S::M + r], logf(l)) : 0.f;
    }
  }
}

template <typename T, int D, int RT, bool LSE>
cudaError_t launch_rt(const void* q, const void* k, const void* v,
                      const int* kv_len, void* o, float* lse, int B, int Sq,
                      int Skv, int H, int KV, const long long* st, int causal,
                      cudaStream_t stream) {
  static bool smem_set = false;
  auto kernel = flash_fwd_kernel<T, D, RT, LSE>;
  const size_t bytes = Smem<D, RT>::bytes;
  cudaError_t err = allow_smem(kernel, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const int rows = (H / KV) * Sq;
  const dim3 grid((rows + Smem<D, RT>::ROWS - 1) / Smem<D, RT>::ROWS, B * KV);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(o), lse, Sq, Skv, H,
      KV,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal);
  return cudaGetLastError();
}

template <typename T, int D, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, void* o, float* lse, int B, int Sq,
                   int Skv, int H, int KV, const long long* st, int causal,
                   cudaStream_t stream) {
  const long long blocks64 = ((H / KV) * static_cast<long long>(Sq) + 63) / 64 * B * KV;
  if (pick_rt(blocks64) == 4)
    return launch_rt<T, D, 4, LSE>(q, k, v, kv_len, o, lse, B, Sq, Skv, H, KV,
                                   st, causal, stream);
  return launch_rt<T, D, 1, LSE>(q, k, v, kv_len, o, lse, B, Sq, Skv, H, KV,
                                 st, causal, stream);
}

template <typename T, bool LSE>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* kv_len, void* o, float* lse, int B, int Sq,
                       int Skv, int H, int KV, const long long* st,
                       int causal, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32, LSE>(q, k, v, kv_len, o, lse, B, Sq, Skv, H, KV,
                                st, causal, stream);
    case 64:
      return launch<T, 64, LSE>(q, k, v, kv_len, o, lse, B, Sq, Skv, H, KV,
                                st, causal, stream);
    case 128:
      return launch<T, 128, LSE>(q, k, v, kv_len, o, lse, B, Sq, Skv, H, KV,
                                 st, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool LSE>
int dispatch(const void* q, const void* k, const void* v, const void* kv_len,
             void* o, float* lse, int B, int Sq, int Skv, int H, int KV,
             int D, const long long* strides, int causal, int dtype,
             void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* kvl = static_cast<const int*>(kv_len);
  if (dtype == DT_F32)
    return dispatch_d<float, LSE>(D, q, k, v, kvl, o, lse, B, Sq, Skv, H, KV,
                                  strides, causal, s);
  if (dtype == DT_BF16)
    return dispatch_d<__nv_bfloat16, LSE>(D, q, k, v, kvl, o, lse, B, Sq, Skv,
                                          H, KV, strides, causal, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, H, D), k / v (B, Skv, KV, D) in the engine layout, each with
// element strides (batch, position, head) in `strides` (q, k, v in turn) and
// contiguous along D; kv_len a (B,) int32 device array clamped to Skv, or
// null; o (B, Sq, H, D) contiguous, written in the operands' dtype.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_len, void* o, int B, int Sq,
                                   int Skv, int H, int KV, int D,
                                   const long long* strides, int causal,
                                   int dtype, void* stream) {
  return dispatch<false>(q, k, v, kv_len, o, nullptr, B, Sq, Skv, H, KV, D,
                         strides, causal, dtype, stream);
}

// The training forward: as flash_attention_fwd, and also lse (B, H, Sq)
// fp32 contiguous, each row's m + log l (0 for a row with no live key).
extern "C" int flash_attention_fwd_lse(const void* q, const void* k,
                                       const void* v, const void* kv_len,
                                       void* o, void* lse, int B, int Sq,
                                       int Skv, int H, int KV, int D,
                                       const long long* strides, int causal,
                                       int dtype, void* stream) {
  return dispatch<true>(q, k, v, kv_len, o, static_cast<float*>(lse), B, Sq,
                        Skv, H, KV, D, strides, causal, dtype, stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
