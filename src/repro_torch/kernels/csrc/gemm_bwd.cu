// The fused GEMM's backward GEMMs for Hopper (sm_90a):
//
//   gemm_bwd_dx   dX[m,k] = sum_n dY[m,n] W[k,n]   dY (M, N), W (K, N) -> (M, K)
//   gemm_bwd_dw   dW[k,n] = sum_m X[m,k] dY[m,n]   X (M, K), dY (M, N) -> (K, N)
//
// Replaces src/repro/kernels/gemm.py::gemm_bwd_dx and ::gemm_bwd_dw, which
// share _bwd_matmul_kernel and differ only in its contraction `dims`.  Here
// one templated kernel computes C[i,j] = sum_p A(i,p) B(p,j) with a
// transpose flag per operand: dX reads dY as stored and W transposed, dW
// reads X transposed and dY as stored.  No operand is copied to transpose it.
// A tied LM head's w = E^T needs no kernel of its own: dX = dY . E reads
// both operands as stored, and dE = dY^T . X is gemm_bwd_dw with its two
// operands swapped (kernels/gemm.py::GemmFused).
//
// What bounds it on an H100: as the forward (gemm.cu), every backward GEMM
// of the Darknet path does tens of FLOPs per byte it must move, so under
// fp32_strict (true fp32 products, no tensor cores, no TF32) the card's
// fp32 FFMA rate is the roof.
//
// What the design does about it, kept simple and exact first:
//   * the forward's tiling: a BM x BN output tile per block, the contraction
//     looped inside the block in BK-deep shared-memory stages, a 4 x 4
//     register micro-tile per thread fed by float4 shared loads;
//   * bounds-checked, zero-filled tile loads and a masked store, so every
//     shape runs unpadded;
//   * split contraction.  dW has a small output and a huge contraction (at
//     batch 8 the first layer's dW is 27 x 32 over 401,408 rows: one output
//     tile), which would leave all but one SM idle.  gridDim.z splits the
//     contraction into `chunk`-long pieces; each block writes its fp32
//     partial into a workspace slice, and gemm_bwd_reduce adds the slices
//     in a fixed order.  No atomics: the wrapper picks the split from the
//     shape alone, so the result is the same, bit for bit, run to run.
// Accumulation is always fp32; operands are fp32 or bf16 (widened to fp32
// in shared memory), outputs fp32 or bf16.  wgmma, TMA and 3xTF32 are later
// work.
//
// The batched backward GEMMs of the bmm op,
//
//   bmm_bwd_dx   dX[b] = dY[b] . W[b]^T   dY (B, M, N), W (B, K, N) -> (B, M, K)
//   bmm_bwd_dw   dW[b] = X[b]^T . dY[b]   X (B, M, K), dY (B, M, N) -> (B, K, N)
//
// replace src/repro/kernels/gemm.py::bmm_bwd_dx and ::bmm_bwd_dw (the same
// _bwd_matmul_kernel over a (B, ...) grid).  They are the 2-D kernel with
// the batch sharing gridDim.z with the contraction split: z = b * splits + s
// (at most 65,535).  Each block offsets its operands by b times R*P and P*C
// elements (int64) and writes its partial to slice (s, b) of a workspace laid
// out (splits, B, R, C), so gemm_bwd_reduce adds the `splits` partials of
// every one of the B*R*C outputs with no batch stride of its own.  Batch
// slice b therefore runs the 2-D launch's arithmetic on that slice, bit for
// bit, at the same (tile, chunk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;   // contraction depth of one shared-memory stage
constexpr int TM = 4;    // accumulator rows per thread
constexpr int TN = 4;    // accumulator columns per thread
constexpr int PAD = 4;   // keeps transposing tile stores off one bank

enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// For batch slice bb = blockIdx.z / splits and split s = blockIdx.z % splits:
// C[s][bb] (R, C) = sum over p in split s's chunk of A[bb](i, p) B[bb](p, j).
// A[bb] is (R, P) row-major, or (P, R) when TA; B[bb] is (P, C) row-major, or
// (C, P) when TB; C is (splits, batch, R, C).  The 2-D launches have
// batch = 1.
template <typename Tin, typename Tout, int BM, int BN, bool TA, bool TB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_bwd_kernel(const Tin* __restrict__ a, const Tin* __restrict__ b,
                Tout* __restrict__ c, int R, int P, int C, int chunk,
                int batch) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int TCOLS = BN / TN;
  static_assert((BM * BK) % THREADS == 0, "A tile must split evenly");
  static_assert((BK * BN) % THREADS == 0, "B tile must split evenly");

  __shared__ __align__(16) float as[BK][BM + PAD];  // A tile, p-major
  __shared__ __align__(16) float bs[BK][BN + PAD];  // B tile, p-major

  const int tid = threadIdx.x;
  const int tcol = tid % TCOLS;
  const int trow = tid / TCOLS;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;
  const int splits = gridDim.z / batch;
  const int64_t bb = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  a += bb * R * P;
  b += bb * P * C;
  const int64_t p_begin = static_cast<int64_t>(split) * chunk;
  const int64_t p_end = p_begin + chunk < P ? p_begin + chunk : P;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int64_t p0 = p_begin; p0 < p_end; p0 += BK) {
#pragma unroll
    for (int it = 0; it < BM * BK / THREADS; ++it) {
      const int e = tid + it * THREADS;
      // Neighbouring threads read neighbouring addresses in either layout.
      const int r = TA ? e % BM : e / BK;
      const int k = TA ? e / BM : e % BK;
      const int64_t gr = row0 + r;
      const int64_t gp = p0 + k;
      float v = 0.f;
      if (gr < R && gp < p_end)
        v = to_f32(TA ? a[gp * R + gr] : a[gr * P + gp]);
      as[k][r] = v;
    }
#pragma unroll
    for (int it = 0; it < BK * BN / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int k = TB ? e % BK : e / BN;
      const int cc = TB ? e / BK : e % BN;
      const int gc = col0 + cc;
      const int64_t gp = p0 + k;
      float v = 0.f;
      if (gc < C && gp < p_end)
        v = to_f32(TB ? b[static_cast<int64_t>(gc) * P + gp]
                      : b[gp * C + gc]);
      bs[k][cc] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av4 = *reinterpret_cast<const float4*>(&as[kk][trow * TM]);
      const float4 bv4 = *reinterpret_cast<const float4*>(&bs[kk][tcol * TN]);
      const float av[TM] = {av4.x, av4.y, av4.z, av4.w};
      const float bv[TN] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  Tout* out = c + (static_cast<int64_t>(split) * batch + bb) * R * C;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = row0 + trow * TM + i;
    if (gr >= R) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tcol * TN + j;
      if (gc < C) store(out + gr * C + gc, acc[i][j]);
    }
  }
}

// out[e] = sum_{s = 0..S-1} ws[s * count + e], in that order, in fp32.
template <typename Tout>
__global__ void __launch_bounds__(256)
reduce_splits_kernel(const float* __restrict__ ws, Tout* __restrict__ out,
                     int64_t count, int splits) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += ws[s * count + e];
  store(out + e, sum);
}

template <typename Tin, typename Tout, bool TA, bool TB, int T>
cudaError_t launch_tile(const void* a, const void* b, void* c, int R, int P,
                        int C, int chunk, int batch, cudaStream_t stream) {
  const unsigned grid_r = static_cast<unsigned>((static_cast<int64_t>(R) + T - 1) / T);
  const unsigned grid_c = static_cast<unsigned>((C + T - 1) / T);
  const int64_t splits = P > 0 ? (static_cast<int64_t>(P) + chunk - 1) / chunk : 1;
  if (grid_c > 65535u || splits * batch > 65535) return cudaErrorInvalidValue;
  gemm_bwd_kernel<Tin, Tout, T, T, TA, TB>
      <<<dim3(grid_r, grid_c, static_cast<unsigned>(splits * batch)),
         (T / TM) * (T / TN), 0, stream>>>(
          static_cast<const Tin*>(a), static_cast<const Tin*>(b),
          static_cast<Tout*>(c), R, P, C, chunk, batch);
  return cudaGetLastError();
}

template <bool TA, bool TB>
int dispatch(const void* a, const void* b, void* c, int R, int P, int C,
             int in_dtype, int out_dtype, int tile, int chunk, int batch,
             void* stream) {
  if (R <= 0 || C <= 0 || batch == 0) return 0;
  if (P < 0 || chunk <= 0 || chunk % BK != 0 || batch < 0)
    return cudaErrorInvalidValue;
  if (tile != 32 && tile != 64) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GEMM_BWD_LAUNCH(TIN, TOUT)                                           \
  return tile == 64                                                          \
             ? launch_tile<TIN, TOUT, TA, TB, 64>(a, b, c, R, P, C, chunk,    \
                                                  batch, s)                   \
             : launch_tile<TIN, TOUT, TA, TB, 32>(a, b, c, R, P, C, chunk,    \
                                                  batch, s)
  if (in_dtype == DT_F32 && out_dtype == DT_F32) GEMM_BWD_LAUNCH(float, float);
  if (in_dtype == DT_F32 && out_dtype == DT_BF16) GEMM_BWD_LAUNCH(float, __nv_bfloat16);
  if (in_dtype == DT_BF16 && out_dtype == DT_F32) GEMM_BWD_LAUNCH(__nv_bfloat16, float);
  if (in_dtype == DT_BF16 && out_dtype == DT_BF16)
    GEMM_BWD_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef GEMM_BWD_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dY (M, N) and W (K, N) row-major in `in_dtype`, or, when `trans_w` is
// not 0, W stored (N, K) row-major (a tied LM head's embedding table: then
// dX = dY . E is a product of two row-major operands, with the same fmaf
// chain over n).  With chunk >= N, `out` is dX (M, K) in `out_dtype`; with
// a smaller chunk, `out` is an fp32 workspace (ceil(N / chunk), M, K) of
// partials for gemm_bwd_reduce, and `out_dtype` must be fp32.  `chunk` is
// a multiple of 16; `tile` is the square output tile (64 or 32).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int gemm_bwd_dx(const void* dy, const void* w, void* out, int M,
                           int N, int K, int in_dtype, int out_dtype,
                           int tile, int chunk, int trans_w, void* stream) {
  if (trans_w)
    return dispatch<false, false>(dy, w, out, M, N, K, in_dtype, out_dtype,
                                  tile, chunk, 1, stream);
  return dispatch<false, true>(dy, w, out, M, N, K, in_dtype, out_dtype,
                               tile, chunk, 1, stream);
}

// X (M, K) and dY (M, N) row-major in `in_dtype`.  `out` is dW (K, N) in
// `out_dtype` with chunk >= M, else the fp32 workspace
// (ceil(M / chunk), K, N); the rest as gemm_bwd_dx.
extern "C" int gemm_bwd_dw(const void* x, const void* dy, void* out, int M,
                           int K, int N, int in_dtype, int out_dtype,
                           int tile, int chunk, void* stream) {
  return dispatch<true, false>(x, dy, out, K, M, N, in_dtype, out_dtype,
                               tile, chunk, 1, stream);
}

// dY (B, M, N) and W (B, K, N) row-major in `in_dtype`; B * splits <= 65535
// with splits = ceil(N / chunk).  With chunk >= N, `out` is dX (B, M, K) in
// `out_dtype`; else the fp32 workspace (splits, B, M, K) for gemm_bwd_reduce
// over B * M * K outputs.  The rest as gemm_bwd_dx.
extern "C" int bmm_bwd_dx(const void* dy, const void* w, void* out, int B,
                          int M, int N, int K, int in_dtype, int out_dtype,
                          int tile, int chunk, void* stream) {
  return dispatch<false, true>(dy, w, out, M, N, K, in_dtype, out_dtype, tile,
                               chunk, B, stream);
}

// X (B, M, K) and dY (B, M, N) row-major in `in_dtype`.  `out` is dW
// (B, K, N) in `out_dtype` with chunk >= M, else the fp32 workspace
// (ceil(M / chunk), B, K, N); the rest as bmm_bwd_dx.
extern "C" int bmm_bwd_dw(const void* x, const void* dy, void* out, int B,
                          int M, int K, int N, int in_dtype, int out_dtype,
                          int tile, int chunk, void* stream) {
  return dispatch<true, false>(x, dy, out, K, M, N, in_dtype, out_dtype, tile,
                               chunk, B, stream);
}

// out (count,) in `out_dtype` = the sum of the `splits` fp32 slices of
// `ws` (splits, count), added in slice order.
extern "C" int gemm_bwd_reduce(const void* ws, void* out, long long count,
                               int splits, int out_dtype, void* stream) {
  if (count <= 0) return 0;
  if (splits <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((count + 255) / 256);
  if (out_dtype == DT_F32)
    reduce_splits_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(ws), static_cast<float*>(out), count, splits);
  else if (out_dtype == DT_BF16)
    reduce_splits_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out), count,
        splits);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" const char* gemm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
