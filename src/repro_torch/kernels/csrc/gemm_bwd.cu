// The fused GEMM's backward GEMMs for Hopper (sm_90a):
//
//   gemm_bwd_dx   dX[m,k] = sum_n dY[m,n] W[k,n]   dY (M, N), W (K, N) -> (M, K)
//   gemm_bwd_dw   dW[k,n] = sum_m X[m,k] dY[m,n]   X (M, K), dY (M, N) -> (K, N)
//   bmm_bwd_dx    dX[b] = dY[b] . W[b]^T           (B, M, N), (B, K, N) -> (B, M, K)
//   bmm_bwd_dw    dW[b] = X[b]^T . dY[b]           (B, M, K), (B, M, N) -> (B, K, N)
//
// They replace src/repro/kernels/gemm.py's gemm_bwd_dx (the pallas_call at
// :251), gemm_bwd_dw (:283), bmm_bwd_dx (:309) and bmm_bwd_dw (:336), all
// of them _bwd_matmul_kernel with other contraction `dims`.  A batched
// entry is its 2-D kernel with the batch in the grid.  A tied LM head's
// w = E^T needs no kernel of its own: dX = dY . E reads both operands as
// stored, and dE = dY^T . X is gemm_bwd_dw with its two operands swapped
// (kernels/gemm.py::GemmFused).
//
// What bounds them on an H100: like the forward, every backward GEMM of
// the paths does tens to hundreds of FLOPs per byte it must move, so
// under fp32_strict (true fp32 products: no tensor cores, no TF32) the
// card's fp32 FFMA rate, 67 TFLOP/s on the SXM part, is the roof.
//
// What the design does about it: the forward's regime B design (gemm.cu,
// with the pieces both share in gemm_common.cuh).  A block computes a
// Tile of the output, 128 x 128 with 8 x 8 accumulators a thread (256
// threads), 64 x 32 with 4 x 4 (128 threads) or 32 x 32 with 4 x 4 (64
// threads, for the outputs the split leaves tiny): the plans of
// kernels/gemm.py::BWD_PLANS, picked by bwd_plan_for.  The contraction runs
// over a ring of 3 stages of 32 filled by 16-byte cp.async.cg two stages
// ahead; a ragged or unaligned piece (K = 27, N = 1000, an odd bf16 row)
// is copied element by element with zero fill, the store is masked,
// batch offsets are int64.  At most 128 registers a thread, so two
// 256-thread blocks share an SM.  Each thread feeds its FFMAs from 16-byte
// shared loads:
//   * dX reads dY along the contraction, as the forward reads x, and
//     stages it and w as the forward does (stage_xw): a row-major W (K, N)
//     is the forward's transposed w (its rows run along the contraction),
//     a tied head's E (N, K) the forward's row-major w.  Against a
//     transposed w a thread loads 4 contraction steps of each of its rows
//     and columns at once, then runs each step as TM x TN independent
//     FMAs.
//   * dW contracts over the forward's rows, and at each row p both X[p]
//     and dY[p] are contiguous along the output's rows and columns: both
//     are staged p-major as they lie, by 16-byte copies with no transpose,
//     and each p is one outer product of 4-wide vectors.
// No atomics: a small output over a long contraction (DARKNET19 layer 0's
// dW is 27 x 32 over 401,408 rows at batch 8) splits the contraction into
// `chunk`-long pieces on gridDim.z, shared with the batch as z = b *
// splits + s.  Piece s writes its fp32 partial to slice (s, b) of a
// workspace (splits, B, R, C), and gemm_bwd_reduce adds the slices in
// slice order.  wgmma, TMA, TF32 and 3xTF32 change the bits or the
// precision contract and are not used.
//
// The invariant: every output of piece s is one thread's fmaf chain over
// its contraction range [s * chunk, min((s + 1) * chunk, P)) in order,
// starting from +0.f, operands widened to fp32 (__bfloat162float); the
// zero terms that pad a stage past the range are fmaf(0, 0, acc) == acc
// (acc is never -0).  The split and the chunk (a multiple of 16) come from
// the shape alone (kernels/ops.py::default_bwd_tiles, gemm.py::split_chunk)
// and not from the plan, so every plan gives every output the same bits;
// a batch slice equals the 2-D launch; a pieceless dX equals
// gemm_fused_fwd(dY, W^T).

#include "gemm_common.cuh"

namespace {

using namespace gemm;

// The plans, in the order of kernels/gemm.py::BWD_PLANS.
enum BwdPlanId { BWD_B128 = 0, BWD_B64 = 1, BWD_S32 = 2 };

using TileB128 = Tile<128, 128, 256, 8, 32, 3>;
using TileB64 = Tile<64, 32, 128, 4, 32, 3>;
using TileS32 = Tile<32, 32, 64, 4, 32, 3>;

constexpr int CHUNK_ALIGN = 16;  // a split chunk is a multiple of this

struct Args {
  const void* a;  // dX: dY (B, R, P); dW: X (B, P, R)
  const void* b;  // dX: W (B, C, P), or (B, P, C) when !TW; dW: dY (B, P, C)
  void* out;      // (splits, B, R, C)
  bool out_bf16;
  int R, P, C, chunk, batch;
};

// Output (gr, gc) of piece `split` of batch slice zb.
__device__ __forceinline__ void put(const Args& a, int64_t zb, int split,
                                   int64_t gr, int gc, float v) {
  const int64_t at =
      ((static_cast<int64_t>(split) * a.batch + zb) * a.R + gr) * a.C + gc;
  if (a.out_bf16)
    store(static_cast<__nv_bfloat16*>(a.out) + at, v);
  else
    store(static_cast<float*>(a.out) + at, v);
}

// Stage the contraction slice [k0, k0 + BK) into `xs` (then w at
// xs + rows * XS): `rows` rows of x (row stride K), of which the first
// `live` lie in x and the rest are zero, and columns col0.. of w (K, N)
// row-major, or (N, K) row-major when TW.  Terms at k >= k_end are zero in
// both operands.
template <typename Tin, typename T, bool TW>
__device__ __forceinline__ void stage_xw(Tin* xs, const Tin* x, const Tin* w,
                                         int rows, int live, int K, int N,
                                         int col0, int k0, int k_end,
                                         bool x_vec, bool w_vec, int tid) {
  using L = Smem<Tin, T, TW>;
  constexpr int VEC = L::VEC, XS = L::XS, BK = T::BK, BN = T::BN;
  constexpr int KP = BK / VEC;  // 16-byte pieces along k per row
  Tin* ws = xs + rows * XS;
  for (int i = tid; i < rows * KP; i += T::THREADS) {
    const int r = i / KP, gk = k0 + (i % KP) * VEC;
    copy_piece(xs + r * XS + (i % KP) * VEC,
               x + static_cast<int64_t>(r) * K + gk, x_vec,
               r < live ? k_end - gk : 0);
  }
  if constexpr (TW) {
    for (int i = tid; i < BN * KP; i += T::THREADS) {
      const int c = i / KP, gc = col0 + c, gk = k0 + (i % KP) * VEC;
      copy_piece(ws + c * XS + (i % KP) * VEC,
                 w + static_cast<int64_t>(gc) * K + gk, w_vec,
                 gc < N ? k_end - gk : 0);
    }
  } else {
    constexpr int NP = BN / VEC;  // pieces per k row
    for (int i = tid; i < BK * NP; i += T::THREADS) {
      const int r = i / NP, gk = k0 + r, gc = col0 + (i % NP) * VEC;
      copy_piece(ws + r * BN + (i % NP) * VEC,
                 w + static_cast<int64_t>(gk) * N + gc, w_vec,
                 gk < k_end ? N - gc : 0);
    }
  }
}

// dX: out[i, j] = sum_p A[i, p] B(p, j), A = dY row-major (R, P), B = W
// stored (C, P) when TW, else (P, C).  A block stages all BM rows of A
// (zero past R), so a thread's rows, rg + i * RG, sit at fixed offsets;
// its columns are col_of<T, TW>.
template <typename Tin, typename T, bool TW>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
dx_kernel(const Args args) {
  using L = Smem<Tin, T, TW>;
  constexpr int VEC = L::VEC, XS = L::XS, S = T::STAGES, BK = T::BK;
  constexpr int BM = T::BM, BN = T::BN, TM = T::TM, TN = T::TN, RG = T::RG;
  constexpr int STAGE = L::stage_elems(BM);
  static_assert(TN % 4 == 0, "4-wide micro-tiles only");
  extern __shared__ __align__(16) unsigned char dx_smem[];
  Tin* const smem = reinterpret_cast<Tin*>(dx_smem);
  const int R = args.R, P = args.P, C = args.C;

  const int tid = threadIdx.x;
  const int cg = tid % T::CG, rg = tid / T::CG;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t left = R - row0;
  const int rows = left < BM ? static_cast<int>(left) : BM;
  const int col0 = blockIdx.y * BN;
  const int splits = gridDim.z / args.batch;
  const int64_t zb = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const Tin* a = static_cast<const Tin*>(args.a) + zb * R * P + row0 * P;
  const Tin* b = static_cast<const Tin*>(args.b) + zb * P * C;
  const int p_begin = split * args.chunk;
  const int p_end = P - p_begin < args.chunk ? P : p_begin + args.chunk;
  const bool a_vec =
      P % VEC == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool b_vec = (TW ? P % VEC == 0 : C % VEC == 0) &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int nk = (p_end - p_begin + BK - 1) / BK;
  auto load_stage = [&](int kt) {
    stage_xw<Tin, T, TW>(smem + (kt % S) * STAGE, a, b, BM, rows, P, C,
                         col0, p_begin + kt * BK, p_end, a_vec, b_vec, tid);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();  // this thread's pieces of stage kt are in
    __syncthreads();         // everyone's are; slot (kt - 1) % S is free
    if (kt + S - 1 < nk) load_stage(kt + S - 1);
    cp_async_commit();
    const Tin* as = smem + (kt % S) * STAGE + rg * XS;  // this thread's rows
    const Tin* bs = smem + (kt % S) * STAGE + BM * XS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 av[TM];  // 4 steps of each of this thread's rows
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = load4(as + i * RG * XS + kk);
      if constexpr (TW) {
        // A column's 4 steps are one 16-byte load of its k-major row; each
        // step is then TM x TN independent FMAs.
        float4 bv[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bv[j] = load4(bs + col_of<T, TW>(cg, j) * XS + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int i = 0; i < TM; ++i)
              acc[i][j] = fmaf(lane4(av[i], q), lane4(bv[j], q), acc[i][j]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float bv[TN];
#pragma unroll
          for (int j = 0; j < TN; j += 4) {
            const float4 v = load4(bs + (kk + q) * BN + col_of<T, TW>(cg, j));
            bv[j] = v.x;
            bv[j + 1] = v.y;
            bv[j + 2] = v.z;
            bv[j + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(lane4(av[i], q), bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = rg + i * RG;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + col_of<T, TW>(cg, j);
      if (gc < C) put(args, zb, split, row0 + r, gc, acc[i][j]);
    }
  }
}

// Index j (0..T-1) of a thread in slot g of `slots` along a BM- or
// BN-wide tile: groups of 4 consecutive indices, read as 16-byte vectors,
// the groups slots * 4 apart.
__device__ __forceinline__ int quad_of(int g, int j, int slots) {
  return g * 4 + (j & 3) + (j >> 2) * (slots * 4);
}

// A dW stage: BK rows p of A (p, row0 .. row0 + BM) and of B (p, col0 ..
// col0 + BN), each as it lies.
template <typename Tin, typename T>
struct SmemW {
  static constexpr int STAGE = T::BK * (T::BM + T::BN);
  static size_t bytes() {
    return static_cast<size_t>(T::STAGES) * STAGE * sizeof(Tin);
  }
};

// dW: out[i, j] = sum_p A[p, i] B[p, j], A (P, R) and B (P, C) row-major.
template <typename Tin, typename T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
dw_kernel(const Args args) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(Tin));
  constexpr int S = T::STAGES, BK = T::BK, BM = T::BM, BN = T::BN;
  constexpr int TM = T::TM, TN = T::TN, RG = T::RG, CG = T::CG;
  constexpr int AP = BM / VEC, BP = BN / VEC;  // 16-byte pieces per row
  static_assert(TM % 4 == 0 && TN % 4 == 0, "4-wide micro-tiles only");
  extern __shared__ __align__(16) unsigned char dw_smem[];
  Tin* const smem = reinterpret_cast<Tin*>(dw_smem);
  const int R = args.R, P = args.P, C = args.C;

  const int tid = threadIdx.x;
  const int cg = tid % CG, rg = tid / CG;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int splits = gridDim.z / args.batch;
  const int64_t zb = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const Tin* a = static_cast<const Tin*>(args.a) + zb * P * R;
  const Tin* b = static_cast<const Tin*>(args.b) + zb * P * C;
  const int p_begin = split * args.chunk;
  const int p_end = P - p_begin < args.chunk ? P : p_begin + args.chunk;
  const bool a_vec =
      R % VEC == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool b_vec =
      C % VEC == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int nk = (p_end - p_begin + BK - 1) / BK;

  // Stage kt into ring slot kt % S; rows p >= p_end are zero.
  auto load_stage = [&](int kt) {
    Tin* as = smem + (kt % S) * SmemW<Tin, T>::STAGE;
    Tin* bs = as + BK * BM;
    const int p0 = p_begin + kt * BK;
    for (int i = tid; i < BK * AP; i += T::THREADS) {
      const int r = i / AP, gp = p0 + r, gi = row0 + (i % AP) * VEC;
      copy_piece(as + r * BM + (i % AP) * VEC,
                 a + static_cast<int64_t>(gp) * R + gi, a_vec,
                 gp < p_end ? R - gi : 0);
    }
    for (int i = tid; i < BK * BP; i += T::THREADS) {
      const int r = i / BP, gp = p0 + r, gj = col0 + (i % BP) * VEC;
      copy_piece(bs + r * BN + (i % BP) * VEC,
                 b + static_cast<int64_t>(gp) * C + gj, b_vec,
                 gp < p_end ? C - gj : 0);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (kt + S - 1 < nk) load_stage(kt + S - 1);
    cp_async_commit();
    const Tin* as = smem + (kt % S) * SmemW<Tin, T>::STAGE;
    const Tin* bs = as + BK * BM;
#pragma unroll
    for (int p = 0; p < BK; ++p) {
      float4 av[TM / 4], bv[TN / 4];
#pragma unroll
      for (int i = 0; i < TM; i += 4)
        av[i / 4] = load4(as + p * BM + quad_of(rg, i, RG));
#pragma unroll
      for (int j = 0; j < TN; j += 4)
        bv[j / 4] = load4(bs + p * BN + quad_of(cg, j, CG));
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(lane4(av[i / 4], i & 3), lane4(bv[j / 4], j & 3),
                           acc[i][j]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + quad_of(rg, i, RG);
    if (gr >= R) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + quad_of(cg, j, CG);
      if (gc < C) put(args, zb, split, gr, gc, acc[i][j]);
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

// ------------------------------------------------------------- launch ---

template <typename Tin, typename T, int KIND>  // KIND: 0 dW, 1 dX, 2 dX !TW
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr bool TW = KIND == 1;
  void (*kernel)(const Args);
  size_t bytes;  // dynamic shared memory
  if constexpr (KIND == 0) {
    kernel = dw_kernel<Tin, T>;
    bytes = SmemW<Tin, T>::bytes();
  } else {
    kernel = dx_kernel<Tin, T, TW>;
    bytes = Smem<Tin, T, TW>::bytes(T::BM);
  }
  static bool sized = false;  // once per instantiation, before its launch
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const unsigned grid_r =
      static_cast<unsigned>((static_cast<int64_t>(a.R) + T::BM - 1) / T::BM);
  const unsigned grid_c = static_cast<unsigned>((a.C + T::BN - 1) / T::BN);
  const int64_t splits =
      a.P > 0 ? (static_cast<int64_t>(a.P) + a.chunk - 1) / a.chunk : 1;
  if (grid_c > 65535u || splits * a.batch > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(grid_r, grid_c, static_cast<unsigned>(splits * a.batch)),
           T::THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename Tin, int KIND>
cudaError_t by_plan(const Args& a, int plan, cudaStream_t s) {
  switch (plan) {
    case BWD_B128:
      return launch<Tin, TileB128, KIND>(a, s);
    case BWD_B64:
      return launch<Tin, TileB64, KIND>(a, s);
    case BWD_S32:
      return launch<Tin, TileS32, KIND>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int KIND>
int dispatch(const void* x, const void* y, void* out, int R, int P, int C,
             int in_dtype, int out_dtype, int plan, int chunk, int batch,
             void* stream) {
  if (R <= 0 || C <= 0 || batch == 0) return 0;
  if (P < 0 || chunk <= 0 || chunk % CHUNK_ALIGN != 0 || batch < 0 ||
      (out_dtype != DT_F32 && out_dtype != DT_BF16))
    return cudaErrorInvalidValue;
  const Args a{x, y, out, out_dtype == DT_BF16, R, P, C, chunk, batch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == DT_F32) return by_plan<float, KIND>(a, plan, s);
  if (in_dtype == DT_BF16) return by_plan<__nv_bfloat16, KIND>(a, plan, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dY (M, N) and W (K, N) row-major in `in_dtype`, or, when `trans_w` is
// not 0, W stored (N, K) row-major (a tied LM head's embedding table: then
// dX = dY . E is a product of two row-major operands, with the same fmaf
// chain over n).  With chunk >= N, `out` is dX (M, K) in `out_dtype`; with
// a smaller chunk, `out` is an fp32 workspace (ceil(N / chunk), M, K) of
// partials for gemm_bwd_reduce, and `out_dtype` must be fp32.  `chunk` is
// a multiple of 16; `plan` an index into kernels/gemm.py::BWD_PLANS
// (BwdPlanId).  Launches on `stream` and returns cudaGetLastError().
extern "C" int gemm_bwd_dx(const void* dy, const void* w, void* out, int M,
                           int N, int K, int in_dtype, int out_dtype,
                           int plan, int chunk, int trans_w, void* stream) {
  if (trans_w)
    return dispatch<2>(dy, w, out, M, N, K, in_dtype, out_dtype, plan, chunk,
                       1, stream);
  return dispatch<1>(dy, w, out, M, N, K, in_dtype, out_dtype, plan, chunk, 1,
                     stream);
}

// X (M, K) and dY (M, N) row-major in `in_dtype`.  `out` is dW (K, N) in
// `out_dtype` with chunk >= M, else the fp32 workspace
// (ceil(M / chunk), K, N); the rest as gemm_bwd_dx.
extern "C" int gemm_bwd_dw(const void* x, const void* dy, void* out, int M,
                           int K, int N, int in_dtype, int out_dtype,
                           int plan, int chunk, void* stream) {
  return dispatch<0>(x, dy, out, K, M, N, in_dtype, out_dtype, plan, chunk, 1,
                     stream);
}

// dY (B, M, N) and W (B, K, N) row-major in `in_dtype`; B * splits <= 65535
// with splits = ceil(N / chunk).  With chunk >= N, `out` is dX (B, M, K) in
// `out_dtype`; else the fp32 workspace (splits, B, M, K) for gemm_bwd_reduce
// over B * M * K outputs.  The rest as gemm_bwd_dx.
extern "C" int bmm_bwd_dx(const void* dy, const void* w, void* out, int B,
                          int M, int N, int K, int in_dtype, int out_dtype,
                          int plan, int chunk, void* stream) {
  return dispatch<1>(dy, w, out, M, N, K, in_dtype, out_dtype, plan, chunk, B,
                     stream);
}

// X (B, M, K) and dY (B, M, N) row-major in `in_dtype`.  `out` is dW
// (B, K, N) in `out_dtype` with chunk >= M, else the fp32 workspace
// (ceil(M / chunk), B, K, N); the rest as bmm_bwd_dx.
extern "C" int bmm_bwd_dw(const void* x, const void* dy, void* out, int B,
                          int M, int K, int N, int in_dtype, int out_dtype,
                          int plan, int chunk, void* stream) {
  return dispatch<0>(x, dy, out, K, M, N, in_dtype, out_dtype, plan, chunk, B,
                     stream);
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
