// Shared pieces of the GEMM kernels for Hopper (sm_90a): the fused forward
// (gemm.cu) and the backward dX and dW (gemm_bwd.cu).
//
// All of them stage their operands through a ring of shared-memory stages
// filled by cp.async a few stages ahead (`cp_async16`, `copy_piece`): a
// 16-byte piece that lies wholly inside its operand and is 16-byte aligned
// goes by one cp.async.cg, a ragged or unaligned one element by element
// with zeros past the edge, so any shape and any alignment runs without
// padding in memory.  Operands are fp32 or bf16 in shared memory and
// widened to fp32 as they are read (`load4`, `to_f32`); every output is
// fp32 arithmetic, stored as fp32 or rounded to bf16 (`store`).  A block
// computes a `Tile` of the output.  `Smem` and `col_of` are the layout of
// a stage whose first operand is read along the contraction (the
// forward's x, dX's dY) and of the threads' columns against it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm {

enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 4 consecutive values at p widened to fp32 (p 16-byte aligned for fp32,
// 8-byte for bf16); the same values as to_f32 one by one.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]);
  const float2 hi = __bfloat1622float2(q[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Component q (0..3) of v.
__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte piece of a tile row into shared memory: `valid` of its
// elements lie inside the operand (<= 0: none).  A whole, aligned piece
// goes by one 16-byte cp.async; a ragged or unaligned one element by
// element (fp32 by 4-byte cp.async, bf16 by plain loads), with zeros past
// the edge.
template <typename T>
__device__ __forceinline__ void copy_piece(T* dst, const T* src, bool vec,
                                           int valid) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec && valid >= VEC) {
    cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if (e >= valid)
      dst[e] = zero<T>();
    else if (sizeof(T) == 4)
      cp_async4(dst + e, src + e);
    else
      dst[e] = src[e];
  }
}

// One plan: a BM x BN output tile per block of THREADS threads, each
// thread TM rows by TN columns, the contraction over a ring of STAGES
// stages BK deep.
template <int BM_, int BN_, int THREADS_, int TN_, int BK_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, THREADS = THREADS_, TN = TN_;
  static constexpr int BK = BK_, STAGES = STAGES_;
  static constexpr int CG = BN / TN;       // column slots across a row
  static constexpr int RG = THREADS / CG;  // row groups
  static constexpr int TM = BM / RG;       // rows a thread holds
  static_assert(CG * TN == BN && RG * CG == THREADS && TM * RG == BM,
                "tile must split evenly");
  static_assert(TN == 1 || TN % 4 == 0, "columns come one or 4 at a time");
  // at most 128 registers a thread, so that 64K-register SMs keep
  // 65536 / (THREADS * 128) blocks resident
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 128);
};

// A stage of x (rows x BK, k fastest) and w: a row-major w (K, N) as it
// lies (BK x BN), a transposed w (stored (N, K)) k-major (BN x BK), each
// k-major row padded by 16 bytes.
template <typename Tin, typename T, bool TW>
struct Smem {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(Tin));
  // row stride of a k-major tile (x, and w when TW), padded by 16 bytes
  static constexpr int XS = T::BK + VEC;
  static constexpr int WSZ = TW ? T::BN * XS : T::BK * T::BN;
  static constexpr __host__ __device__ int stage_elems(int rows) {
    return rows * XS + WSZ;
  }
  static size_t bytes(int rows) {
    return static_cast<size_t>(T::STAGES) * stage_elems(rows) * sizeof(Tin);
  }
};

// Column j of a thread in column slot cg: row-major w groups of 4
// consecutive columns (read as 16-byte vectors), the halves BN / 2
// apart; a transposed w strided columns (no two threads of a row on one
// bank).
template <typename T, bool TW>
__device__ __forceinline__ int col_of(int cg, int j) {
  if (TW || T::TN == 1) return cg + j * T::CG;
  return cg * 4 + (j & 3) + (j >> 2) * (T::BN / 2);
}

}  // namespace gemm
