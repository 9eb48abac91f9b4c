// Shared pieces of the attention kernels for Hopper (sm_90a): the grouped
// flash-attention forward (flash_attention.cu), its backward
// (flash_attention_bwd.cu) and the split-KV decode kernel
// (flash_decode.cu): the key tile, the masking sentinels, the dtype
// helpers and the shared-memory opt-in.
//
// The forward and the decode kernel each walk 64-key tiles (BKV) of one
// (batch, kv-head) pair and keep the same per-tile arithmetic, written out
// in flash_attention.cu's header: a score is one fmaf chain over d; keys
// at or past a row's bound score -1e30 (NEG), and p = exp(s - m) is 0
// where s <= -5e29 (NEG_HALF), so a fully-masked row comes out exact 0,
// never NaN; the tile's sum is p[j] + p[j + 32] then the xor butterfly
// over 16, 8, 4, 2, 1 lanes (FULL); P V is one chain over the tile's keys.
// Every rounding is an explicit intrinsic (__fmaf_rn, __fmul_rn,
// __fadd_rn), so the compiler cannot contract the kernels differently, and
// the decode kernel at one split gives the forward kernel's bits on the
// same problem (the property `test_single_split_degenerates_bit_identically`
// pins in the JAX package).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int BKV = 64;       // keys of one tile
constexpr int THREADS = 256;  // the backward's blocks: 8 warps
constexpr float NEG = -1e30f;
constexpr float NEG_HALF = -5e29f;
constexpr unsigned FULL = 0xffffffffu;

enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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
