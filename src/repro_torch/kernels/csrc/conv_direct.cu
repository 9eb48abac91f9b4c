// Direct (implicit-GEMM) convolution for Hopper (sm_90a):
//
//   y[b, oh, ow, co] = sum_{kh, kw, ci} x[b, oh + kh, ow + kw, ci] w[kh, kw, ci, co]
//
// a stride-1 VALID convolution of a pre-padded NHWC x (B, H, W, Cin) with
// w (KH, KW, Cin, Cout) into y (B, H - KH + 1, W - KW + 1, Cout), fp32
// accumulation, y in x's dtype (fp32 or bf16).  Forward only.
//
// Replaces src/repro/kernels/conv_direct.py::conv2d_direct (its pallas_call
// runs _band_kernel): one TPU grid step per (batch, band of th output rows)
// stages a halo band (th + KH - 1, W, Cin) in VMEM, copied out of x by the
// wrapper because BlockSpecs cannot overlap, and adds the KH x KW shifted
// windows' products into a resident accumulator.
//
// What bounds it on an H100: at the DARKNET19 layers (batch 8, 3x3 and 1x1,
// Cin 3 to 512) every output reads KH*KW*Cin inputs for as many FMAs, tens
// to hundreds of FLOPs per byte the function must move, so under
// fp32_strict (true fp32 products, no tensor cores, no TF32) the card's
// fp32 FFMA rate is the roof: about 67 TFLOP/s on the SXM part.
//
// What the design does about it, kept simple and exact first:
//   * no band copy and no im2col: each block reads its halo patch in place
//     from the padded input with its own offsets, masking rows and columns
//     past the input and channels past Cin;
//   * a VMEM band of all of Cin does not fit a block (a 10-row band of
//     layer 2, padded W 114 and Cin 32, is 146 KB of fp32; of layers 9 and
//     11, W 16 and Cin 256, 164 KB), and neither do the accumulators of a
//     whole band (th x OW x Cout).  So a block owns a tile of th output rows
//     by 64 / th columns (64 pixels; 8 x 8 at the default th = 8) and 64
//     output channels, and loops over Cin in chunks of CK = 8: per chunk it
//     stages the (th + KH - 1) x (64 / th + KW - 1) x CK input patch and the
//     KH x KW x CK x 64 weights in shared memory as fp32 (21.6 KB for 3x3),
//     then every tap reads its shifted window of the patch;
//   * each thread keeps 4 pixels x 4 output channels of fp32 accumulators in
//     registers and reads its operands from shared memory as float4 (a
//     pixel's CK channels are contiguous), 8 FFMAs per 16-byte load;
//   * grid: x = batch x row bands x column tiles, y = 64-channel tiles.
// Every output is one thread's fmaf chain in a fixed order (Cin chunks, then
// taps kh, kw, then channels), so reruns give the same bits; no atomics.
// Double buffering, wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CK = 8;                            // channels staged per pass
constexpr int BM = 64;                           // output pixels per block
constexpr int BN = 64;                           // output channels per block
constexpr int TM = 4;                            // pixels per thread
constexpr int TN = 4;                            // channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int TCOLS = BN / TN;
constexpr int MAX_SMEM = 232448;                 // a block's dynamic maximum

enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

int smem_bytes(int th, int tw, int KH, int KW) {
  return ((th + KH - 1) * (tw + KW - 1) * CK + KH * KW * CK * BN) *
         static_cast<int>(sizeof(float));
}

// One block: output rows [oh0, oh0 + th) x columns [ow0, ow0 + tw) of image
// b, channels [co0, co0 + BN).  th * tw <= BM.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_direct_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, int H, int W, int Cin, int KH, int KW,
                   int Cout, int OH, int OW, int th, int tw, int n_bands,
                   int n_wtiles) {
  extern __shared__ __align__(16) float smem[];
  const int PH = th + KH - 1, PW = tw + KW - 1;
  float* patch = smem;                  // [PH][PW][CK]
  float* wts = smem + PH * PW * CK;     // [KH * KW][CK][BN]

  int64_t bid = blockIdx.x;
  const int wt = static_cast<int>(bid % n_wtiles);
  bid /= n_wtiles;
  const int band = static_cast<int>(bid % n_bands);
  const int64_t b = bid / n_bands;
  const int oh0 = band * th, ow0 = wt * tw, co0 = blockIdx.y * BN;

  const int tid = threadIdx.x;
  const int tcol = tid % TCOLS;
  const int trow = tid / TCOLS;
  int poff[TM];  // each pixel's patch offset; pixels past th * tw read row 0
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = trow * TM + i;
    poff[i] = p < th * tw ? ((p / tw) * PW + p % tw) * CK : 0;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const T* xb = x + b * H * W * Cin;
  const int taps = KH * KW;
  const int pn = PH * PW * CK;
  const int wn = taps * CK * BN;
  for (int c0 = 0; c0 < Cin; c0 += CK) {
    for (int e = tid; e < pn; e += THREADS) {
      const int ci = e % CK, pix = e / CK;
      const int ih = oh0 + pix / PW, iw = ow0 + pix % PW, cc = c0 + ci;
      patch[e] = (ih < H && iw < W && cc < Cin)
                     ? to_f32(xb[(static_cast<int64_t>(ih) * W + iw) * Cin + cc])
                     : 0.f;
    }
    for (int e = tid; e < wn; e += THREADS) {
      const int co = e % BN, rest = e / BN;
      const int cc = c0 + rest % CK, tap = rest / CK, gco = co0 + co;
      wts[e] = (cc < Cin && gco < Cout)
                   ? to_f32(w[(static_cast<int64_t>(tap) * Cin + cc) * Cout + gco])
                   : 0.f;
    }
    __syncthreads();
    for (int tap = 0; tap < taps; ++tap) {
      const int kh = tap / KW, kw = tap - kh * KW;
      const float* pa = patch + (kh * PW + kw) * CK;
      const float* pb = wts + tap * CK * BN + tcol * TN;
      float a[TM][CK];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 lo = *reinterpret_cast<const float4*>(pa + poff[i]);
        const float4 hi = *reinterpret_cast<const float4*>(pa + poff[i] + 4);
        a[i][0] = lo.x; a[i][1] = lo.y; a[i][2] = lo.z; a[i][3] = lo.w;
        a[i][4] = hi.x; a[i][5] = hi.y; a[i][6] = hi.z; a[i][7] = hi.w;
      }
#pragma unroll
      for (int ci = 0; ci < CK; ++ci) {
        const float4 b4 = *reinterpret_cast<const float4*>(pb + ci * BN);
        const float bv[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][ci], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  T* yb = y + b * OH * OW * Cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = trow * TM + i;
    if (p >= th * tw) continue;
    const int oh = oh0 + p / tw, ow = ow0 + p % tw;
    if (oh >= OH || ow >= OW) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = co0 + tcol * TN + j;
      if (co < Cout) store(yb + (static_cast<int64_t>(oh) * OW + ow) * Cout + co, acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int B, int H, int W,
                   int Cin, int KH, int KW, int Cout, int th,
                   cudaStream_t stream) {
  const int OH = H - KH + 1, OW = W - KW + 1;
  const int tw = BM / th;
  const int n_bands = (OH + th - 1) / th, n_wtiles = (OW + tw - 1) / tw;
  const int64_t grid_x = static_cast<int64_t>(B) * n_bands * n_wtiles;
  const int grid_y = (Cout + BN - 1) / BN;
  const int bytes = smem_bytes(th, tw, KH, KW);
  if (grid_x > 2147483647LL || grid_y > 65535 || bytes > MAX_SMEM)
    return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_direct_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  conv_direct_kernel<T><<<dim3(static_cast<unsigned>(grid_x), grid_y), THREADS,
                          bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      H, W, Cin, KH, KW, Cout, OH, OW, th, tw, n_bands, n_wtiles);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cin) and w (KH, KW, Cin, Cout) row-major in `dtype`, y
// (B, H - KH + 1, W - KW + 1, Cout) row-major in `dtype`; 1 <= th <= 64
// output rows per band (a block's tile is th x 64 / th pixels).  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int conv_direct(const void* x, const void* w, void* y, int B,
                           int H, int W, int Cin, int KH, int KW, int Cout,
                           int th, int dtype, void* stream) {
  if (B <= 0 || Cout <= 0 || H < KH || W < KW) return 0;
  if (Cin <= 0 || KH <= 0 || KW <= 0 || th < 1 || th > BM)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(x, w, y, B, H, W, Cin, KH, KW, Cout, th, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, w, y, B, H, W, Cin, KH, KW, Cout, th, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* conv_direct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
