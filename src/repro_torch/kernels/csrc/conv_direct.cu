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
// fp32 FFMA rate is the roof: about 67 TFLOP/s on the SXM part.  The first
// layer (Cin 3, Cout 32) is the exception: its 51 MB of fp32 output make it
// bound by bytes.  Next to the FFMA rate, shared memory: an SM issues 128
// FFMAs a clock and reads 32 floats a clock from shared memory, so a thread
// must do 4 FFMAs per float it reads to keep up (8 x 8 accumulators do,
// 8 x 4 do 2.7).
//
// What the design does about it:
//   * no band copy and no im2col in device memory: each block stages its
//     input patch in place from the padded input with its own offsets,
//     zeros past the input's edge and past Cin, and the weights of its
//     output channels;
//   * a ring of 2 stages filled by 16-byte cp.async (gemm_common.cuh), the
//     next chunk of channels while the current one computes, one barrier a
//     chunk; a ragged or unaligned piece goes element by element with zero
//     fill; bf16 is copied raw and widened as it is read; a thread walks its
//     pieces with steps worked out once, so the copy loops divide by nothing
//     that is not a compile-time power of two;
//   * the tiling is a plan, picked from the shape in Python
//     (conv_direct.py::plan_for; ids shared with PLANS below):
//       FIRST  for few input channels (the 224 x 224 x 3 layer): 32 output
//              channels a block, 512 pixels (16 rows of 32), a patch row
//              staged as the contiguous run of (tw + KW - 1) * Cin values it
//              is in x, read value by value, only the live channels
//              multiplied;
//       BAND   th output rows by 256 / th columns (th from the caller);
//       STRIP  whole output rows, BM / OW of them (th x OW strips at 14 x 14
//              and 28 x 28, where square tiles would leave pixels idle);
//       FLAT   BM consecutive pixels of the flattened B * OH * OW rows,
//              each tap's pixels staged apart: for a 1 x 1 kernel a GEMM
//              with 32-channel stages (one tap, so a chunk holds few FFMAs
//              and deep stages keep barriers rare), for a larger one an
//              im2col of the block in shared memory, one 8-channel group a
//              stage, which ran the 3 x 3 layers at 112 x 112 and 56 x 56
//              fastest (no pixel of a tile idle);
//     each thread keeps TM pixels by TN output channels of accumulators
//     (8 x 8, 8 x 4 or 4 x 4), reads 4 channels of a pixel as one 16-byte
//     vector (the threads of a quarter warp share the pixel) and its output
//     channels as 16-byte vectors;
//   * grid: x = the pixel tiles, y = the output-channel tiles.
//
// The invariant every plan keeps, so every output has the bits of any other
// plan and of the earlier one-plan kernel: each output is one fmaf chain
// from +0 over the 8-channel groups c0 = 0, 8, ... in order, within a group
// over the taps (kh, kw) row-major, within a tap over the channels
// c0 .. c0 + 7 in order; bf16 operands widened by __bfloat162float, outputs
// rounded by __float2bfloat16_rn.  A term whose operands are both zero fill
// (a channel past Cin) may be left out: it adds +0 to an accumulator that
// never holds -0, which leaves it as it is.  No atomics, so reruns give the
// same bits.  wgmma and TMA are later work.

#include "gemm_common.cuh"

namespace {

using gemm::copy_piece;
using gemm::cp_async16;
using gemm::cp_async_commit;
using gemm::cp_async_wait;
using gemm::lane4;
using gemm::load4;
using gemm::store;
using gemm::to_f32;
using gemm::zero;

constexpr int MAX_SMEM = 232448;  // a block's dynamic maximum
constexpr int GROUP = 8;          // channels of one fmaf-order group

enum DType { DT_F32 = 0, DT_BF16 = 1 };
enum Kind { FIRST = 0, BAND = 1, STRIP = 2, FLAT = 3 };

// One plan: a block of RG x CG threads computes BM = RG * TM pixels by
// BN = CG * TN output channels, each thread TM pixels (pg + RG i) by TN
// channels, the channels in stages of CK.
template <int KIND_, int TM_, int TN_, int RG_, int CG_, int CK_>
struct Plan {
  static constexpr int KIND = KIND_, TM = TM_, TN = TN_, RG = RG_, CG = CG_;
  static constexpr int CK = CK_, STAGES = 2;
  static constexpr int THREADS = RG * CG, BM = RG * TM, BN = CG * TN;
  // FLAT with more than one tap stages one group a chunk, to fit
  using Narrow = Plan<KIND_, TM_, TN_, RG_, CG_, 8>;
  static_assert(TN == 4 || TN == 8, "a thread's channels come 4 at a time");
  static_assert(CK % GROUP == 0 && (KIND != FIRST || CK == GROUP),
                "stages hold whole groups; FIRST one group");
  static_assert(KIND == FIRST || CG >= 8,
                "a quarter warp shares one pixel");
};

// The instantiated plans, by id (kernels/conv_direct.py::PLANS in the
// same order).
using P0 = Plan<FIRST, 8, 8, 64, 4, 8>;    // 512 px x 32 ch
using P1 = Plan<BAND, 8, 8, 32, 8, 8>;     // 256 px x 64 ch, th x 256/th
using P2 = Plan<STRIP, 8, 8, 32, 8, 8>;    // 256 px x 64 ch, whole rows
using P3 = Plan<STRIP, 8, 4, 16, 16, 8>;   // 128 px x 64 ch
using P4 = Plan<FLAT, 8, 4, 16, 16, 32>;   // 128 px x 64 ch
using P5 = Plan<FLAT, 4, 4, 16, 16, 32>;   // 64 px x 64 ch
using P6 = Plan<FLAT, 4, 4, 8, 16, 32>;    // 32 px x 64 ch, 128 threads
constexpr int N_PLANS = 7;

// The launch's shape, worked out on the host.
struct Geo {
  int H, W, Cin, KH, KW, Cout, OH, OW;
  int th, tw;          // pixel tile of the 2-D kinds
  int PH, PW;          // patch rows and columns (2-D kinds)
  int LDR;             // FIRST: patch row stride in elements
  int tiles_w, tiles;  // pixel tiles per image row of tiles, per image
  int nchunks;         // channel stages
  long long M;         // FLAT: B * OH * OW
};

// Elements of one stage's patch and weights, and the tables after the
// stages (ints), for plan P.
template <typename T, typename P>
struct Layout {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static __host__ __device__ int patch(const Geo& g) {
    int n = 0;
    if (P::KIND == FIRST) n = g.PH * g.LDR;
    else if (P::KIND == FLAT) n = g.KH * g.KW * P::BM * P::CK;
    else n = g.PH * g.PW * P::CK;
    return (n + VEC - 1) / VEC * VEC;
  }
  static __host__ __device__ int wts(const Geo& g) {
    return g.KH * g.KW * P::CK * P::BN;
  }
  static __host__ __device__ int stage(const Geo& g) { return patch(g) + wts(g); }
  static __host__ __device__ int table_ints(const Geo& g) {
    if (P::KIND == FIRST) return g.PH;
    if (P::KIND == FLAT) return P::BM + g.KH * g.KW;
    return 0;
  }
  static size_t bytes(const Geo& g) {
    return static_cast<size_t>(P::STAGES) * stage(g) * sizeof(T) +
           static_cast<size_t>(table_ints(g)) * sizeof(int);
  }
};

// One element into shared memory, asynchronously for fp32.
__device__ __forceinline__ void copy_one(float* dst, const float* src) {
  gemm::cp_async4(dst, src);
}
__device__ __forceinline__ void copy_one(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *dst = *src;
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

// A thread's TN weights of row `row` of a staged weight tile (BN wide):
// columns cg * 4 .. + 3 and, for TN 8, BN / 2 + cg * 4 .. + 3.
template <typename P, typename T>
__device__ __forceinline__ void load_w(const T* row, int cg, float (&wv)[P::TN]) {
  const float4 lo = load4(row + cg * 4);
  wv[0] = lo.x; wv[1] = lo.y; wv[2] = lo.z; wv[3] = lo.w;
  if constexpr (P::TN == 8) {
    const float4 hi = load4(row + P::BN / 2 + cg * 4);
    wv[4] = hi.x; wv[5] = hi.y; wv[6] = hi.z; wv[7] = hi.w;
  }
}

// The output channel of a thread's accumulator column j.
template <typename P>
__device__ __forceinline__ int col_of(int cg, int j) {
  return (j < 4 ? 0 : P::BN / 2) + cg * 4 + (j & 3);
}

template <typename T, typename P>
__global__ void __launch_bounds__(P::THREADS)
conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ y, Geo g) {
  using L = Layout<T, P>;
  constexpr int VEC = L::VEC;
  constexpr int THREADS = P::THREADS, TM = P::TM, TN = P::TN, CK = P::CK;
  constexpr int BM = P::BM, BN = P::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int SE = L::stage(g), PE = L::patch(g);
  int* table = reinterpret_cast<int*>(smem + static_cast<size_t>(P::STAGES) * SE * sizeof(T));

  const int tid = threadIdx.x;
  const int cg = tid % P::CG, pg = tid / P::CG;
  const int taps = g.KH * g.KW;
  const int co0 = blockIdx.y * BN;
  const int64_t img = static_cast<int64_t>(g.H) * g.W * g.Cin;

  // the block's pixel tile
  int64_t b = 0;
  int oh0 = 0, ow0 = 0;
  long long m0 = 0;
  if constexpr (P::KIND == FLAT) {
    m0 = static_cast<long long>(blockIdx.x) * BM;
  } else {
    b = blockIdx.x / g.tiles;
    const int t = blockIdx.x - static_cast<int>(b) * g.tiles;
    oh0 = t / g.tiles_w * g.th;
    ow0 = t % g.tiles_w * g.tw;
  }
  const T* xb = x + b * img;

  // each pixel's place in the staged patch
  int poff[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = pg + P::RG * i;
    if constexpr (P::KIND == FLAT) {
      poff[i] = p * CK;
    } else {
      const int r = p / g.tw, c = p % g.tw;
      const bool live = p < g.th * g.tw;
      if constexpr (P::KIND == FIRST)
        poff[i] = live ? r : 0;  // the row; the column is in pcol
      else
        poff[i] = live ? (r * g.PW + c) * CK : 0;
    }
  }
  int pcol[P::KIND == FIRST ? TM : 1];
  const int ps = g.Cin <= GROUP ? g.Cin : GROUP;  // FIRST: a pixel's stride
  if constexpr (P::KIND == FIRST) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int p = pg + P::RG * i;
      pcol[i] = (p % g.tw) * ps;
    }
  }

  // tables: FLAT each pixel's input pixel (-1 past M) and each tap's
  // offset in pixels; FIRST each patch row's shift (set per stage)
  if constexpr (P::KIND == FLAT) {
    for (int p = tid; p < BM; p += THREADS) {
      const long long m = m0 + p;
      int v = -1;
      if (m < g.M) {
        const long long per = static_cast<long long>(g.OH) * g.OW;
        const long long bb = m / per;
        const int rest = static_cast<int>(m - bb * per);
        v = static_cast<int>((bb * g.H + rest / g.OW) * g.W + rest % g.OW);
      }
      table[p] = v;
    }
    for (int t = tid; t < taps; t += THREADS)
      table[BM + t] = (t / g.KW) * g.W + t % g.KW;
  }
  if constexpr (P::KIND == FIRST) {
    for (int r = tid; r < g.PH; r += THREADS) table[r] = 0;
  }
  __syncthreads();

  const bool xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && g.Cin % VEC == 0;
  const bool wvec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && g.Cout % VEC == 0;

  // the 2-D kinds' patch pieces: pixel tid / CKV + k * PSTEP, piece tid % CKV
  constexpr int CKV = CK / VEC > 0 ? CK / VEC : 1;
  constexpr int PSTEP = THREADS / CKV;
  const int psub = tid % CKV;
  int pr0 = 0, pc0 = 0, pdr = 0, pdc = 0;
  if constexpr (P::KIND != FLAT) {
    const int pix0 = tid / CKV;
    pr0 = pix0 / g.PW;
    pc0 = pix0 % g.PW;
    pdr = PSTEP / g.PW;
    pdc = PSTEP % g.PW;
  }
  // FIRST's run pieces: row tid / NPR + k * dr, piece tid % NPR + k * dc
  const int npr = g.LDR / VEC;
  int rr0 = 0, rk0 = 0, rdr = 0, rdk = 0;
  if constexpr (P::KIND == FIRST) {
    rr0 = tid / npr;
    rk0 = tid % npr;
    rdr = THREADS / npr;
    rdk = THREADS % npr;
  }

  auto stage = [&](int n, int slot) {
    T* pa = ring + static_cast<size_t>(slot) * SE;
    T* pw = pa + PE;
    const int c0 = n * CK;
    // weights [tap][CK][BN]: row tid / WPR + k * WSTEP, piece tid % WPR
    {
      constexpr int WPR = BN / VEC;
      constexpr int WSTEP = THREADS / WPR;
      static_assert(THREADS % WPR == 0, "weight rows split evenly");
      const int col = (tid % WPR) * VEC;
      const int valid_c = g.Cout - co0 - col;
      for (int row = tid / WPR; row < taps * CK; row += WSTEP) {
        const int tap = row / CK, ci = row % CK;  // CK a power of two
        const int cc = c0 + ci;
        const bool in = cc < g.Cin && valid_c > 0;
        copy_piece(pw + row * BN + col,
                   in ? w + (static_cast<int64_t>(tap) * g.Cin + cc) * g.Cout + co0 + col
                      : w,
                   wvec, in ? valid_c : 0);
      }
    }
    if constexpr (P::KIND == FLAT) {
      constexpr int PIECES = BM * CKV;
      for (int q = tid; q < taps * PIECES; q += THREADS) {
        const int tap = q / PIECES, pix = q % PIECES / CKV, sub = q % CKV;
        const int src = table[pix];
        const int cc = c0 + sub * VEC;
        const bool in = src >= 0 && cc < g.Cin;
        copy_piece(pa + (tap * BM + pix) * CK + sub * VEC,
                   in ? x + (static_cast<int64_t>(src) + table[BM + tap]) * g.Cin + cc : x,
                   xvec, in ? g.Cin - cc : 0);
      }
    } else if (P::KIND == FIRST && g.Cin <= GROUP) {
      // one chunk: patch row r is the run of PW * Cin values at
      // (oh0 + r, ow0), stored from its 16-byte aligned start; shift[r]
      // says where the run begins
      const int cols = min(g.PW, g.W - ow0);
      int r = rr0, k = rk0;
      for (int q = tid; q < g.PH * npr; q += THREADS) {
        const int ih = oh0 + r;
        const int nrun = ih < g.H ? cols * g.Cin : 0;
        const T* run = xb + (static_cast<int64_t>(min(ih, g.H - 1)) * g.W + ow0) * g.Cin;
        const int s = static_cast<int>(reinterpret_cast<uintptr_t>(run) % 16) /
                      static_cast<int>(sizeof(T));
        const int e0 = k * VEC - s;  // run index of the piece's first element
        T* dst = pa + r * g.LDR + k * VEC;
        if (k == 0) table[r] = s;
        if (e0 >= 0 && e0 + VEC <= nrun) {
          cp_async16(dst, run + e0);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int idx = e0 + e;
            if (idx >= 0 && idx < nrun)
              copy_one(dst + e, run + idx);
            else
              dst[e] = zero<T>();
          }
        }
        k += rdk;
        r += rdr;
        if (k >= npr) {
          k -= npr;
          ++r;
        }
      }
    } else {
      // pixel (r, c) of the patch, channels c0 .. c0 + CK - 1
      const int cc = c0 + psub * VEC;
      int r = pr0, c = pc0;
      for (int pix = tid / CKV; pix < g.PH * g.PW; pix += PSTEP) {
        const int ih = oh0 + r, iw = ow0 + c;
        const bool in = ih < g.H && iw < g.W && cc < g.Cin;
        T* dst = P::KIND == FIRST ? pa + r * g.LDR + c * GROUP + psub * VEC
                                  : pa + pix * CK + psub * VEC;
        copy_piece(dst, in ? xb + (static_cast<int64_t>(ih) * g.W + iw) * g.Cin + cc : x,
                   xvec, in ? g.Cin - cc : 0);
        c += pdc;
        r += pdr;
        if (c >= g.PW) {
          c -= g.PW;
          ++r;
        }
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < P::STAGES - 1; ++s) {
    if (s < g.nchunks) stage(s, s);
    cp_async_commit();
  }
  for (int n = 0; n < g.nchunks; ++n) {
    cp_async_wait<P::STAGES - 2>();
    __syncthreads();  // chunk n landed; chunk n - 1's reads are done
    {
      const int nn = n + P::STAGES - 1;
      if (nn < g.nchunks) stage(nn, nn % P::STAGES);
      cp_async_commit();
    }
    const T* pa = ring + static_cast<size_t>(n % P::STAGES) * SE;
    const T* pw = pa + PE;
    const int c0 = n * CK;
    if constexpr (P::KIND == FIRST) {
      const int live = min(GROUP, g.Cin - c0);
      for (int kh = 0; kh < g.KH; ++kh) {
        int base[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = poff[i] + kh;
          base[i] = r * g.LDR + table[r] + pcol[i];
        }
        for (int kw = 0; kw < g.KW; ++kw) {
          const int off = kw * ps;
          const T* wrow = pw + (kh * g.KW + kw) * GROUP * BN;
#pragma unroll
          for (int ci = 0; ci < GROUP; ++ci) {
            if (ci < live) {
              float wv[TN];
              load_w<P>(wrow + ci * BN, cg, wv);
#pragma unroll
              for (int i = 0; i < TM; ++i) {
                const float a = to_f32(pa[base[i] + off + ci]);
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
              }
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int gi = 0; gi < CK / GROUP; ++gi) {
        if (c0 + gi * GROUP >= g.Cin) break;
        int kh = 0, kw = 0;
        for (int tap = 0; tap < taps; ++tap) {
          const int aoff = (P::KIND == FLAT ? tap * BM * CK : (kh * g.PW + kw) * CK) +
                           gi * GROUP;
          const T* wrow = pw + (tap * CK + gi * GROUP) * BN;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float4 av[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i) av[i] = load4(pa + poff[i] + aoff + 4 * h);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float wv[TN];
              load_w<P>(wrow + (4 * h + e) * BN, cg, wv);
#pragma unroll
              for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                  acc[i][j] = fmaf(lane4(av[i], e), wv[j], acc[i][j]);
            }
          }
          if (++kw == g.KW) {
            kw = 0;
            ++kh;
          }
        }
      }
    }
  }

  const bool yvec = reinterpret_cast<uintptr_t>(y) % (4 * sizeof(T)) == 0 &&
                    g.Cout % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = pg + P::RG * i;
    int64_t pix;
    if constexpr (P::KIND == FLAT) {
      pix = m0 + p;
      if (pix >= g.M) continue;
    } else {
      const int r = p / g.tw, c = p % g.tw;
      const int oh = oh0 + r, ow = ow0 + c;
      if (p >= g.th * g.tw || oh >= g.OH || ow >= g.OW) continue;
      pix = (b * g.OH + oh) * g.OW + ow;
    }
    T* yrow = y + pix * g.Cout;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int co = co0 + col_of<P>(cg, 4 * q);
      const float v[4] = {acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                          acc[i][4 * q + 3]};
      if (yvec && co + 4 <= g.Cout) {
        store4(yrow + co, v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (co + e < g.Cout) store(yrow + co + e, v[e]);
      }
    }
  }
}

template <typename T, typename P>
cudaError_t launch(const void* x, const void* w, void* y, int B, Geo g,
                   cudaStream_t stream) {
  if constexpr (P::KIND == FLAT && P::CK != GROUP) {
    if (g.KH * g.KW > 1) return launch<T, typename P::Narrow>(x, w, y, B, g, stream);
  }
  using L = Layout<T, P>;
  const int OW = g.OW, OH = g.OH;
  if constexpr (P::KIND == FIRST) {
    g.tw = min(OW, 32);
    g.th = P::BM / g.tw;
  } else if constexpr (P::KIND == BAND) {
    g.th = min(g.th, OH);
    g.tw = min(OW, max(1, P::BM / g.th));
  } else if constexpr (P::KIND == STRIP) {
    g.tw = min(OW, P::BM);
    g.th = P::BM / g.tw;
  }
  const int ck = P::KIND == FIRST ? GROUP : P::CK;
  g.nchunks = (g.Cin + ck - 1) / ck;
  long long grid_x;
  if constexpr (P::KIND == FLAT) {
    g.M = static_cast<long long>(B) * OH * OW;
    grid_x = (g.M + P::BM - 1) / P::BM;
    if (static_cast<long long>(B) * g.H * g.W > 2147483647LL) return cudaErrorInvalidValue;
  } else {
    g.th = min(g.th, OH);
    g.PH = g.th + g.KH - 1;
    g.PW = g.tw + g.KW - 1;
    g.tiles_w = (OW + g.tw - 1) / g.tw;
    g.tiles = (OH + g.th - 1) / g.th * g.tiles_w;
    grid_x = static_cast<long long>(B) * g.tiles;
    constexpr int VEC = L::VEC;
    g.LDR = (g.PW * GROUP + VEC - 1) / VEC * VEC + VEC;
  }
  if (static_cast<long long>(g.H) * g.W * g.Cin > 2147483647LL) return cudaErrorInvalidValue;
  const int grid_y = (g.Cout + P::BN - 1) / P::BN;
  const size_t bytes = L::bytes(g);
  if (grid_x > 2147483647LL || grid_y > 65535 || bytes > MAX_SMEM)
    return cudaErrorInvalidValue;
  auto kernel = conv_kernel<T, P>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(static_cast<unsigned>(grid_x), grid_y), P::THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int plan, const void* x, const void* w, void* y, int B,
                const Geo& g, cudaStream_t s) {
  switch (plan) {
    case 0: return launch<T, P0>(x, w, y, B, g, s);
    case 1: return launch<T, P1>(x, w, y, B, g, s);
    case 2: return launch<T, P2>(x, w, y, B, g, s);
    case 3: return launch<T, P3>(x, w, y, B, g, s);
    case 4: return launch<T, P4>(x, w, y, B, g, s);
    case 5: return launch<T, P5>(x, w, y, B, g, s);
    case 6: return launch<T, P6>(x, w, y, B, g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, H, W, Cin) and w (KH, KW, Cin, Cout) row-major in `dtype`, y
// (B, H - KH + 1, W - KW + 1, Cout) row-major in `dtype`; 1 <= th <= 64
// output rows per band (BAND plans; the other plans shape their own
// tiles); `plan` an id of the instantiated plans.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int conv_direct(const void* x, const void* w, void* y, int B,
                           int H, int W, int Cin, int KH, int KW, int Cout,
                           int th, int dtype, int plan, void* stream) {
  if (plan < 0 || plan >= N_PLANS) return cudaErrorInvalidValue;
  if (B <= 0 || Cout <= 0 || H < KH || W < KW) return 0;
  if (Cin <= 0 || KH <= 0 || KW <= 0 || th < 1 || th > 64)
    return cudaErrorInvalidValue;
  Geo g{};
  g.H = H; g.W = W; g.Cin = Cin; g.KH = KH; g.KW = KW; g.Cout = Cout;
  g.OH = H - KH + 1; g.OW = W - KW + 1; g.th = th;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return run<float>(plan, x, w, y, B, g, s);
  if (dtype == DT_BF16) return run<__nv_bfloat16>(plan, x, w, y, B, g, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* conv_direct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
