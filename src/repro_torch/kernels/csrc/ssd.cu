// Mamba2 SSD (state-space duality) chunk scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd.py::_ssd_kernel (launched by ssd_scan,
// pallas_call at ssd.py:97).  For one (batch, head) the sequence is cut
// into chunks of Q rows; with x̄ = x·dt and cs = cumsum(dA) within a chunk,
//   y_q   = Σ_{k<=q} (C_q·B_k) exp(cs_q − cs_k) x̄_k  +  exp(cs_q) (C_q·stateᵀ)
//   state ← exp(cs_last) state + Σ_k (x̄_k exp(cs_last − cs_k))ᵀ B_k
// with a (P, N) fp32 state carried from chunk to chunk (zero, or `init`,
// before the first).  The kernel also writes the final state, which the
// prefill keeps as the layer's SSM cache.
//
// What bounds it on an H100: at mamba2-1.3b's prefill (Q 256, N 128, P 64,
// 64 heads in one group) the function needs, per chunk and head, Q²P/2
// FMAs for the scores times x̄ and 2QNP for the state's term and update,
// and Q²N/2 for C·Bᵀ once per group, against Q P inputs: it is bound by
// operations (the FFMA rate, 67 TFLOP/s on the SXM part), far above the
// bytes of x, y, B and C.  Next to it, shared memory: an SM issues 128
// FFMAs a clock but reads 32 floats a clock, so what counts is the FFMAs a
// thread does per float it reads.  At the serving shapes (batch 1, one
// short chunk) the work is a few microseconds spread over the card; there
// the bound is latency: how many blocks, and how short their chains.
//
// What the design does about it:
//   * the recurrence is cut into three steps that change no bit: each
//     chunk's own contribution nw_c = Σ_k (x̄_k exp(cs_last − cs_k))ᵀ B_k
//     and exp(cs_last) ("state" blocks, in parallel over batch, chunk and
//     heads); a carry pass state_c = exp(cs_last) state_{c−1} + nw_c in
//     chunk order (`ssd_carry`), which writes the state entering each
//     chunk over nw_c in an fp32 scratch the wrapper allocates; and
//     the outputs ("y" blocks, in parallel over batch, chunk, 64-row query
//     tile and heads).  With one chunk the state blocks write the final
//     state and both kinds run side by side in one launch (at the serving
//     shapes 0.0106 ms a scan on an H100 against 0.0182 for the two kinds
//     launched in turn, kernels/time_ssd.py); with more, three launches,
//     the state and y blocks each in a kernel of its own, so that each
//     holds only its own registers (two state blocks an SM);
//   * a y block forms each causal 64 x 64 tile of C·Bᵀ once, keeps the
//     tile row in shared memory, and serves all its heads (up to 8 of one
//     group, `Plan`) and all of P from it; tiles above the diagonal are
//     skipped, and a warp whose rows or keys are all dead skips its part;
//   * every product is register-tiled, 4 x 4 outputs a thread read as two
//     16-byte vectors per step (scores, S·x̄ and C·stateᵀ), or 4 x 8 of each
//     of two heads whose x̄ᵀ·B share the B vectors, from rows swizzled by
//     16-byte piece so that the vectors a warp reads at once lie on
//     distinct banks; dt and cs per head sit in shared memory;
//   * B, C, x and the carried state are staged by 16-byte cp.async
//     (gemm_common.cuh) a tile ahead, bf16 copied raw and widened as read;
//   * cs is summed in row order with one lane per head, the heads of a
//     block in parallel (in a y block by a warp that the diagonal tile
//     leaves idle);
//   * the y blocks of the last query tiles, the heaviest, come first;
//   * the serving shapes (batch 1, one chunk of 7-47 rows) take a plan of
//     one head a block, 64 y and 64 state blocks in one wave, whose work
//     stops at the live rows; the carried state's term is skipped where
//     the state is exactly zero (the first chunk with no `init`), as
//     fadd(acc, fmul(exp(cs_q), 0)), the same bits;
//   * B and C are read by group through strides: head h reads group
//     h / (H / G), with no per-head copy; the ragged last chunk is masked.
// Every output keeps the chain of roundings of the earlier one-block-per-
// head kernel: cs a row-order __fadd_rn chain; a score one __fmaf_rn chain
// over n; w = fmul(s, expf(fsub(cs_q, cs_k))); y's intra-chunk sum one
// __fmaf_rn chain over the keys in order (terms with w = 0 past the
// diagonal dropped: they add +0); the state's term a chain over n, then
// fadd(acc, fmul(expf(cs_q), yo)); the update a chain over the chunk's rows,
// then fadd(fmul(expf(cs_last), state), nw).  No TF32, no tensor cores.

#include <type_traits>

#include "gemm_common.cuh"

namespace {

using gemm::copy_piece;
using gemm::cp_async_commit;
using gemm::cp_async_wait;
using gemm::DT_BF16;
using gemm::DT_F32;
using gemm::load4;
using gemm::store;
using gemm::to_f32;

constexpr int THREADS = 256;
constexpr int TQ = 64;       // rows of a query or key tile (y blocks)
constexpr int KT = 32;       // rows of a stage (state blocks)
constexpr int PMAX = 64;     // the largest head dim P
constexpr int QMAX = 256;    // the largest chunk
constexpr int SLD = TQ + 4;  // row stride of the score and weight tiles
constexpr int MAX_SMEM = 232448;

// A plan: the heads of a y block, the heads of a state block.
struct Plan {
  int y_heads, s_heads;
};
constexpr Plan PLANS[] = {{8, 4}, {1, 1}};
constexpr int N_PLANS = sizeof(PLANS) / sizeof(PLANS[0]);

struct Args {
  const void* x;      // (Bt, S, H, P), strides xs*
  const float* dt;    // (Bt, S, H), strides ds*
  const float* da;    // dt * A, same layout as dt
  const void* b;      // (Bt, S, G, N), strides bs*
  const void* c;      // (Bt, S, G, N), strides cs*
  const float* init;  // (Bt, H, P, N) contiguous, or null for zeros
  void* y;            // (Bt, S, H, P) contiguous, x's dtype
  float* state;       // (Bt, H, P, N) contiguous
  float* nw;          // (Bt, nc, H, P, N) scratch when nc > 1
  float* dec;         // (Bt, nc, H) scratch when nc > 1: exp(cs_last)
  int Bt, S, H, G, P, Q, nc;
  int qmax;       // rows of the longest chunk: min(Q, S)
  bool state_in;  // some chunk starts from a state (init, or nc > 1)
  long long xsb, xss, xsh, dsb, dss, dsh, bsb, bss, bsg, csb, css, csg;
  int y_heads, s_heads;
  int y_blocks;  // blocks [0, y_blocks) compute y, the rest the states
  bool xvec, bvec, cvec, ivec;  // 16-byte cp.async allowed for x, B, C, init
};

__host__ __device__ inline int round16(int bytes) { return (bytes + 15) & ~15; }
// Row stride of a block's cs table: odd, so one lane per head hits
// distinct banks.
__host__ __device__ inline int cs_stride(int q) { return q | 1; }

// Byte offsets of a y block's shared memory for chunks of at most q rows:
// cs and dt per head, the C tile, the score tile row (key-major), then
// either the ring of B tiles or x̄, the weights and the carried state (when
// some chunk starts from one), and after both the ring of raw x tiles
// (prefetched while the B ring is in use).  Rings hold two stages where a
// block walks more than one tile.
template <typename T, int N>
struct YSmem {
  int cs, dt, c, st, xb, w, s, xr, total;
  __host__ __device__ YSmem(int q, int heads, bool state_in) {
    const int tiles = (q + TQ - 1) / TQ;
    cs = 0;
    dt = round16(heads * cs_stride(q) * 4);
    c = 2 * dt;
    st = c + TQ * N * static_cast<int>(sizeof(T));
    xb = st + tiles * TQ * SLD * 4;
    w = xb + TQ * PMAX * 4;
    s = w + TQ * SLD * 4;
    const int bring =
        xb + (tiles > 1 ? 2 : 1) * TQ * N * static_cast<int>(sizeof(T));
    xr = s + (state_in ? PMAX * N * 4 : 0);
    xr = xr > bring ? xr : bring;
    total = xr + (heads * tiles > 1 ? 2 : 1) * TQ * PMAX *
                     static_cast<int>(sizeof(T));
  }
};

// Byte offsets of a state block's shared memory for chunks of at most q
// rows: cs, dt and the decay exp(cs_last − cs_k) per head, the ring of two
// stages of raw x (a pair of heads) and B, and the stage's x̄·decay of the
// pair in fp32.
template <typename T, int N>
struct SSmem {
  int cs, dt, dk, xr, br, xd, total;
  __host__ __device__ SSmem(int q, int heads) {
    const int tab = round16(heads * cs_stride(q) * 4);
    cs = 0;
    dt = tab;
    dk = 2 * tab;
    xr = 3 * tab;
    br = xr + 2 * 2 * KT * PMAX * static_cast<int>(sizeof(T));
    xd = br + 2 * KT * N * static_cast<int>(sizeof(T));
    total = xd + 2 * KT * PMAX * 4;
  }
};

// Where 16-byte piece pc of a row of NP pieces sits in a tile swizzled by
// `sw` (a row, or a row / 4): pieces are permuted within a row by the low
// three bits of sw.
template <int NP>
__device__ __forceinline__ int piece(int pc, int sw) {
  return pc ^ (sw & 7 & (NP - 1));
}

// Element offset of the 4 values at column e (a multiple of 4) of row
// `row` in a swizzled tile of rows of N elements.
template <typename T, int N>
__device__ __forceinline__ int swz(int row, int e, int sw) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  return row * N + piece<N / VEC>(e / VEC, sw) * VEC + e % VEC;
}

__device__ __forceinline__ float4 f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// acc[0..3] = fmaf(a, b.{x,y,z,w}, acc[..]): one step of four chains.
__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] = __fmaf_rn(a, b.x, acc[0]);
  acc[1] = __fmaf_rn(a, b.y, acc[1]);
  acc[2] = __fmaf_rn(a, b.z, acc[2]);
  acc[3] = __fmaf_rn(a, b.w, acc[3]);
}

// s += a · b over the 4 entries of n in order: four steps of one chain.
__device__ __forceinline__ float dot4(float s, float4 a, float4 b) {
  s = __fmaf_rn(a.x, b.x, s);
  s = __fmaf_rn(a.y, b.y, s);
  s = __fmaf_rn(a.z, b.z, s);
  return __fmaf_rn(a.w, b.w, s);
}

// The row-order cumsum of one head's dA in place (rows [0, rows)).
__device__ __forceinline__ void cumsum_rows(float* cs, int rows) {
  float run = 0.f;
  for (int r = 0; r < rows; ++r) {
    run = __fadd_rn(run, cs[r]);
    cs[r] = run;
  }
}

// ------------------------------------------------------------ y blocks ---

template <typename T, int N>
__device__ void y_block(const Args& a, int bid, unsigned char* smem) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int NP = N / VEC;
  const int rep = a.H / a.G;
  const int nhg = (rep + a.y_heads - 1) / a.y_heads;
  const int tiles = (a.qmax + TQ - 1) / TQ;
  const int per_tile = a.Bt * a.nc * a.G * nhg;
  const int it = tiles - 1 - bid / per_tile;  // the heaviest tiles first
  int r = bid % per_tile;
  const int hg = r % nhg;
  r /= nhg;
  const int g = r % a.G;
  r /= a.G;
  const int c = r % a.nc;
  const int b = r / a.nc;
  const int c0 = c * a.Q;
  const int rows = min(a.Q, a.S - c0);
  const int q0 = it * TQ;
  if (q0 >= rows) return;
  const int h0 = g * rep + hg * a.y_heads;
  const int nh = min(a.y_heads, g * rep + rep - h0);
  const int rend = min(rows, q0 + TQ);  // cs rows this tile reads
  const int qn = rend - q0;             // live query rows of the tile
  const int qs = cs_stride(a.qmax);
  const YSmem<T, N> L(a.qmax, a.y_heads, a.state_in);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  float* dts = reinterpret_cast<float*>(smem + L.dt);
  T* ct = reinterpret_cast<T*>(smem + L.c);
  float* st = reinterpret_cast<float*>(smem + L.st);
  T* bt = reinterpret_cast<T*>(smem + L.xb);  // the B ring, before the heads
  float* xb = reinterpret_cast<float*>(smem + L.xb);
  float* wt = reinterpret_cast<float*>(smem + L.w);
  float* sh = reinterpret_cast<float*>(smem + L.s);
  T* xr = reinterpret_cast<T*>(smem + L.xr);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* bg = static_cast<const T*>(a.b) + b * a.bsb + g * a.bsg +
                static_cast<long long>(c0) * a.bss;
  const T* cg = static_cast<const T*>(a.c) + b * a.csb + g * a.csg +
                static_cast<long long>(c0) * a.css;
  const T* xg = static_cast<const T*>(a.x) + b * a.xsb +
                static_cast<long long>(c0) * a.xss;

  // rows [r0, r0 + 64) of the chunk's B or C into a swizzled tile: C by
  // row / 4 (a thread reads rows 4i..4i+3), B by row (rows 8 apart)
  auto stage_bc = [&](T* dst, const T* src, long long rs, bool vec, int r0,
                      bool by_row) {
    for (int i = tid; i < TQ * NP; i += THREADS) {
      const int row = i / NP, pc = i % NP;
      copy_piece(dst + row * N + piece<NP>(pc, by_row ? row : row >> 2) * VEC,
                 src + static_cast<long long>(r0 + row) * rs + pc * VEC, vec,
                 r0 + row < rows ? VEC : 0);
    }
  };
  const int nkt = it + 1;  // key tiles of this query tile
  const int xslots = a.y_heads * tiles > 1 ? 1 : 0;  // x ring: slot n & 1
  // raw x of item n (head n / nkt, key tile n % nkt): 64 rows of P
  auto stage_x = [&](int n) {
    const int j = n / nkt, kt = n % nkt;
    T* dst = xr + (n & xslots) * TQ * PMAX;
    const T* src = xg + static_cast<long long>(h0 + j) * a.xsh +
                   static_cast<long long>(kt * TQ) * a.xss;
    const int pp = (a.P + VEC - 1) / VEC;
    for (int i = tid; i < TQ * pp; i += THREADS) {
      const int row = i / pp, pc = i % pp;
      copy_piece(dst + row * PMAX + pc * VEC,
                 src + static_cast<long long>(row) * a.xss + pc * VEC, a.xvec,
                 kt * TQ + row < rows ? min(VEC, a.P - pc * VEC) : 0);
    }
  };
  // the state entering this chunk for head h0 + j, (P, N) fp32, swizzled
  // by row / 4
  auto stage_s = [&](int j) {
    const long long head = static_cast<long long>(b) * a.H + h0 + j;
    const float* src =
        c == 0 ? a.init + head * a.P * N
               : a.nw + ((static_cast<long long>(b) * a.nc + c) * a.H + h0 + j) *
                            a.P * N;
    const bool vec = c == 0 ? a.ivec : true;
    constexpr int SP = N / 4;
    for (int i = tid; i < a.P * SP; i += THREADS) {
      const int row = i / SP, pc = i % SP;
      copy_piece(sh + row * N + piece<SP>(pc, row >> 2) * 4,
                 src + row * N + pc * 4, vec, 4);
    }
  };

  stage_bc(ct, cg, a.css, a.cvec, q0, false);
  stage_bc(bt, bg, a.bss, a.bvec, 0, true);
  stage_x(0);
  cp_async_commit();
  const long long doff = b * a.dsb + static_cast<long long>(c0) * a.dss +
                         h0 * a.dsh;
  for (int i = tid; i < rend * nh; i += THREADS) {
    const int rr = i / nh, j = i % nh;
    cs[j * qs + rr] = a.da[doff + rr * a.dss + j * a.dsh];
    dts[j * qs + rr] = a.dt[doff + rr * a.dss + j * a.dsh];
  }

  // 1. the score tile row S[q][k] = C_q·B_k for key tiles 0..it, stored
  //    key-major.  Warp (wq, wk) owns 16 rows by 32 keys; its thread rows
  //    qa..qa+3 and keys kb + 8j.
  const int wq = warp & 3, wk = warp >> 2;
  const int tq = lane >> 3, tk = lane & 7;
  const int qa = 16 * wq + 4 * tq;
  const int kb = 32 * wk + tk;
  for (int jt = 0; jt <= it; ++jt) {
    cp_async_wait<0>();
    __syncthreads();
    if (jt < it) {
      stage_bc(bt + ((jt + 1) & 1) * TQ * N, bg, a.bss, a.bvec, (jt + 1) * TQ,
               true);
      cp_async_commit();
    }
    const T* bs = bt + (jt & 1) * TQ * N;
    const int k0 = jt * TQ;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    const bool dead = (jt == it && 32 * wk > 16 * wq + 15) || 16 * wq >= qn ||
                      k0 + 32 * wk >= rows;
    if (!dead) {
#pragma unroll 2
      for (int e = 0; e < N; e += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = load4(ct + swz<T, N>(qa + i, e, (qa + i) >> 2));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = load4(bs + swz<T, N>(kb + 8 * j, e, kb + 8 * j));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dot4(s[i][j], cv[i], bv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(st + (k0 + kb + 8 * j) * SLD + qa) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    // the diagonal tile leaves warp 4 (rows 0..15, keys 32..63) idle: it
    // sums cs, one lane per head, in row order
    if (jt == it && warp == 4 && lane < nh) cumsum_rows(cs + lane * qs, rend);
  }

  // 2. per head: the weights w = S ∘ exp(cs_q − cs_k) and x̄ of each key
  //    tile, y's intra-chunk chains, then the carried state's term.
  //    Warp (wq, wp) owns 16 rows by 32 columns of P; a thread rows
  //    qa..qa+3 and columns pa..pa+3.
  const bool has_state = c > 0 || a.init != nullptr;
  const int pa = 32 * wk + 4 * tk;
  const bool wlive = 16 * wq < qn;
  const int items = nh * nkt;
  float acc[4][4];
  for (int n = 0; n < items; ++n) {
    const int j = n / nkt, jt = n % nkt, k0 = jt * TQ;
    cp_async_wait<0>();
    __syncthreads();  // St is whole, the B ring is free; x of item n is in
    if (jt == 0 && has_state) stage_s(j);
    if (n + 1 < items) stage_x(n + 1);
    cp_async_commit();
    if (jt == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
    }
    const float* csj = cs + j * qs;
    for (int i = tid; i < TQ * TQ / 4; i += THREADS) {
      const int kk = i >> 4, q4 = (i & 15) * 4;
      const int k = k0 + kk;
      const float4 sv = f4(st + k * SLD + q4);
      float wv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q0 + q4 + e;
        wv[e] = 0.f;
        if (k <= q && q < rend)
          wv[e] = __fmul_rn(e == 0 ? sv.x : e == 1 ? sv.y : e == 2 ? sv.z : sv.w,
                            expf(__fsub_rn(csj[q], csj[k])));
      }
      *reinterpret_cast<float4*>(wt + kk * SLD + q4) =
          make_float4(wv[0], wv[1], wv[2], wv[3]);
    }
    const T* xs = xr + (n & xslots) * TQ * PMAX;
    for (int i = tid; i < TQ * PMAX / 4; i += THREADS) {
      const int kk = i >> 4, p4 = (i & 15) * 4;
      if (p4 >= a.P) continue;
      const int k = k0 + kk;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < rows) {
        const float d = dts[j * qs + k];
        const float4 xv = load4(xs + kk * PMAX + p4);
        v = make_float4(__fmul_rn(xv.x, d), __fmul_rn(xv.y, d),
                        __fmul_rn(xv.z, d), __fmul_rn(xv.w, d));
      }
      *reinterpret_cast<float4*>(xb + kk * PMAX + p4) = v;
    }
    __syncthreads();
    if (wlive) {
      int kend = jt == it ? min(TQ, 16 * wq + 16) : TQ;
      kend = min(kend, rows - k0);
#pragma unroll 4
      for (int kk = 0; kk < kend; ++kk) {
        const float4 w4 = f4(wt + kk * SLD + qa);
        const float4 x4 = f4(xb + kk * PMAX + pa);
        fma4(acc[0], w4.x, x4);
        fma4(acc[1], w4.y, x4);
        fma4(acc[2], w4.z, x4);
        fma4(acc[3], w4.w, x4);
      }
    }
    if (jt != it) continue;
    // the head's rows are summed: add exp(cs_q) (C_q · state[p, :])
    float yo[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) yo[i][jj] = 0.f;
    if (has_state) {
      cp_async_wait<0>();
      __syncthreads();
      if (wlive) {
#pragma unroll 2
        for (int e = 0; e < N; e += 4) {
          float4 cv[4], sv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = load4(ct + swz<T, N>(qa + i, e, (qa + i) >> 2));
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            sv[jj] = f4(sh + swz<float, N>(pa + jj, e, (pa + jj) >> 2));
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              yo[i][jj] = dot4(yo[i][jj], cv[i], sv[jj]);
        }
      }
    }
    if (wlive && pa < a.P) {
      const int h = h0 + j;
      T* y = static_cast<T*>(a.y) +
             (static_cast<long long>(b) * a.S + c0 + q0) * a.H * a.P +
             static_cast<long long>(h) * a.P + pa;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = qa + i;
        if (q >= qn) continue;
        const float eq = expf(csj[q0 + q]);
        float v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          v[jj] = __fadd_rn(acc[i][jj], __fmul_rn(eq, yo[i][jj]));
        T* yr = y + static_cast<long long>(q) * a.H * a.P;
        if (a.P % 4 == 0) {
          store4(yr, make_float4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (pa + jj < a.P) store(yr + jj, v[jj]);
        }
      }
    }
  }
}

// -------------------------------------------------------- state blocks ---

// A state block walks its heads in pairs, which share each stage of B:
// thread (tpg, tn) owns rows 4 tpg .. 4 tpg + 3 of P and columns
// 4 tn + N / 2 * jj (jj = 0, 1, four each) of both heads' states.
template <typename T, int N>
__device__ void state_block(const Args& a, int bid, unsigned char* smem) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int NG = N / 8;  // threads along a row of the state
  const int rep = a.H / a.G;
  const int nhg = (rep + a.s_heads - 1) / a.s_heads;
  int r = bid;
  const int hg = r % nhg;
  r /= nhg;
  const int g = r % a.G;
  r /= a.G;
  const int c = r % a.nc;
  const int b = r / a.nc;
  const int c0 = c * a.Q;
  const int rows = min(a.Q, a.S - c0);
  const int h0 = g * rep + hg * a.s_heads;
  const int nh = min(a.s_heads, g * rep + rep - h0);
  const int qs = cs_stride(a.qmax);
  const SSmem<T, N> L(a.qmax, a.s_heads);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  float* dts = reinterpret_cast<float*>(smem + L.dt);
  float* dk = reinterpret_cast<float*>(smem + L.dk);
  T* xr = reinterpret_cast<T*>(smem + L.xr);
  T* br = reinterpret_cast<T*>(smem + L.br);
  float* xd = reinterpret_cast<float*>(smem + L.xd);
  const int tid = threadIdx.x;

  const T* xg = static_cast<const T*>(a.x) + b * a.xsb +
                static_cast<long long>(c0) * a.xss;
  const T* bg = static_cast<const T*>(a.b) + b * a.bsb + g * a.bsg +
                static_cast<long long>(c0) * a.bss;
  const int kts = (rows + KT - 1) / KT;
  const int items = (nh + 1) / 2 * kts;
  auto stage = [&](int n) {  // heads 2 (n / kts) and the next, stage n % kts
    const int j0 = 2 * (n / kts), k0 = (n % kts) * KT;
    T* xs = xr + (n & 1) * 2 * KT * PMAX;
    T* bs = br + (n & 1) * KT * N;
    constexpr int XP = PMAX / VEC;
    for (int i = tid; i < 2 * KT * XP; i += THREADS) {
      const int e = i / (KT * XP), row = (i / XP) % KT, pc = i % XP;
      const int valid = j0 + e < nh && k0 + row < rows
                            ? max(0, min(VEC, a.P - pc * VEC))
                            : 0;
      copy_piece(xs + (e * KT + row) * PMAX + pc * VEC,
                 xg + static_cast<long long>(h0 + j0 + e) * a.xsh +
                     static_cast<long long>(k0 + row) * a.xss + pc * VEC,
                 a.xvec, valid);
    }
    constexpr int BP = N / VEC;
    for (int i = tid; i < KT * BP; i += THREADS) {
      const int row = i / BP, pc = i % BP;
      copy_piece(bs + row * N + pc * VEC,
                 bg + static_cast<long long>(k0 + row) * a.bss + pc * VEC,
                 a.bvec, k0 + row < rows ? VEC : 0);
    }
  };
  stage(0);
  cp_async_commit();

  const long long doff = b * a.dsb + static_cast<long long>(c0) * a.dss +
                         h0 * a.dsh;
  for (int i = tid; i < rows * nh; i += THREADS) {
    const int rr = i / nh, j = i % nh;
    cs[j * qs + rr] = a.da[doff + rr * a.dss + j * a.dsh];
    dts[j * qs + rr] = a.dt[doff + rr * a.dss + j * a.dsh];
  }
  __syncthreads();
  if (tid < nh) cumsum_rows(cs + tid * qs, rows);  // one lane per head
  __syncthreads();
  for (int i = tid; i < rows * nh; i += THREADS) {
    const int j = i / rows, rr = i % rows;
    dk[j * qs + rr] = expf(__fsub_rn(cs[j * qs + rows - 1], cs[j * qs + rr]));
  }
  if (a.nc > 1 && tid < nh)
    a.dec[(static_cast<long long>(b) * a.nc + c) * a.H + h0 + tid] =
        expf(cs[tid * qs + rows - 1]);

  const int tn = tid % NG, tpg = tid / NG;
  const bool active = tpg < PMAX / 4;
  float acc[2][4][8];
  // one stage of both heads' chains, or of the first alone
  auto stage_fma = [&](const T* bs, int kend, auto both) {
#pragma unroll 2
    for (int kk = 0; kk < kend; ++kk) {
      const float4 b0 = load4(bs + kk * N + 4 * tn);
      const float4 b1 = load4(bs + kk * N + N / 2 + 4 * tn);
#pragma unroll
      for (int e = 0; e < (decltype(both)::value ? 2 : 1); ++e) {
        const float4 x4 = f4(xd + (e * KT + kk) * PMAX + tpg * 4);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* ai = acc[e][i];
          ai[0] = __fmaf_rn(xv[i], b0.x, ai[0]);
          ai[1] = __fmaf_rn(xv[i], b0.y, ai[1]);
          ai[2] = __fmaf_rn(xv[i], b0.z, ai[2]);
          ai[3] = __fmaf_rn(xv[i], b0.w, ai[3]);
          ai[4] = __fmaf_rn(xv[i], b1.x, ai[4]);
          ai[5] = __fmaf_rn(xv[i], b1.y, ai[5]);
          ai[6] = __fmaf_rn(xv[i], b1.z, ai[6]);
          ai[7] = __fmaf_rn(xv[i], b1.w, ai[7]);
        }
      }
    }
  };
  for (int n = 0; n < items; ++n) {
    const int j0 = 2 * (n / kts), k0 = (n % kts) * KT;
    const bool both = j0 + 1 < nh;
    cp_async_wait<0>();
    __syncthreads();
    if (n + 1 < items) stage(n + 1);
    cp_async_commit();
    if (k0 == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[e][i][q] = 0.f;
    }
    // x̄ · exp(cs_last − cs_k) of both heads
    const T* xs = xr + (n & 1) * 2 * KT * PMAX;
    for (int i = tid; i < 2 * KT * PMAX; i += THREADS) {
      const int e = i / (KT * PMAX), kk = (i / PMAX) % KT, k = k0 + kk;
      const int j = j0 + e;
      float v = 0.f;
      if (k < rows && j < nh)
        v = __fmul_rn(__fmul_rn(to_f32(xs[i]), dts[j * qs + k]), dk[j * qs + k]);
      xd[i] = v;
    }
    __syncthreads();
    const T* bs = br + (n & 1) * KT * N;
    if (active) {
      const int kend = min(KT, rows - k0);
      if (both)
        stage_fma(bs, kend, std::true_type{});
      else
        stage_fma(bs, kend, std::false_type{});
    }
    if (k0 + KT < rows || !active) continue;
    // the heads' rows are summed: write nw_c, or with one chunk the final
    // state exp(cs_last) · init + nw
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + e;
      if (j >= nh) break;
      const long long head = static_cast<long long>(b) * a.H + h0 + j;
      const float dl = expf(cs[j * qs + rows - 1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = tpg * 4 + i;
        if (p >= a.P) continue;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = 4 * tn + N / 2 * jj;
          float4 v = make_float4(acc[e][i][4 * jj], acc[e][i][4 * jj + 1],
                                 acc[e][i][4 * jj + 2], acc[e][i][4 * jj + 3]);
          if (a.nc == 1) {
            float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f);
            if (a.init != nullptr) {
              const float* ip = a.init + (head * a.P + p) * N + col;
              s0 = a.ivec ? f4(ip) : make_float4(ip[0], ip[1], ip[2], ip[3]);
            }
            v = make_float4(__fadd_rn(__fmul_rn(dl, s0.x), v.x),
                            __fadd_rn(__fmul_rn(dl, s0.y), v.y),
                            __fadd_rn(__fmul_rn(dl, s0.z), v.z),
                            __fadd_rn(__fmul_rn(dl, s0.w), v.w));
            store4(a.state + (head * a.P + p) * N + col, v);
          } else {
            store4(a.nw + (((static_cast<long long>(b) * a.nc + c) * a.H +
                            h0 + j) * a.P + p) * N + col,
                   v);
          }
        }
      }
    }
  }
}

// Both kinds of block in one launch (one chunk: no carry between them).
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 1) ssd_blocks(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) < a.y_blocks)
    y_block<T, N>(a, blockIdx.x, smem);
  else
    state_block<T, N>(a, blockIdx.x - a.y_blocks, smem);
}

// Each kind alone, with its own registers: two state blocks share an SM.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 2) ssd_state_blocks(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  state_block<T, N>(a, blockIdx.x, smem);
}
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 1) ssd_y_blocks(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  y_block<T, N>(a, blockIdx.x, smem);
}

// The carry: for each (batch, head, p, 4 n) in chunk order, the state
// entering chunk c > 0 over nw_c, then state = exp(cs_last) state + nw_c;
// the final state to `state`.  Eight chunks' loads are issued before their
// updates.
__global__ void __launch_bounds__(THREADS) ssd_carry(Args a, int N) {
  constexpr int CB = 8;
  const long long n4 = N / 4;
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= static_cast<long long>(a.Bt) * a.H * a.P * n4) return;
  const int e = static_cast<int>(i % n4) * 4;
  long long r = i / n4;
  const int p = static_cast<int>(r % a.P);
  r /= a.P;
  const int h = static_cast<int>(r % a.H);
  const int b = static_cast<int>(r / a.H);
  const long long head = static_cast<long long>(b) * a.H + h;
  float* __restrict__ nw = a.nw;
  const float* __restrict__ dec = a.dec;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (a.init != nullptr) {
    const float* ip = a.init + (head * a.P + p) * N + e;
    s = a.ivec ? f4(ip) : make_float4(ip[0], ip[1], ip[2], ip[3]);
  }
  const long long cstride = static_cast<long long>(a.H) * a.P * N;
  float* slot0 = nw + ((static_cast<long long>(b) * a.nc * a.H + h) * a.P + p) * N + e;
  const float* dec0 = dec + static_cast<long long>(b) * a.nc * a.H + h;
  for (int c0 = 0; c0 < a.nc; c0 += CB) {
    float4 v[CB];
    float d[CB];
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      if (c0 + k >= a.nc) break;
      v[k] = f4(slot0 + (c0 + k) * cstride);
      d[k] = dec0[(c0 + k) * a.H];
    }
#pragma unroll
    for (int k = 0; k < CB; ++k) {
      if (c0 + k >= a.nc) break;
      if (c0 + k > 0) store4(slot0 + (c0 + k) * cstride, s);
      s = make_float4(__fadd_rn(__fmul_rn(d[k], s.x), v[k].x),
                      __fadd_rn(__fmul_rn(d[k], s.y), v[k].y),
                      __fadd_rn(__fmul_rn(d[k], s.z), v[k].z),
                      __fadd_rn(__fmul_rn(d[k], s.w), v[k].w));
    }
  }
  store4(a.state + (head * a.P + p) * N + e, s);
}

template <typename Kernel>
cudaError_t allow(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <typename T, int N>
cudaError_t launch(Args a, cudaStream_t stream) {
  static size_t allowed = 0, allowed_s = 0, allowed_y = 0;
  auto kernel = ssd_blocks<T, N>;
  const int rep = a.H / a.G;
  const int tiles = (a.qmax + TQ - 1) / TQ;
  const int y_blocks =
      tiles * a.Bt * a.nc * a.G * ((rep + a.y_heads - 1) / a.y_heads);
  const int s_blocks = a.Bt * a.nc * a.G * ((rep + a.s_heads - 1) / a.s_heads);
  const size_t ybytes = YSmem<T, N>(a.qmax, a.y_heads, a.state_in).total;
  const size_t sbytes = SSmem<T, N>(a.qmax, a.s_heads).total;
  cudaError_t err;
  if (a.nc == 1) {  // no carry: both kinds of block in one launch
    const size_t bytes = ybytes > sbytes ? ybytes : sbytes;
    if ((err = allow(kernel, bytes, allowed)) != cudaSuccess) return err;
    a.y_blocks = y_blocks;
    kernel<<<y_blocks + s_blocks, THREADS, bytes, stream>>>(a);
    return cudaGetLastError();
  }
  if ((err = allow(ssd_state_blocks<T, N>, sbytes, allowed_s)) != cudaSuccess ||
      (err = allow(ssd_y_blocks<T, N>, ybytes, allowed_y)) != cudaSuccess)
    return err;
  ssd_state_blocks<T, N><<<s_blocks, THREADS, sbytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = static_cast<long long>(a.Bt) * a.H * a.P * (N / 4);
  ssd_carry<<<static_cast<unsigned>((n + THREADS - 1) / THREADS), THREADS, 0,
              stream>>>(a, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_y_blocks<T, N><<<y_blocks, THREADS, ybytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(int N, const Args& a, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
bool aligned(const void* p, long long s0, long long s1, long long s2) {
  constexpr long long VEC = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % VEC == 0 &&
         s1 % VEC == 0 && s2 % VEC == 0;
}

}  // namespace

// x (Bt, S, H, P) and B, C (Bt, S, G, N) in x's dtype (float32 or
// bfloat16), contiguous along their last dim, with element strides
// (batch, position, head or group) in `strides` (x, dt / dA, B, C in turn);
// dt and dA = dt·A (Bt, S, H) float32; init (Bt, H, P, N) float32
// contiguous or null; y (Bt, S, H, P) in x's dtype and state (Bt, H, P, N)
// float32, contiguous.  With nc = ceil(S / Q) > 1 chunks, `nw` (Bt, nc, H,
// P, N) and `dec` (Bt, nc, H) are float32 scratch, else null.  N is 16, 32,
// 64 or 128; P <= 64; 1 <= Q <= 256; H % G == 0; S >= 1; `plan` indexes
// PLANS.
extern "C" int ssd_scan(const void* x, const void* dt, const void* da, const void* b,
                        const void* c, const void* init, void* y, void* state,
                        void* nw, void* dec, int Bt, int S, int H, int G, int P,
                        int N, int Q, const long long* strides, int dtype, int plan,
                        void* stream) {
  if (Bt < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 || P > PMAX ||
      Q < 1 || Q > QMAX || plan < 0 || plan >= N_PLANS)
    return cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  if (nc > 1 && (nw == nullptr || dec == nullptr)) return cudaErrorInvalidValue;
  const long long* s = strides;
  const Plan pl = PLANS[plan];
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(da), b, c,
         static_cast<const float*>(init), y, static_cast<float*>(state),
         static_cast<float*>(nw), static_cast<float*>(dec),
         Bt, S, H, G, P, Q, nc, Q < S ? Q : S, init != nullptr || nc > 1,
         s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
         pl.y_heads, pl.s_heads, 0, false, false, false, false};
  const bool bf = dtype == DT_BF16;
  a.xvec = bf ? aligned<__nv_bfloat16>(x, s[0], s[1], s[2])
              : aligned<float>(x, s[0], s[1], s[2]);
  a.bvec = bf ? aligned<__nv_bfloat16>(b, s[6], s[7], s[8])
              : aligned<float>(b, s[6], s[7], s[8]);
  a.cvec = bf ? aligned<__nv_bfloat16>(c, s[9], s[10], s[11])
              : aligned<float>(c, s[9], s[10], s[11]);
  a.ivec = reinterpret_cast<uintptr_t>(init) % 16 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return dispatch_n<float>(N, a, st);
  if (bf) return dispatch_n<__nv_bfloat16>(N, a, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
