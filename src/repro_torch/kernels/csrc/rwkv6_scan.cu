// RWKV6 time-mix scan for prefill: r, k, v [B,T,NH,hd] (f32 or bf16),
// w [B,T,NH,hd] f32 decay in (0, 1), u [NH,hd] f32 bonus, state
// [B,NH,hd,hd] f32 (key x value) -> y [B,T,NH,hd] in r's type and the
// final state in f32:
//
//   y_t[j]   = sum_c r_t[c] * (S[c][j] + u[c] k_t[c] v_t[j])
//   S[c][j] <- w_t[c] S[c][j] + k_t[c] v_t[j]
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py,
// _rwkv6_kernel (called through rwkv6_scan), which runs the chunked form
// in chunks of 64 with the state in VMEM across its sequential grid axis.
//
// What bounds it on the H100: one call does about 4*T*NH*hd^2 operations
// of the recurrence and moves r, k, v, y once (T*NH*hd each, r's type),
// w once (f32) and the state in and out. For rwkv6-3b (NH 40, hd 64,
// T 1024, bf16) that is 0.67 GFLOP against 32 MB: about 20 operations a
// byte, under the card's ~295, so the floor is the bytes (~10 us at
// 3.35 TB/s). Two kernels, chosen by the caller (kernels/rwkv6_scan.py):
//
// rwkv6_chunked: bf16 at hd 64 with 16-byte aligned bases and strides.
// The chunked form on the tensor cores, T/64 steps in order instead of T.
// Per chunk of 64 steps, with Lc[t] the exclusive cumulative sum of
// log2(max(w, 1e-38)) over the chunk (so each decay is one ex2) and
// Bv[m] = Lc[16 m] its value at the four 16-step sub-chunks' boundaries:
//
//   Rt[t] = r_t 2^{Lc[t] - Bv[j(t)]}            Kh[s] = k_s 2^{Bv[i(s)+1] - Lc[s+1]}
//   A[t][s] = Rt[t] . (Kh[s] 2^{Bv[j] - Bv[i+1]})   (sub-chunks i <= j; s < t)
//   y = (Rt 2^{Bv[j]}) S + A V,  A[t][t] = r_t . (u o k_t)
//   S = 2^{Lc[64]} S + (Kh 2^{Lc[64] - Bv[i+1]})^T V
//
// Overflow. Every factor above has an exponent <= 0 (decays are <= 1)
// except the diagonal blocks' k side, 2^{Bv[j] - Lc[s+1]} <= 2^{span_j}
// with span_j = Bv[j] - Bv[j+1] the block's summed -log2 w: the TPU form
// e^{lprev_t} e^{-lcum_s} would overflow f32 once a chunk's summed log
// passes -88, and w <= 1e-3 sums -440 to -880 over 64 steps. A diagonal
// block whose span stays under kSpanMax = 64 in every channel is factored
// like the others (factors within 2^-64..2^64, masked products finite);
// one wider (decays near 0, or w = 0, which the clamp makes 2^-126) is
// computed on the CUDA cores with exact pairwise exponents 2^{Lc[t] -
// Lc[s+1]} <= 1. The model's decays (w0 = -1: w ~ 0.69, span ~ 9) take the
// factored path; underflow to 0 anywhere is exact enough, as the true
// value is smaller still. The factors per (sub-chunk pair, channel) come
// from an 18 x 64 table, so a chunk takes ~13 K exponentials (a log and
// two ex2 an element) where the TPU kernel's [C, C, hd] tensor takes 84 M
// a call at rwkv6-3b's shape.
//
// Grid: (2 value groups of 32 columns, NH, B), 80 blocks at B = 1, one a
// SM (16 warps, 225,616 bytes of shared memory). The value columns of S
// are independent, so each group keeps its [64, 32] slice of S in f32
// mma accumulators across the chunks and nothing of the state goes to
// device memory; the cost is that both groups compute the v-independent
// work (logs, operands, A). Counted against the alternatives: one group
// of 64 columns runs 40 blocks on a third of the SMs, four groups run 160
// blocks on 132 SMs (a second wave); a three-pass split (chunk states,
// state passing, outputs) would write and read 2 x 21 MB of chunk states
// against the 32 MB the function moves. Per chunk, with a barrier between
// them: the next chunk's tiles go in flight (cp.async, double-buffered);
// Lc, the factor table and which diagonal blocks need the exact path;
// the operand pass (Rt, Rd = Rt 2^{Bv[j]}, Kh, the carry's Kd, the bonus;
// the exact diagonal blocks); the A tiles on mma.sync, 20 units of 8
// columns spread over the warps; then y (warp: 16 rows x 8 columns) and
// the carry (16 keys x 8 columns), while the next chunk's logs are taken.
// Every product is mma.sync m16n8k16, bf16 in and f32 accumulation, its
// operands read by ldmatrix from padded rows (no bank conflicts).
//
// Precision. r, k and v are exact in bf16; the decayed operands, A and S
// are f32 values. Each f32 operand is split into hi = bf16(x) and lo =
// bf16(x - hi), and a product of two such is taken as hi hi + hi lo +
// lo hi; the carry's Kd, which feeds the state at its f32 tolerance over
// every chunk, in three terms (all 24 bits). The CPU mirror of this plan
// (tests/test_torch_recurrent_kernels.py, rwkv6_chunked) decided it:
// rounded once, the state misses its tolerance by more than 10x and y its
// own; with two terms for the carry, decays near 1 at T = 1024 (|S| ~ 100)
// came within 0.76 of the state tolerance on the CPU and over it on the
// card, three terms bring it to 0.14.
//
// nvcc -Xptxas -v (CUDA 12.8, sm_90a): rwkv6_chunked 123 registers, no
// spills; its 128-byte stack frame holds the exact diagonal path's 32
// partial sums. rwkv6_fwd: 93 / 155 / 168 registers at hd 32 / 64 / 128,
// no spills.
//
// rwkv6_fwd: everything else (f32, the parity path, exact on the CUDA
// cores; hd 32 and 128; unaligned bf16). Token by token, the classic RWKV
// CUDA form: no exponentials, so nothing can overflow. A block takes kCols
// = 16 value columns of one (batch, head), grid (hd/16, NH, B); kSplit = 4
// neighbouring lanes share a column, each holding hd/4 rows of it in
// registers (rows s, s+4, ...: no bank conflict), their partial y meeting
// through two shuffles; every kT steps the block stages (r, k, w) of its
// head and v of its columns in shared memory. It is held by the latency
// of T steps in order.
//
// Both kernels mask their ragged tail and read their inputs in place by
// their strides.
#include "rwkv6_chunked.cuh"

namespace {

using namespace repro_torch;

constexpr int kSplit = 4;                 // lanes per value column
constexpr int kCols = 16;                 // value columns per block
constexpr int kThreads = kSplit * kCols;  // 64

struct Params {  // strides in elements
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  void* y;
  float* s1;
  int B, T, NH;
  long long srb, srt, srh, skb, skt, skh, svb, svt, svh, swb, swt, swh;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) rwkv6_fwd(const Params p) {
  constexpr int kC = HD / kSplit;             // rows of S per lane
  constexpr int kT = HD >= 128 ? 16 : 32;     // steps staged at once
  __shared__ float4 rkw[kT][HD];              // (r, k, w, unused)
  __shared__ float vs[kT][kCols];

  const int col0 = blockIdx.x * kCols;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int s = tid % kSplit;
  const int jl = tid / kSplit;
  const int j = col0 + jl;

  const long long sbase = ((long long)b * p.NH + h) * HD * HD;
  float S[kC], u[kC];
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    const int c = s + kSplit * i;
    S[i] = p.s0[sbase + (long long)c * HD + j];
    u[i] = p.u[h * HD + c];
  }

  const T* rb = static_cast<const T*>(p.r) + b * p.srb + h * p.srh;
  const T* kb = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* vb = static_cast<const T*>(p.v) + b * p.svb + h * p.svh + col0;
  const float* wb = p.w + b * p.swb + h * p.swh;
  T* yb = static_cast<T*>(p.y) + ((long long)b * p.T * p.NH + h) * HD + j;
  const long long y_step = (long long)p.NH * HD;

  for (int t0 = 0; t0 < p.T; t0 += kT) {
    const int n = min(kT, p.T - t0);
    __syncthreads();  // the previous steps are consumed
    for (int i = tid; i < kT * HD; i += kThreads) {
      const int tt = i / HD, c = i % HD;
      float4 q = make_float4(0.f, 0.f, 1.f, 0.f);
      if (tt < n) {
        const long long t = t0 + tt;
        q.x = to_float(rb[t * p.srt + c]);
        q.y = to_float(kb[t * p.skt + c]);
        q.z = wb[t * p.swt + c];
      }
      rkw[tt][c] = q;
    }
    for (int i = tid; i < kT * kCols; i += kThreads) {
      const int tt = i / kCols, jj = i % kCols;
      vs[tt][jj] = tt < n ? to_float(vb[(long long)(t0 + tt) * p.svt + jj])
                          : 0.f;
    }
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][jl];
      float y0 = 0.f, y1 = 0.f;  // two chains halve the add latency
#pragma unroll
      for (int i = 0; i < kC; i += 2) {
        const float4 a = rkw[tt][s + kSplit * i];
        const float kv0 = a.y * vj;
        y0 = fmaf(a.x, fmaf(u[i], kv0, S[i]), y0);
        S[i] = fmaf(S[i], a.z, kv0);
        const float4 c = rkw[tt][s + kSplit * (i + 1)];
        const float kv1 = c.y * vj;
        y1 = fmaf(c.x, fmaf(u[i + 1], kv1, S[i + 1]), y1);
        S[i + 1] = fmaf(S[i + 1], c.z, kv1);
      }
      float y = y0 + y1;
      y += __shfl_xor_sync(0xffffffffu, y, 1);
      y += __shfl_xor_sync(0xffffffffu, y, 2);
      if (s == 0) store_from_float(yb + (t0 + tt) * y_step, y);
    }
  }

#pragma unroll
  for (int i = 0; i < kC; ++i)
    p.s1[sbase + (long long)(s + kSplit * i) * HD + j] = S[i];
}

template <typename T, int HD>
int launch_step(const Params& p, cudaStream_t stream) {
  const dim3 grid(HD / kCols, p.NH, p.B);
  rwkv6_fwd<T, HD><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_step(int hd, const Params& p, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_step<T, 32>(p, stream);
    case 64: return launch_step<T, 64>(p, stream);
    case 128: return launch_step<T, 128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------------
// chunked kernel: bf16 at hd 64 on the tensor cores (mma.sync)
// ----------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using namespace rwkv6;

constexpr int kGroupCols = 32;     // value columns per block
constexpr int kCWarps = 16;        // warp w: rows of sub-chunk w/4, columns 8 (w%4)..
constexpr int kCThreads = kCWarps * 32;
constexpr int kLdV = kGroupCols + 8;   // bf16 row of v and the state slice
constexpr int kSegs = kCThreads / kHD;            // 8: steps of Lc summed apart
constexpr int kSegLen = kChunk / kSegs;
constexpr int kFacRows = kPairs + 2 * kNSub;       // pairs, carry, inter

// Development switch (chip_smoke.py --rwkv6-ablation): 1 skips the A
// tiles, 2 the operand pass, 3 all products, 4 the logarithms (every
// decay 1); the output is then wrong. 0 in every real build.
#ifndef RWKV6_ABLATE
#define RWKV6_ABLATE 0
#endif
constexpr int kAblate = RWKV6_ABLATE;

// Shared-memory plan (bytes). Two buffers of one chunk's r, k, v (bf16)
// and w (f32); the cumulative log2-decays Lc, the factor table and the
// bonus; the operands the chunk's products read, as bf16 hi and lo (the
// carry's in three terms); the A tiles; two buffers of the state slice.
struct ChunkSmem {
  static constexpr int r = 0;                          // [kChunk][kLd]
  static constexpr int k = r + kChunk * kLd * 2;       // [kChunk][kLd]
  static constexpr int v = k + kChunk * kLd * 2;       // [kChunk][kLdV]
  static constexpr int w = v + kChunk * kLdV * 2;      // [kChunk][kHD] f32
  static constexpr int buf = w + kChunk * kHD * 4;
  static constexpr int lc = 2 * buf;                   // [kChunk+1][kLdL] f32
  static constexpr int tot = lc + (kChunk + 1) * kLdL * 4;  // [2][kSegs][kHD]
  static constexpr int fac = tot + 2 * kSegs * kHD * 4;  // [kFacRows][kHD] f32
  static constexpr int ub = fac + kFacRows * kHD * 4;  // u [kHD] f32
  static constexpr int bonus = ub + kHD * 4;           // [kChunk] f32
  static constexpr int slow = bonus + kChunk * 4;      // [kCWarps] int
  static constexpr int op = kChunk * kLd;              // elements of one term
  static constexpr int rt = slow + kCWarps * 4;        // [hi, lo][kChunk][kLd]
  static constexpr int rd = rt + 2 * op * 2;           // [hi, lo][kChunk][kLd]
  static constexpr int kh = rd + 2 * op * 2;           // [hi, lo][kChunk][kLd]
  static constexpr int kd = kh + 2 * op * 2;           // [hi, mid, lo][kChunk][kLd]
  static constexpr int ax_tile = kSub * kLdD;          // elements of one term
  static constexpr int ax = kd + 3 * op * 2;           // [kPairs][hi, lo][kSub][kLdD]
  static constexpr int s_half = kHD * kLdV;
  static constexpr int s = ax + kPairs * 2 * ax_tile * 2;   // [2][hi, lo][kHD][kLdV]
  static constexpr int bytes = s + 2 * 2 * s_half * 2;
};
static_assert(ChunkSmem::bytes <= 232448, "shared memory plan too large");
static_assert(ChunkSmem::rt % 16 == 0, "16-byte aligned operands");

__global__ void __launch_bounds__(kCThreads, 1) rwkv6_chunked(const Params p) {
  using SM = ChunkSmem;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int col0 = blockIdx.x * kGroupCols, h = blockIdx.y, b = blockIdx.z;
  const int nc = (p.T + kChunk - 1) / kChunk;

  const bf16* rg = static_cast<const bf16*>(p.r) + b * p.srb + h * p.srh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.skb + h * p.skh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.svb + h * p.svh + col0;
  const float* wg = p.w + b * p.swb + h * p.swh;
  bf16* yg = static_cast<bf16*>(p.y) + ((long long)b * p.T * p.NH + h) * kHD +
             col0;
  const long long y_row = (long long)p.NH * kHD;   // y is contiguous

  // chunk c's r, k, v and w tiles into buffer `bi` (asynchronously)
  auto load_tiles = [&](int c, int bi) {
    unsigned char* base = smem + bi * SM::buf;
    const int t0 = c * kChunk;
    for (int i = tid; i < kChunk * 8; i += kCThreads) {   // r, k: 8 x 16 B a row
      const int row = i >> 3, e = (i & 7) * 8;
      const bool ok = t0 + row < p.T;
      const long long t = ok ? t0 + row : 0;
      copy16(base + SM::r + (row * kLd + e) * 2, rg + t * p.srt + e, ok);
      copy16(base + SM::k + (row * kLd + e) * 2, kg + t * p.skt + e, ok);
    }
    for (int i = tid; i < kChunk * 4; i += kCThreads) {   // v: 4 x 16 B
      const int row = i >> 2, e = (i & 3) * 8;
      const bool ok = t0 + row < p.T;
      const long long t = ok ? t0 + row : 0;
      copy16(base + SM::v + (row * kLdV + e) * 2, vg + t * p.svt + e, ok);
    }
    for (int i = tid; i < kChunk * 16; i += kCThreads) {  // w: 16 x 16 B
      const int row = i >> 4, e = (i & 15) * 4;
      const bool ok = t0 + row < p.T;
      const long long t = ok ? t0 + row : 0;
      copy16(base + SM::w + (row * kHD + e) * 4, wg + t * p.swt + e, ok);
    }
    cp_async_commit();
  };

  float* Lc = reinterpret_cast<float*>(smem + SM::lc);   // Lc[t] = lprev_t
  float* tot = reinterpret_cast<float*>(smem + SM::tot);
  float* fac = reinterpret_cast<float*>(smem + SM::fac);
  float* ub = reinterpret_cast<float*>(smem + SM::ub);
  float* bonus = reinterpret_cast<float*>(smem + SM::bonus);
  int* slow = reinterpret_cast<int*>(smem + SM::slow);
  bf16* RtH = reinterpret_cast<bf16*>(smem + SM::rt);
  bf16* RdH = reinterpret_cast<bf16*>(smem + SM::rd);
  bf16* KhH = reinterpret_cast<bf16*>(smem + SM::kh);
  bf16* KdH = reinterpret_cast<bf16*>(smem + SM::kd);
  bf16* Ax = reinterpret_cast<bf16*>(smem + SM::ax);

  // warp (j, nq): rows 16 j.. of the chunk (y), rows 16 j.. of S (keys),
  // value columns 8 nq.. of the block's 32
  const int j = warp >> 2;
  const int n0 = (warp & 3) * 8;
  float S[4];   // S[key 16 j + g (+8)][value n0 + 2 tq (+1)]
  auto store_state = [&](int sb) {
    bf16* hi = reinterpret_cast<bf16*>(smem + SM::s) + sb * 2 * SM::s_half;
    bf16* lo = hi + SM::s_half;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int off = (j * kSub + g + 8 * rr) * kLdV + n0 + 2 * tq;
      uint32_t vh, vl;
      split2(S[2 * rr], S[2 * rr + 1], vh, vl);
      *reinterpret_cast<uint32_t*>(hi + off) = vh;
      *reinterpret_cast<uint32_t*>(lo + off) = vl;
    }
  };
  auto slow_block = [&](int jj) {   // its 4 warps' votes
    return (slow[4 * jj] | slow[4 * jj + 1] | slow[4 * jj + 2] |
            slow[4 * jj + 3]) != 0;
  };
  {
    const float* s0 = p.s0 + ((long long)b * p.NH + h) * kHD * kHD + col0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      S[e] = s0[(j * kSub + g + 8 * (e >> 1)) * kHD + n0 + 2 * tq + (e & 1)];
    store_state(0);
  }
  if (tid < kHD) ub[tid] = p.u[h * kHD + tid];

  // ---- 1. Lc: cumulative log2(max(w, 1e-38)) over a chunk, per channel
  // (steps past T decay by 1), in two halves. p1a: each thread's
  // kSegLen steps of one channel, summed into run[] and their total into
  // tot; it runs for chunk c+1 beside chunk c's products. p1b: the
  // offsets, Lc, the boundaries Bv[m] = Lc[16 m], the factor table, and
  // which diagonal blocks need exact exponents ----
  const int ch = tid & (kHD - 1), qq = tid >> 6;   // kSegLen steps each
  float run[kSegLen];
  auto p1a = [&](int c, int bi) {
    const float* Ws = reinterpret_cast<const float*>(smem + bi * SM::buf +
                                                     SM::w);
    float acc = 0.f;
#pragma unroll
    for (int tt = 0; tt < kSegLen; ++tt) {
      const int t = qq * kSegLen + tt;
      const float lw = c * kChunk + t < p.T && kAblate != 4
                           ? log2_decay(Ws[t * kHD + ch])
                           : 0.f;
      acc += lw;
      run[tt] = acc;
    }
    tot[(bi * kSegs + qq) * kHD + ch] = acc;
  };
  auto p1b = [&](int bi) {
    float pre[kSegs + 1], bv[kNSub + 1];
    pre[0] = 0.f;
#pragma unroll
    for (int q = 0; q < kSegs; ++q)
      pre[q + 1] = pre[q] + tot[(bi * kSegs + q) * kHD + ch];
#pragma unroll
    for (int m = 0; m <= kNSub; ++m) bv[m] = pre[m * kSub / kSegLen];
    const float off = pick(pre, qq);
#pragma unroll
    for (int tt = 0; tt < kSegLen; ++tt)
      Lc[(qq * kSegLen + tt + 1) * kLdL + ch] = run[tt] + off;
    if (qq == 0) Lc[ch] = 0.f;
    // fac rows: pairs (i, j): 2^{Bv[j] - Bv[i+1]}; carry (i):
    // 2^{Bv[4] - Bv[i+1]}; inter (j): 2^{Bv[j]}
    for (int row = qq; row < kFacRows; row += kSegs) {
      int hi_m, lo_m;
      if (row < kPairs) {
        const int jj = row >= pair(0, 3) ? 3 : row >= pair(0, 2) ? 2
                       : row >= pair(0, 1) ? 1 : 0;
        hi_m = jj;
        lo_m = row - pair(0, jj) + 1;
      } else if (row < kPairs + kNSub) {
        hi_m = kNSub;
        lo_m = row - kPairs + 1;
      } else {
        hi_m = row - kPairs - kNSub;
        lo_m = 0;
      }
      fac[row * kHD + ch] = fast_exp2(pick(bv, hi_m) - pick(bv, lo_m));
    }
    // a diagonal block whose k side would pass 2^kSpanMax goes exact
    const int jb = qq * kSegLen / kSub;
    const bool wide = pick(bv, jb) - pick(bv, jb + 1) > kSpanMax;
    const bool any = __any_sync(0xffffffffu, wide);
    if (lane == 0) slow[warp] = any;
  };

  if (nc > 0) {
    load_tiles(0, 0);
    cp_async_wait_all();
    __syncthreads();
    p1a(0, 0);
  }

  for (int c = 0; c < nc; ++c) {
    const int bi = c & 1;
    const unsigned char* base = smem + bi * SM::buf;
    const bf16* Rs = reinterpret_cast<const bf16*>(base + SM::r);
    const bf16* Ks = reinterpret_cast<const bf16*>(base + SM::k);
    const bf16* Vs = reinterpret_cast<const bf16*>(base + SM::v);
    const int t0 = c * kChunk;
    __syncthreads();   // chunk c, its tot and S(c) in place; chunk c-1 done
    if (c + 1 < nc) load_tiles(c + 1, bi ^ 1);
    p1b(bi);
    __syncthreads();

    // ---- 2a. operands, 8 channels an item, as bf16 hi + lo:
    //   Rt[t] = r_t 2^{Lc[t] - Bv[j(t)]}          (and the bonus r_t . (u o k_t))
    //   Kh[s] = k_s 2^{Bv[i(s)+1] - Lc[s+1]}
    //   Kd[s] = Kh[s] 2^{Bv[4] - Bv[i(s)+1]}      (carry, hi + mid + lo)
    // every exponent <= 0. Items go to lanes so that each 8 lanes read
    // two rows of Lc at 4 column offsets: with rows of 68 floats, their
    // 16-byte loads fall in 32 different banks ----
    if (kAblate != 2) {
      // item i (of 512 per side): row 2 (i >> 4) + ((i >> 2) & 1), columns e..
      auto item = [](int i, int& row, int& e) {
        row = 2 * (i >> 4) + ((i >> 2) & 1);
        e = ((i & 3) + 4 * ((i >> 3) & 1)) * 8;
      };
#pragma unroll
      for (int m = 0; m < kChunk * 8 / kCThreads; ++m) {   // r rows
        int row, e;
        item(tid + m * kCThreads, row, e);
        float x[8], lx[8], lb[8], kx[8], uu[8], f[8];
        unpack8(*reinterpret_cast<const uint4*>(Rs + row * kLd + e), x);
        load8(Lc + row * kLdL + e, lx);
        load8(Lc + (row / kSub) * kSub * kLdL + e, lb);
        unpack8(*reinterpret_cast<const uint4*>(Ks + row * kLd + e), kx);
        load8(ub + e, uu);
        float bon = 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          f[q] = x[q] * fast_exp2(lx[q] - lb[q]);
          bon = fmaf(x[q] * uu[q], kx[q], bon);
        }
        // the 8 items of a row: lanes that differ in bits 0, 1 and 3
        bon += __shfl_xor_sync(0xffffffffu, bon, 1);
        bon += __shfl_xor_sync(0xffffffffu, bon, 2);
        bon += __shfl_xor_sync(0xffffffffu, bon, 8);
        if ((lane & 0xb) == 0) bonus[row] = bon;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split2(f[2 * q], f[2 * q + 1], hi[q], lo[q]);
        *reinterpret_cast<uint4*>(RtH + row * kLd + e) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(RtH + SM::op + row * kLd + e) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
        // Rd = (hi + lo of Rt) 2^{Bv[j]}: the inter product's operand
        float fr[8];
        load8(fac + (kPairs + kNSub + row / kSub) * kHD + e, fr);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 a = unpack(hi[q]), b = unpack(lo[q]);
          split2((a.x + b.x) * fr[2 * q], (a.y + b.y) * fr[2 * q + 1], hi[q],
                 lo[q]);
        }
        *reinterpret_cast<uint4*>(RdH + row * kLd + e) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(RdH + SM::op + row * kLd + e) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
#pragma unroll
      for (int m = 0; m < kChunk * 8 / kCThreads; ++m) {   // k rows
        int row, e;
        item(tid + m * kCThreads, row, e);
        const int blk = row / kSub;
        float x[8], lx[8], lb[8], fd[8], f[8];
        unpack8(*reinterpret_cast<const uint4*>(Ks + row * kLd + e), x);
        load8(Lc + (row + 1) * kLdL + e, lx);
        load8(Lc + (blk + 1) * kSub * kLdL + e, lb);
        load8(fac + (kPairs + blk) * kHD + e, fd);
#pragma unroll
        for (int q = 0; q < 8; ++q) f[q] = x[q] * fast_exp2(lb[q] - lx[q]);
        uint32_t hi[4], mid[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split2(f[2 * q], f[2 * q + 1], hi[q], lo[q]);
        *reinterpret_cast<uint4*>(KhH + row * kLd + e) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(KhH + SM::op + row * kLd + e) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split3(f[2 * q] * fd[2 * q], f[2 * q + 1] * fd[2 * q + 1], hi[q],
                 mid[q], lo[q]);
        *reinterpret_cast<uint4*>(KdH + row * kLd + e) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(KdH + SM::op + row * kLd + e) =
            make_uint4(mid[0], mid[1], mid[2], mid[3]);
        *reinterpret_cast<uint4*>(KdH + 2 * SM::op + row * kLd + e) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }

    // ---- 2b. diagonal blocks that are too wide to factor, on the CUDA
    // cores with exact pairwise exponents: A[t][s] = sum_c r_t k_s
    // 2^{Lc[t] - Lc[s+1]} (s < t), A[t][t] = r_t . (u o k_t), 0 above.
    // Thread: sub-chunk tid / 64, rows ta = i8 and tb = 15 - i8 of it (15
    // pairs together), channels 8 dq ..; the 8 dq lanes meet by shuffles ----
    const int jd = tid >> 6;   // threads 0..255: one sub-chunk a 64
    if (kAblate != 1 && tid < kNSub * 64 && slow_block(jd))
      exact_diag_a(tid, Rs, Ks, Lc, ub, Ax);
    __syncthreads();   // operands, table, bonus and exact blocks in place

    if (kAblate != 3) {
      // ---- 3a. the A tiles on mma.sync, spread over the warps: unit u
      // is columns 8 (u % 2).. of pair u / 2 = (i, j), for u = warp and
      // warp + 16. A[t][s] = Rt[t] . (Kh[s] F), F = fac[pair];
      // both f32: hi hi + hi lo + lo hi, even and odd k steps in two
      // accumulators. The diagonal tile is masked to s < t and takes the
      // bonus on s = t ----
      for (int u = warp; u < 2 * kPairs && kAblate != 1; u += kCWarps) {
        const int jj = pair_j(u >> 1);
        if (u >> 1 == pair(jj, jj) && slow_block(jj)) continue;   // written in 2b
        a_tile_unit(u, lane, RtH, KhH, fac, bonus, Ax);
      }
      cp_async_wait_all();   // chunk c+1's tiles: read by p1a after 3c
      __syncthreads();       // every A tile in place

      // ---- 3b. y = Rd S + sum_i A_ij V_i, columns n0.. ----
      const bf16* Sh = reinterpret_cast<const bf16*>(smem + SM::s) +
                       bi * 2 * SM::s_half;
      const bf16* Sl = Sh + SM::s_half;
      float Y[4] = {}, Ya[4] = {};   // inter and intra: two chains
#pragma unroll
      for (int kk = 0; kk < kHD / 16; ++kk) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        const int aoff = (j * kSub + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8;
        ldsm_x4(ah, RdH + aoff);
        ldsm_x4(al, RdH + SM::op + aoff);
        const int boff = (kk * 16 + (lane & 15)) * kLdV + n0;
        ldsm_x2_t(bh, Sh + boff);
        ldsm_x2_t(bl, Sl + boff);
        mma16816(Y, ah, bh[0], bh[1]);
        mma16816(Y, ah, bl[0], bl[1]);
        mma16816(Y, al, bh[0], bh[1]);
      }
      for (int i = 0; i <= j; ++i) {
        const bf16* AH = Ax + pair(i, j) * 2 * SM::ax_tile;
        uint32_t ph[4], pl[4], bv[2];
        const int aoff = (lane & 15) * kLdD + (lane >> 4) * 8;
        ldsm_x4(ph, AH + aoff);
        ldsm_x4(pl, AH + SM::ax_tile + aoff);
        ldsm_x2_t(bv, Vs + (i * kSub + (lane & 15)) * kLdV + n0);
        mma16816(Ya, ph, bv[0], bv[1]);
        mma16816(Ya, pl, bv[0], bv[1]);
      }
      // store the valid rows of y
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int t = j * kSub + g + 8 * rr;
        if (t0 + t < p.T)
          *reinterpret_cast<__nv_bfloat162*>(
              yg + (long long)(t0 + t) * y_row + n0 + 2 * tq) =
              __floats2bfloat162_rn(Y[2 * rr] + Ya[2 * rr],
                                    Y[2 * rr + 1] + Ya[2 * rr + 1]);
      }

      // ---- 3c. carry: S = diag(2^{Lc[64]}) S + Kd^T V (keys 16 j..,
      // Kd: hi + mid + lo; even and odd k steps in two chains) ----
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float dec = fast_exp2(Lc[kChunk * kLdL + j * kSub + g + 8 * rr]);
        S[2 * rr] *= dec;
        S[2 * rr + 1] *= dec;
      }
      float S2[4] = {};
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        float (&acc)[4] = kk & 1 ? S2 : S;
        uint32_t ah[4], am[4], al[4], bv[2];
        const int aoff = (kk * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                         j * kSub + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(ah, KdH + aoff);
        ldsm_x4_t(am, KdH + SM::op + aoff);
        ldsm_x4_t(al, KdH + 2 * SM::op + aoff);
        ldsm_x2_t(bv, Vs + (kk * 16 + (lane & 15)) * kLdV + n0);
        mma16816(acc, al, bv[0], bv[1]);
        mma16816(acc, am, bv[0], bv[1]);
        mma16816(acc, ah, bv[0], bv[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) S[e] += S2[e];
      store_state(bi ^ 1);
    }
    if (c + 1 < nc) p1a(c + 1, bi ^ 1);
  }

  float* s1 = p.s1 + ((long long)b * p.NH + h) * kHD * kHD + col0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    s1[(j * kSub + g + 8 * (e >> 1)) * kHD + n0 + 2 * tq + (e & 1)] = S[e];
}

int launch_chunked(const Params& p, cudaStream_t stream) {
  constexpr int smem = ChunkSmem::bytes;
  static bool attr_set = false;   // once per process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_chunked, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid(kHD / kGroupCols, p.NH, p.B);
  rwkv6_chunked<<<grid, kCThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// kernel: 0 = the step kernel rwkv6_fwd (f32 or bf16, hd 32, 64 or 128),
// 1 = the chunked kernel rwkv6_chunked (bf16, hd 64, 16-byte aligned
// bases and strides of r, k, v and w); the caller picks, and a choice the
// kernel does not take returns cudaErrorInvalidValue. dtype (of r, k, v
// and y): 0 = float32, 1 = bfloat16. w, u and the states are float32; u
// [NH,hd], s0 and s1 [B,NH,hd,hd] and y [B,T,NH,hd] are contiguous; r,
// k, v, w are read by their strides (in elements, unit-stride last dim).
// Returns cudaGetLastError() after the launch.
extern "C" int rwkv6_scan_fwd(int kernel, int dtype, int hd, const void* r,
                              const void* k, const void* v, const void* w,
                              const void* u, const void* s0, void* y,
                              void* s1, int B, int T, int NH, long long srb,
                              long long srt, long long srh, long long skb,
                              long long skt, long long skh, long long svb,
                              long long svt, long long svh, long long swb,
                              long long swt, long long swh, void* stream) {
  Params p;
  p.r = r; p.k = k; p.v = v;
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.y = y;
  p.s1 = static_cast<float*>(s1);
  p.B = B; p.T = T; p.NH = NH;
  p.srb = srb; p.srt = srt; p.srh = srh;
  p.skb = skb; p.skt = skt; p.skh = skh;
  p.svb = svb; p.svt = svt; p.svh = svh;
  p.swb = swb; p.swt = swt; p.swh = swh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel == 1) {
    const bool ok = dtype == 1 && hd == kHD &&
                    aligned16(r, 2, srb, srt, srh) &&
                    aligned16(k, 2, skb, skt, skh) &&
                    aligned16(v, 2, svb, svt, svh) &&
                    aligned16(w, 4, swb, swt, swh);
    return ok ? launch_chunked(p, st) : (int)cudaErrorInvalidValue;
  }
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_step<float>(hd, p, st);
  if (dtype == 1) return dispatch_step<bf16>(hd, p, st);
  return (int)cudaErrorInvalidValue;
}
