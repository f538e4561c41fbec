// The RWKV6 scan's backward: the gradients of the function that
// kernels/ref.py::rwkv6_scan_ref computes,
//
//   y_t[j]  = sum_c r_t[c] (S_t[c][j] + u[c] k_t[c] v_t[j])
//   S_{t+1} = diag(w_t) S_t + k_t v_t^T,   S_0 = state, S_T the final state
//
// for r, k, v [B,T,NH,hd] (f32 or bf16), w [B,T,NH,hd] f32, u [NH,hd],
// state [B,NH,hd,hd] f32, given dy [B,T,NH,hd] (r's type) and the final
// state's gradient ds [B,NH,hd,hd] f32. With G = dL/dS_{t+1} (G_T = ds),
// each step t from T-1 down to 0 gives
//
//   dk_t[c] = sum_j G[c][j] v_t[j] + u[c] r_t[c] (v_t . dy_t)
//   dr_t[c] = sum_j S_t[c][j] dy_t[j] + u[c] k_t[c] (v_t . dy_t)
//   dw_t[c] = sum_j G[c][j] S_t[c][j]
//   dv_t[j] = sum_c G[c][j] k_t[c] + (sum_c r_t[c] u[c] k_t[c]) dy_t[j]
//   du[c]  += r_t[c] k_t[c] (v_t . dy_t)          (summed over b and t)
//   G[c][j] <- w_t[c] G[c][j] + r_t[c] dy_t[j]    (d state = G_0)
//
// in f32 for both input types; dr, dk, dv are written in r's type. Every
// decay is a plain product, no log and no exponential, so w = 0 and w = 1
// are exact, as in the plain function.
//
// There is no Pallas backward to replace: the reference trains through
// jax.value_and_grad over src/repro/kernels/ref.py::rwkv6_scan_ref.
//
// What bounds it on the H100: per (step, c, j) the gradient takes the
// state S_t, G's update and the four sums, 12 operations; one call at
// rwkv6-3b's training shape ([2,1024,40,64], bf16) is 4.0 GFLOP against
// 119 MB (r, k, v, dy and the three gradients in bf16, w and dw in f32,
// the states): 34 operations a byte, under the card's ~295, so the floor
// is the bytes (0.036 ms at 3.35 TB/s). Two routes, chosen by the
// caller (kernels/rwkv6_scan.py, backward_kernel_for) as the forward's:
//
//   - bf16 at hd 64 with r, k, v, w and dy on 16-byte aligned bases and
//     strides (rwkv6-3b's training shape): the chunked form on the
//     tensor cores, rwkv6_bwd_deltas + rwkv6_bwd_scan + rwkv6_bwd_chunk +
//     rwkv6_bwd_du (below);
//   - f32 (the parity path, exact on the CUDA cores), hd 32 and 128, and
//     unaligned bf16: the step kernel rwkv6_bwd + rwkv6_bwd_du, described
//     first. Its steps run in order, on the CUDA cores.
//
// The step kernel. Layout. One block per (batch, head), 4 hd threads: thread (c, q) owns
// row c of G (and of S) and the columns 16 m + 4 q + e (m < hd/16, e <
// 4), so each of its float4 words sits beside its neighbour lanes'. A row
// of G evolves on its own (diag(w) acts per row), so G stays in registers
// for the whole call and every sum stays inside the block: dk, dw and dr
// are sums along a row (each lane's columns in order, then the row's 4
// lanes by an xor butterfly); dv is a sum down the columns (a halving
// exchange over a warp's 8 rows, 14 shuffles for 16 values, then the
// warps' partial sums in order, through shared memory); du is summed per
// (b, h) in a register, over t in reverse, then over b in order by a
// second small launch. No atomics: two calls give the same bits.
//
// The walk needs S_t in reverse order. A first sweep runs the recurrence
// forward and writes the state at the start of every sub-chunk of kL
// steps to a scratch tensor [B, NH, ceil(T/kL), hd, hd] f32; then, sub-
// chunk by sub-chunk in reverse, the block recomputes the sub-chunk's
// states from the kept one into shared memory (kL hd^2 floats, 128 KB:
// kL = 8 at hd 64, 32 at hd 32, 2 at hd 128), each thread its own values,
// and walks its steps backwards. At the training shape the scratch is 168
// MB, written once and read once (0.10 ms of the card's bandwidth); the
// alternatives cost more: keeping a state every 64 steps and recomputing
// each sub-chunk from its chunk's start does 4.5x the forward work at hd
// 64, and one more level of kept states does not fit beside 128 KB of
// steps. Per sub-chunk: its r, k, w, v, dy go from registers (loaded
// while the previous sub-chunk ran) into shared memory as f32; one warp a
// step takes v . dy and r . (u o k); the next sub-chunk's start state is
// copied into a spare slot with cp.async during the walk.
//
// The chunked route runs the forward's chunked form (rwkv6_scan.cu,
// rwkv6_chunked) backwards, in chunks of Q = 64 steps and sub-chunks of
// 16. With Lc[t] the exclusive cumulative sum of log2(max(w, 1e-38))
// over the chunk (the forward's series, log2_decay), Bv[m] = Lc[16 m],
// F_ij = 2^{Bv[j] - Bv[i+1]} for sub-chunks i <= j,
//
//   Rt[t] = r_t 2^{Lc[t] - Bv[j(t)]}     Kh[s] = k_s 2^{Bv[i(s)+1] - Lc[s+1]}
//   Kd[s] = k_s 2^{Lc[Q] - Lc[s+1]}      Rd[t] = r_t 2^{Lc[t]}
//
// A the forward's intra-chunk matrix (A[t][s] = Rt[t] . (Kh[s] F_ij) for
// s < t, the bonus r_t . (u o k_t) on its diagonal), S0 the state at the
// chunk's start, S_Q at its end and G = dL/dS_Q:
//
//   dV  = A^T dY + Kd G
//   dA  = (dY V^T) o strict-tril
//   dR' = 2^{Lc[t]} (dY S0^T) + 2^{Lc[t] - Bv[j]} sum_{i<=j} F_ij (dA_ji Kh_i)
//   dK' = 2^{Lc[Q] - Lc[s+1]} (V G^T) + 2^{Bv[i+1] - Lc[s+1]} sum_{j>=i} F_ij (dA_ji^T Rt_j)
//   dR  = dR' + u o k (v . dy),   dK = dK' + u o r (v . dy)
//   w dw_tau = <G, S_Q>_row + sum_{t > tau} r_t o dR'_t - sum_{s >= tau} k_s o dK'_s
//   du += sum_t r_t o k_t (v_t . dy_t)
//   G at the chunk's start = 2^{Lc[Q]} G + Rd^T dY   (d state: chunk 0's)
//
// (w dw is the derivative by log w: every factor 2^{Lc[t]} with t > tau
// holds w_tau once.) F_ij multiplies the products' columns, exactly in
// f32, and every exponent is <= 0 except F_jj = 2^{span_j} of a diagonal
// block; as in the forward, a diagonal block whose span passes kSpanMax
// = 64 in some channel takes exact pairwise exponents 2^{Lc[t] -
// Lc[s+1]} on the CUDA cores, in A, dR' and dK'. Steps past T decay by
// 1 and carry no input, as the forward's.
//
// dw without dividing by a small w. (w dw) / w loses what the bf16 hi +
// lo operands leave of w dw's cancellation: the CPU mirror
// (tests/test_torch_rwkv6_chunked_backward.py), every dw by division,
// gives 2.5e-5 of the largest dw at decays in [0.45, 0.95], 1.3e-4 to
// 2.4e-4 in [0.05, 0.2], 7.4e-4 to 9.9e-4 in [1e-3, 1e-2] and 0.26 to
// 0.86 in [1e-6, 1e-3] (0/0 at w = 0). So a (chunk, channel) with a decay
// under kWMin = 1/16 takes dw_tau = <G_{tau+1}, S_tau>_row from the step
// recurrences of its row alone (S forward from S0's row, G back from G's
// row, a warp a row), which neither divide nor exponentiate; the model's
// decays (~0.69) rarely send a row there, near 0 sends every row.
//
// Four launches, no atomics (two calls give the same bits):
// rwkv6_bwd_deltas, one block per (chunk, b, h, direction), 8 warps:
// the chunk's term of S's carry, Kd^T V, or of G's, Rd^T dY, in f32 mma
// accumulators (the operand in three bf16 terms, as the forward's carry
// needed), and its decay 2^{Lc[Q]}; rwkv6_bwd_scan, a thread an element
// pair of a (b, h)'s state: S <- 2^{Lc[Q]} S + term over the chunks in
// order, G the same in reverse, each kept at every chunk boundary as bf16
// hi + lo planes (22 MB each at the training shape, against the step
// kernel's 168 MB of f32 states; the terms, 42 MB of f32, are written
// and read once); rwkv6_bwd_chunk, one block per (b, h, chunk), 16 warps,
// 1,280 blocks at the training shape: its r, k, v, dy, w and both planes
// come in by cp.async; the logs, the factor table and the operands (Rt,
// Kh, Kd as bf16 hi + lo); the A and dA tiles on mma.sync; then warp (i,
// n) the 16 rows of sub-chunk i and 16 columns of dV, dR and dK (every
// f32 operand split hi + lo, a product taken as hi hi + hi lo + lo hi),
// and the chunk's w dw by a reverse sum over the steps, the exact rows,
// and its share of du; rwkv6_bwd_du adds du's shares over (b, chunk) in
// order. The carries run as a per-chunk pass and a scan, not as 2 B NH
// blocks walking the chunks in order: walking, each chunk's loads, logs
// and products ran behind three barriers with one block an SM, 0.113 ms
// a call at the training shape; as two launches, 0.092 ms (measured on
// the card, `--rwkv6-backward-ablation`).
//
// nvcc -Xptxas -v (CUDA 12.8, sm_90a): rwkv6_bwd 112 registers at hd 64
// (f32 and bf16), 128 at hd 128 (the cap at 512 threads), 180 (f32) and
// 210 (bf16) at hd 32, no spills; rwkv6_bwd_du 32; rwkv6_bwd_chunk 128
// (the cap at 512 threads), 40 bytes spilled, a 272-byte stack (the
// exact diagonal A blocks' 32 sums and the call of exact_row, which
// spills 100 bytes of its own); rwkv6_bwd_deltas 56; rwkv6_bwd_scan 32.
#include "rwkv6_chunked.cuh"

namespace {

using namespace repro_torch;

constexpr int kLanes = 4;            // threads a row of G
constexpr int kHistBytes = 131072;   // the states of one sub-chunk's steps
constexpr int kArrays = 5;           // staged per step: r, k, w, v, dy
enum { kR = 0, kK = 1, kW = 2, kV = 3, kDy = 4 };
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* x[kArrays];   // r, k, w, v, dy [B,T,NH,hd], by strides
  long long sb[kArrays], st[kArrays], sh[kArrays];   // in elements
  const float* u;           // [NH, hd]
  const float* s0;          // [B, NH, hd, hd]
  const float* ds;          // [B, NH, hd, hd]: d(final state)
  void* dr;                 // [B, T, NH, hd] contiguous, r's type
  void* dk;
  void* dv;
  float* dw;                // [B, T, NH, hd] contiguous
  float* du_part;           // [B, NH, hd]
  float* du;                // [NH, hd]
  float* ds0;               // [B, NH, hd, hd]: d state
  float4* scratch;          // [B, NH, nsc, hd * hd / 4], thread-slot order
  int B, T, NH, nsc;
};

template <int HD>
struct Plan {
  static constexpr int kThreads = kLanes * HD;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kCols = HD / kLanes;   // columns a thread
  static constexpr int kVec = kCols / 4;      // its float4 words
  static constexpr int kL = kHistBytes / (HD * HD * 4);   // sub-chunk steps
  static constexpr int kState = HD * HD / 4;  // float4 words of a state
  // shared memory, in floats
  static constexpr int hist = 0;              // [kL + 1][kVec][kThreads] float4
  static constexpr int stage = hist + (kL + 1) * HD * HD;  // [kArrays][kL][HD]
  static constexpr int ub = stage + kArrays * kL * HD;     // u [HD]
  static constexpr int vdy = ub + HD;                      // [kL]
  static constexpr int bon = vdy + kL;                     // [kL]
  static constexpr int col = bon + kL;                     // [kL][kWarps][HD]
  static constexpr int outs = col + kL * kWarps * HD;      // dk, dr, dw [3][kL][HD]
  static constexpr int bytes = (outs + 3 * kL * HD) * 4;
  static_assert(kCols % 8 == 0, "the halving exchange needs 8 | columns");
  static_assert(bytes <= 232448, "shared memory plan too large");
};

// Arrays [A0, A1) of one sub-chunk's steps, read by their strides and
// widened to f32 in registers (load), then written to the stage (store);
// steps past T are 0 and never read.
template <typename T, int HD, int A0, int A1>
struct Stager {
  using P = Plan<HD>;
  static constexpr int kN = P::kL * HD;                  // elements an array
  static constexpr int kPer = (kN + P::kThreads - 1) / P::kThreads;
  float x[A1 - A0][kPer];

  __device__ __forceinline__ void load(const Params& p, int b, int h,
                                       int t0) {
#pragma unroll
    for (int a = A0; a < A1; ++a)
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const int e = threadIdx.x + n * P::kThreads;
        const int t = t0 + e / HD;
        float val = 0.f;
        if (e < kN && t < p.T) {
          const long long off = b * p.sb[a] + t * p.st[a] + h * p.sh[a] +
                                e % HD;
          val = a == kW ? static_cast<const float*>(p.x[a])[off]
                        : to_float(static_cast<const T*>(p.x[a])[off]);
        }
        x[a - A0][n] = val;
      }
  }
  __device__ __forceinline__ void store(float* stage) const {
#pragma unroll
    for (int a = A0; a < A1; ++a)
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const int e = threadIdx.x + n * P::kThreads;
        if (e < kN) stage[a * kN + e] = x[a - A0][n];
      }
  }
};

// One half of x[0, 2N) stays in the lane and is summed with the partner
// lane's (lane ^ Off) copy of it: the lower half where `upper` is false.
template <int N, int Off, int Cap>
__device__ __forceinline__ void halve(float (&x)[Cap], bool upper) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float keep = upper ? x[i + N] : x[i];
    const float send = upper ? x[i] : x[i + N];
    x[i] = keep + __shfl_xor_sync(kFull, send, Off);
  }
}

// S <- diag(w_s) S + k_s v_s^T on the thread's columns of row c
template <int HD>
__device__ __forceinline__ void advance(float (&S)[HD / kLanes],
                                        const float* stage, int s, int c,
                                        int q) {
  using P = Plan<HD>;
  const float kc = stage[(kK * P::kL + s) * HD + c];
  const float wc = stage[(kW * P::kL + s) * HD + c];
  const float* vrow = stage + (kV * P::kL + s) * HD + 4 * q;
#pragma unroll
  for (int m = 0; m < P::kVec; ++m) {
    const float4 v4 = *reinterpret_cast<const float4*>(vrow + 16 * m);
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      S[4 * m + e] = fmaf(S[4 * m + e], wc, kc * vv[e]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Plan<HD>::kThreads, 1)
    rwkv6_bwd(const Params p) {
  using P = Plan<HD>;
  constexpr int NT = P::kThreads, NC = P::kCols, NV = P::kVec, L = P::kL;
  extern __shared__ __align__(16) float smem[];
  float4* hist = reinterpret_cast<float4*>(smem + P::hist);
  float* stage = smem + P::stage;
  float* ub = smem + P::ub;
  float* vdy = smem + P::vdy;
  float* bon = smem + P::bon;
  float* col = smem + P::col;
  float* outs = smem + P::outs;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = tid & (kLanes - 1), c = tid / kLanes;
  const int cb = (lane >> 2) & 7;             // row within the warp
  const int h = blockIdx.x, b = blockIdx.y;
  const long long bh = (long long)b * p.NH + h;
  const int nsc = p.nsc;
  float4* scratch = p.scratch + bh * nsc * P::kState + tid;
  const long long row = (bh * HD + c) * HD + 4 * q;   // [b][h][c][4 q]
  if (tid < HD) ub[tid] = p.u[h * HD + tid];

  // ---- 1. sweep: S forward, its value at each sub-chunk's start kept ----
  float S[NC];
#pragma unroll
  for (int m = 0; m < NV; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[4 * m + e] = p.s0[row + 16 * m + e];
  {
    Stager<T, HD, kK, kV + 1> sw;             // k, w, v
    if (nsc > 1) sw.load(p, b, h, 0);
    for (int sc = 0; sc < nsc; ++sc) {
#pragma unroll
      for (int m = 0; m < NV; ++m)
        scratch[(long long)sc * P::kState + m * NT] =
            make_float4(S[4 * m], S[4 * m + 1], S[4 * m + 2], S[4 * m + 3]);
      if (sc == nsc - 1) break;
      __syncthreads();                        // the last sub-chunk is consumed
      sw.store(stage);
      __syncthreads();
      if (sc + 2 < nsc) sw.load(p, b, h, (sc + 1) * L);
      for (int s = 0; s < L; ++s) advance<HD>(S, stage, s, c, q);
    }
  }
  __threadfence();                            // the kept states, before cp.async

  // ---- 2. the walk, sub-chunk by sub-chunk in reverse ----
  float G[NC];
#pragma unroll
  for (int m = 0; m < NV; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) G[4 * m + e] = p.ds[row + 16 * m + e];
  float du_acc = 0.f;
  float4* slot = hist + L * NV * NT + tid;    // the next start state
#pragma unroll
  for (int m = 0; m < NV; ++m)
    copy16(slot + m * NT, scratch + (long long)(nsc - 1) * P::kState + m * NT,
           true);
  cp_async_commit();
  Stager<T, HD, kR, kDy + 1> st;
  st.load(p, b, h, (nsc - 1) * L);

  for (int sc = nsc - 1; sc >= 0; --sc) {
    const int t0 = sc * L, n = min(L, p.T - t0);
    __syncthreads();                          // the last epilogue is done
    st.store(stage);
    __syncthreads();
    // v_s . dy_s and r_s . (u o k_s): warp w takes steps w, w + kWarps, ..
    for (int s = warp; s < n; s += P::kWarps) {
      float a = 0.f, bo = 0.f;
      for (int j = lane; j < HD; j += 32) {
        a = fmaf(stage[(kV * L + s) * HD + j], stage[(kDy * L + s) * HD + j],
                 a);
        bo = fmaf(stage[(kR * L + s) * HD + j] * ub[j],
                  stage[(kK * L + s) * HD + j], bo);
      }
      a = warp_sum(a);
      bo = warp_sum(bo);
      if (lane == 0) {
        vdy[s] = a;
        bon[s] = bo;
      }
    }
    if (sc > 0) st.load(p, b, h, t0 - L);    // in flight over this one

    // recompute S_{t0} .. S_{t0+n-1} into hist, each thread its own values
    cp_async_wait_all();
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const float4 s4 = slot[m * NT];
      S[4 * m] = s4.x;
      S[4 * m + 1] = s4.y;
      S[4 * m + 2] = s4.z;
      S[4 * m + 3] = s4.w;
    }
    for (int s = 0; s < n; ++s) {
#pragma unroll
      for (int m = 0; m < NV; ++m)
        hist[(s * NV + m) * NT + tid] =
            make_float4(S[4 * m], S[4 * m + 1], S[4 * m + 2], S[4 * m + 3]);
      advance<HD>(S, stage, s, c, q);
    }
    if (sc > 0) {                             // the slot's values are used
#pragma unroll
      for (int m = 0; m < NV; ++m)
        copy16(slot + m * NT,
               scratch + (long long)(sc - 1) * P::kState + m * NT, true);
      cp_async_commit();
    }
    __syncthreads();                          // vdy and bon in place

    for (int s = n - 1; s >= 0; --s) {
      const float rc = stage[(kR * L + s) * HD + c];
      const float kc = stage[(kK * L + s) * HD + c];
      const float wc = stage[(kW * L + s) * HD + c];
      const float uc = ub[c], vd = vdy[s];
      const float* vrow = stage + (kV * L + s) * HD + 4 * q;
      const float* dyrow = stage + (kDy * L + s) * HD + 4 * q;
      float dkp = 0.f, dwp = 0.f, drp = 0.f, colv[NC];
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const float4 s4 = hist[(s * NV + m) * NT + tid];
        const float4 v4 = *reinterpret_cast<const float4*>(vrow + 16 * m);
        const float4 d4 = *reinterpret_cast<const float4*>(dyrow + 16 * m);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
        const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * m + e;
          const float g = G[i];
          dkp = fmaf(g, vv[e], dkp);
          dwp = fmaf(g, sv[e], dwp);
          drp = fmaf(sv[e], dd[e], drp);
          colv[i] = g * kc;
          G[i] = fmaf(g, wc, rc * dd[e]);
        }
      }
      // along the row: its 4 lanes
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1) {
        dkp += __shfl_xor_sync(kFull, dkp, off);
        dwp += __shfl_xor_sync(kFull, dwp, off);
        drp += __shfl_xor_sync(kFull, drp, off);
      }
      if (q == 0) outs[s * HD + c] = fmaf(uc * rc, vd, dkp);
      if (q == 1) outs[(L + s) * HD + c] = fmaf(uc * kc, vd, drp);
      if (q == 2) outs[(2 * L + s) * HD + c] = dwp;
      du_acc = fmaf(rc * kc, vd, du_acc);
      // down the columns: the warp's 8 rows by halving, then the warps
      halve<NC / 2, 16>(colv, cb & 4);
      halve<NC / 4, 8>(colv, cb & 2);
      halve<NC / 8, 4>(colv, cb & 1);
      const int i0 = ((cb >> 2) & 1) * (NC / 2) + ((cb >> 1) & 1) * (NC / 4) +
                     (cb & 1) * (NC / 8);
      float* crow = col + (s * P::kWarps + warp) * HD;
#pragma unroll
      for (int e = 0; e < NC / 8; ++e) {
        const int i = i0 + e;
        crow[16 * (i >> 2) + 4 * q + (i & 3)] = colv[e];
      }
    }
    __syncthreads();                          // outs and col in place

    // epilogue: dv from the warps' column sums, and the four outputs
    for (int e = tid; e < n * HD; e += NT) {
      const int s = e / HD, j = e % HD;
      const float* cs = col + s * P::kWarps * HD + j;
      float acc = cs[0];
#pragma unroll
      for (int w = 1; w < P::kWarps; ++w) acc += cs[w * HD];
      acc = fmaf(bon[s], stage[(kDy * L + s) * HD + j], acc);
      const long long o =
          (((long long)b * p.T + t0 + s) * p.NH + h) * HD + j;
      store_from_float(static_cast<T*>(p.dv) + o, acc);
      store_from_float(static_cast<T*>(p.dk) + o, outs[s * HD + j]);
      store_from_float(static_cast<T*>(p.dr) + o, outs[(L + s) * HD + j]);
      p.dw[o] = outs[(2 * L + s) * HD + j];
    }
  }

#pragma unroll
  for (int m = 0; m < NV; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) p.ds0[row + 16 * m + e] = G[4 * m + e];
  if (q == 0) p.du_part[bh * HD + c] = du_acc;
}

// du[h][c] = sum over b, in order, of each (b, h)'s share
__global__ void rwkv6_bwd_du(const float* du_part, float* du, int B, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // h * hd + c
  if (i >= n) return;
  float acc = du_part[i];
  for (int b = 1; b < B; ++b) acc += du_part[(long long)b * n + i];
  du[i] = acc;
}

template <typename T, int HD>
int launch(Params p, cudaStream_t stream) {
  using P = Plan<HD>;
  static bool attr_set = false;   // once per process and instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_bwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P::bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  p.nsc = (p.T + P::kL - 1) / P::kL;
  rwkv6_bwd<T, HD><<<dim3(p.NH, p.B), P::kThreads, P::bytes, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = p.NH * HD;
  rwkv6_bwd_du<<<(n + 255) / 256, 256, 0, stream>>>(p.du_part, p.du, p.B, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const Params& p, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------------
// chunked backward: bf16 at hd 64 on the tensor cores (mma.sync)
// ----------------------------------------------------------------------
using bf16 = __nv_bfloat16;

using namespace rwkv6;

constexpr int kQ = kChunk;         // steps per chunk
constexpr int kTile = kOp;         // elements of one [64][kLd] tile
constexpr int kCThreads = 512;     // rwkv6_bwd_chunk: 16 warps
constexpr int kSegs = kCThreads / kHD;   // 8: steps of Lc summed apart
constexpr int kSegLen = kQ / kSegs;
constexpr float kWMin = 0.0625f;   // under it a row's dw comes from its recurrence

// Development switch (chip_smoke.py --rwkv6-backward-ablation): 1 skips
// the carries' two launches, 2 the A and dA tiles, 3 the products of dV,
// dR and dK, 4 the dw pass (its reverse sum and the exact rows), 5 the
// stores of dr, dk and dv, 6 the exact rows alone; the output is then
// wrong. 0 in every real build.
#ifndef RWKV6_BWD_ABLATE
#define RWKV6_BWD_ABLATE 0
#endif
constexpr int kAblate = RWKV6_BWD_ABLATE;

struct CParams {   // strides in elements
  const bf16* r;
  const bf16* k;
  const bf16* v;
  const bf16* dy;
  const float* w;
  const float* u;
  const float* s0;
  const float* ds;
  long long srb, srt, srh, skb, skt, skh, svb, svt, svh, swb, swt, swh, sdb,
      sdt, sdh;
  bf16* sp;          // S at each chunk boundary [B][NH][nc+1][hi, lo][64][64]
  bf16* gp;          // G at each chunk boundary, the same (boundary 0 unused)
  float* delta;      // each chunk's carry term [B][NH][2][nc][64][64]
  float* dec;        // and its decay [B][NH][2][nc][64]
  bf16* dr;          // [B, T, NH, 64] contiguous
  bf16* dk;
  bf16* dv;
  float* dw;
  float* du_part;    // [B][nc][NH][64]
  float* du;         // [NH][64]
  float* ds0;        // [B][NH][64][64]
  int B, T, NH, nc;
};

__device__ __forceinline__ long long plane_at(const CParams& p, int b, int h,
                                              int bnd) {
  return (((long long)b * p.NH + h) * (p.nc + 1) + bnd) * 2 * kHD * kHD;
}

// ---- launches 1 and 2: S at every chunk boundary, and G ----
// Launch 1, one block per (chunk, h, b, direction), 8 warps: the chunk's
// contribution to the carry, Delta = Kd^T V (S's, direction 0) or Rd^T dY
// (G's, direction 1) in f32 mma accumulators (warp w: keys 16 (w / 2)..,
// values 32 (w % 2)..; the operand in three bf16 terms, as the forward's
// carry), and its decay 2^{Lc[Q]} a key. Launch 2 runs the carries from
// them, an element pair a thread: S <- 2^{Lc[Q]} S + Delta over the
// chunks in order from the initial state, G the same in reverse from
// d(final state), each kept at every boundary as bf16 hi + lo planes; d
// state = G at chunk 0's start.
struct DeltaSmem {   // bytes
  static constexpr int x = 0;                          // [kQ][kLd] bf16: k or r
  static constexpr int y = x + kTile * 2;              // [kQ][kLd] bf16: v or dy
  static constexpr int w = y + kTile * 2;              // [kQ][kHD] f32
  static constexpr int op = w + kQ * kHD * 4;          // [hi, mid, lo][kQ][kLd]
  static constexpr int tot = op + 3 * kTile * 2;       // [4][kHD] f32
  static constexpr int bytes = tot + 4 * kHD * 4;
};

// [B][NH][2][nc] chunks' deltas ([64][64] f32) and decays ([64] f32)
__device__ __forceinline__ long long delta_at(const CParams& p, int b, int h,
                                              int dir, int c) {
  return ((((long long)b * p.NH + h) * 2 + dir) * p.nc + c);
}

__global__ void __launch_bounds__(256, 3) rwkv6_bwd_deltas(const CParams p) {
  using DS = DeltaSmem;
  extern __shared__ __align__(128) unsigned char cmem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z >> 1;
  const bool rev = blockIdx.z & 1;
  const int t0 = c * kQ;
  const bf16* xg = rev ? p.r + b * p.srb + h * p.srh : p.k + b * p.skb + h * p.skh;
  const long long sxt = rev ? p.srt : p.skt;
  const bf16* yg = rev ? p.dy + b * p.sdb + h * p.sdh : p.v + b * p.svb + h * p.svh;
  const long long syt = rev ? p.sdt : p.svt;
  const float* wg = p.w + b * p.swb + h * p.swh;
  bf16* Xs = reinterpret_cast<bf16*>(cmem + DS::x);
  bf16* Ys = reinterpret_cast<bf16*>(cmem + DS::y);
  float* Ws = reinterpret_cast<float*>(cmem + DS::w);
  bf16* OpH = reinterpret_cast<bf16*>(cmem + DS::op);
  float* tot = reinterpret_cast<float*>(cmem + DS::tot);

  for (int i = tid; i < kQ * 8; i += 256) {   // x, y: 8 x 16 B a row
    const int row = i >> 3, e = (i & 7) * 8;
    const bool ok = t0 + row < p.T;
    const long long t = ok ? t0 + row : 0;
    copy16(Xs + row * kLd + e, xg + t * sxt + e, ok);
    copy16(Ys + row * kLd + e, yg + t * syt + e, ok);
  }
  for (int i = tid; i < kQ * 16; i += 256) {  // w: 16 x 16 B
    const int row = i >> 4, e = (i & 15) * 4;
    const bool ok = t0 + row < p.T;
    const long long t = ok ? t0 + row : 0;
    copy16(Ws + row * kHD + e, wg + t * p.swt + e, ok);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // Lc by channel: thread (ch, q) its 16 steps (past T: 0), then the
  // segments' offsets
  const int ch = tid & (kHD - 1), q = tid >> 6;
  float run[16];
  {
    float acc = 0.f;
#pragma unroll
    for (int tt = 0; tt < 16; ++tt) {
      const int s = 16 * q + tt;
      acc += t0 + s < p.T ? log2_decay(Ws[s * kHD + ch]) : 0.f;
      run[tt] = acc;
    }
    tot[q * kHD + ch] = acc;
  }
  __syncthreads();
  float off = 0.f, LQ = 0.f;
#pragma unroll
  for (int qq = 0; qq < 4; ++qq) {
    const float t = tot[qq * kHD + ch];
    off += qq < q ? t : 0.f;
    LQ += t;
  }
  const long long at = delta_at(p, b, h, rev, c);
  if (q == 0) p.dec[at * kHD + ch] = fast_exp2(LQ);
  // the operand, three bf16 terms: Kd[s] = k_s 2^{Lc[Q] - Lc[s+1]}, or
  // Rd[t] = r_t 2^{Lc[t]} (exponents <= 0)
#pragma unroll
  for (int tt = 0; tt < 16; ++tt) {
    const int s = 16 * q + tt;
    const float ex = rev ? off + (tt ? run[tt - 1] : 0.f) : LQ - (off + run[tt]);
    const float x = __bfloat162float(Xs[s * kLd + ch]) * fast_exp2(ex);
    const bf16 hi = __float2bfloat16(x);
    const float r1 = x - __bfloat162float(hi);
    const bf16 mid = __float2bfloat16(r1);
    OpH[s * kLd + ch] = hi;
    OpH[kTile + s * kLd + ch] = mid;
    OpH[2 * kTile + s * kLd + ch] = __float2bfloat16(r1 - __bfloat162float(mid));
  }
  __syncthreads();

  const int m0 = (warp >> 1) * 16, n0 = (warp & 1) * 32;
  float D[4][4] = {};   // D[nt][e]: key m0 + g (+8), value n0 + 8 nt + 2 tq (+1)
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    uint32_t ah[4], am[4], al[4];
    const int aoff = (kk * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + m0 +
                     ((lane >> 3) & 1) * 8;
    ldsm_x4_t(ah, OpH + aoff);
    ldsm_x4_t(am, OpH + kTile + aoff);
    ldsm_x4_t(al, OpH + 2 * kTile + aoff);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bv[4];
      ldsm_x4_t(bv, Ys + (kk * 16 + (lane & 15)) * kLd + n0 + 16 * np +
                        (lane >> 4) * 8);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float (&acc)[4] = D[2 * np + hf];
        mma16816(acc, al, bv[2 * hf], bv[2 * hf + 1]);
        mma16816(acc, am, bv[2 * hf], bv[2 * hf + 1]);
        mma16816(acc, ah, bv[2 * hf], bv[2 * hf + 1]);
      }
    }
  }
  float* out = p.delta + at * kHD * kHD;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<float2*>(out + (m0 + g + 8 * rr) * kHD + n0 + 8 * nt + 2 * tq) =
          make_float2(D[nt][2 * rr], D[nt][2 * rr + 1]);
}

// Launch 2: thread i of (b, h, direction) takes the element pair (row, 2
// col ..) of the 64 x 64 state over the chunks
__global__ void __launch_bounds__(256) rwkv6_bwd_scan(const CParams p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int pairs = kHD * kHD / 2;
  if (i >= (long long)p.B * p.NH * 2 * pairs) return;
  const int e = (int)(i % pairs);
  const long long bhd = i / pairs;
  const int dir = (int)(bhd & 1);
  const long long bh = bhd >> 1;
  const int row = e / (kHD / 2), col = 2 * (e % (kHD / 2));
  const int off = row * kHD + col;
  const float* init = (dir ? p.ds : p.s0) + bh * kHD * kHD;
  float2 S = *reinterpret_cast<const float2*>(init + off);
  bf16* planes = (dir ? p.gp : p.sp) + bh * (p.nc + 1) * 2 * kHD * kHD;
  auto store = [&](int bnd) {
    uint32_t hi, lo;
    split2(S.x, S.y, hi, lo);
    bf16* pl = planes + (long long)bnd * 2 * kHD * kHD + off;
    *reinterpret_cast<uint32_t*>(pl) = hi;
    *reinterpret_cast<uint32_t*>(pl + kHD * kHD) = lo;
  };
  const long long base = bhd * p.nc;   // delta_at(b, h, dir, 0)
  for (int n = 0; n < p.nc; ++n) {
    const int c = dir ? p.nc - 1 - n : n;
    store(dir ? c + 1 : c);
    const float d = p.dec[(base + c) * kHD + row];
    const float2 x = *reinterpret_cast<const float2*>(p.delta + (base + c) * kHD * kHD + off);
    S.x = fmaf(d, S.x, x.x);
    S.y = fmaf(d, S.y, x.y);
  }
  if (!dir) {
    store(p.nc);
  } else {
    *reinterpret_cast<float2*>(p.ds0 + bh * kHD * kHD + off) = S;
  }
}

// ---- launch 3: one block per (b, h, chunk) ----
// Shared-memory plan (bytes): the chunk's r, k, v, dy; S0 and G as bf16
// hi + lo; Lc, the factor table, the per-step and per-channel scalars;
// the operands Rt, Kh, Kd as bf16 hi + lo (after the products: E and k o
// dK' in f32, for dw); the A and dA tiles as bf16 hi + lo.
struct ChunkSmem {
  static constexpr int tile = kTile * 2;
  static constexpr int r = 0;
  static constexpr int k = r + tile;
  static constexpr int v = k + tile;
  static constexpr int dy = v + tile;
  static constexpr int s0 = dy + tile;                  // [hi, lo][64][kLd]
  static constexpr int gq = s0 + 2 * tile;              // [hi, lo][64][kLd]
  static constexpr int lc = gq + 2 * tile;              // [kQ+1][kLdL] f32
  static constexpr int fac = lc + (kQ + 1) * kLdL * 4;  // [kPairs][kHD] f32
  static constexpr int tot = fac + kPairs * kHD * 4;    // [kSegs][kHD] f32
  static constexpr int dup = tot + kSegs * kHD * 4;     // [kSegs][kHD] f32
  static constexpr int small = dup + kSegs * kHD * 4;   // [kSegs][kHD] int
  static constexpr int ub = small + kSegs * kHD * 4;    // [kHD] f32
  static constexpr int bonus = ub + kHD * 4;            // [kQ] f32
  static constexpr int vdy = bonus + kQ * 4;            // [kQ] f32
  static constexpr int gs = vdy + kQ * 4;               // [kHD] f32
  static constexpr int exrow = gs + kHD * 4;            // [kHD] int
  static constexpr int slow = exrow + kHD * 4;          // [16] int
  static constexpr int w = slow + 16 * 4;               // [kQ][kHD] f32
  static constexpr int rt = w + kQ * kHD * 4;           // [hi, lo][64][kLd]
  static constexpr int kh = rt + 2 * tile;
  static constexpr int kd = kh + 2 * tile;
  static constexpr int ax = kd + 2 * tile;              // [kPairs][hi, lo][16][kLdD]
  static constexpr int dax = ax + kPairs * 2 * kDTile * 2;
  static constexpr int bytes = dax + kPairs * 2 * kDTile * 2;
  static constexpr int e = rt;                          // [kQ][kLdL] f32
  static constexpr int bq = e + kQ * kLdL * 4;          // [kQ][kLdL] f32
};
static_assert(ChunkSmem::bytes <= 232448, "shared memory plan too large");
static_assert(ChunkSmem::bq + kQ * kLdL * 4 <= ChunkSmem::ax, "E over the operands");
static_assert(ChunkSmem::rt % 16 == 0 && ChunkSmem::ax % 16 == 0, "16-byte aligned");
static_assert(3 * (DeltaSmem::bytes + 1024) <= 233472, "three delta blocks an SM");

// dw of one row c of a (b, h, chunk) exactly, from its step recurrences
// (for a row with a decay under kWMin): lane the values 2 lane, 2 lane +
// 1; S forward from S0's row (kept every 16 steps), then per 16 steps in
// reverse, their S_tau again and G back from G's row: dw_tau = <G_{tau+1},
// S_tau>_row, G_tau = w_tau G_{tau+1} + r_tau dy_tau; the 16 steps' lane
// sums meet by a halving exchange (16 shuffles). Not inlined: its
// registers would crowd the products' (spills, at a cost of ~0.04 ms a
// call at the training shape, measured).
__device__ __noinline__ void exact_row(int row, int lane, int t0, int T,
                                       const float* Ws, const bf16* Rs,
                                       const bf16* Ks, const bf16* Vs,
                                       const bf16* DYs, const bf16* S0H,
                                       const bf16* GH, float* dw,
                                       long long o_row) {
  auto decay = [&](int t) { return t0 + t < T ? Ws[t * kHD + row] : 1.f; };
  auto pair_of = [&](const bf16* base) {
    const float2 x = unpack(*reinterpret_cast<const uint32_t*>(base + row * kLd + 2 * lane));
    const float2 y = unpack(*reinterpret_cast<const uint32_t*>(base + kTile + row * kLd + 2 * lane));
    return make_float2(x.x + y.x, x.y + y.y);
  };
  auto advance = [&](float2& st, int t) {
    const float wv = decay(t), kc = __bfloat162float(Ks[t * kLd + row]);
    const float2 vv = unpack(*reinterpret_cast<const uint32_t*>(Vs + t * kLd + 2 * lane));
    st.x = fmaf(st.x, wv, kc * vv.x);
    st.y = fmaf(st.y, wv, kc * vv.y);
  };
  float2 s = pair_of(S0H), gg = pair_of(GH);
  float2 ck[kNSub];
#pragma unroll
  for (int m = 0; m < kNSub; ++m) {
    ck[m] = s;
    for (int tt = 0; tt < kSub; ++tt) advance(s, m * kSub + tt);
  }
#pragma unroll
  for (int m = kNSub - 1; m >= 0; --m) {
    float2 hist[kSub];
    float pd[kSub];
    s = ck[m];
#pragma unroll
    for (int tt = 0; tt < kSub; ++tt) {
      hist[tt] = s;
      advance(s, m * kSub + tt);
    }
#pragma unroll
    for (int tt = kSub - 1; tt >= 0; --tt) {
      const int t = m * kSub + tt;
      pd[tt] = fmaf(gg.x, hist[tt].x, gg.y * hist[tt].y);
      const float wv = decay(t), rc = __bfloat162float(Rs[t * kLd + row]);
      const float2 dd = unpack(*reinterpret_cast<const uint32_t*>(DYs + t * kLd + 2 * lane));
      gg.x = fmaf(gg.x, wv, rc * dd.x);
      gg.y = fmaf(gg.y, wv, rc * dd.y);
    }
    halve<8, 16>(pd, lane & 16);
    halve<4, 8>(pd, lane & 8);
    halve<2, 4>(pd, lane & 4);
    halve<1, 2>(pd, lane & 2);
    const float d = pd[0] + __shfl_xor_sync(0xffffffffu, pd[0], 1);
    const int t = m * kSub + ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                  ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
    if ((lane & 1) == 0 && t0 + t < T) dw[t * o_row] = d;
  }
}

__global__ void __launch_bounds__(kCThreads, 1) rwkv6_bwd_chunk(const CParams p) {
  using SM = ChunkSmem;
  extern __shared__ __align__(128) unsigned char cmem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kQ;

  bf16* Rs = reinterpret_cast<bf16*>(cmem + SM::r);
  bf16* Ks = reinterpret_cast<bf16*>(cmem + SM::k);
  bf16* Vs = reinterpret_cast<bf16*>(cmem + SM::v);
  bf16* DYs = reinterpret_cast<bf16*>(cmem + SM::dy);
  bf16* S0H = reinterpret_cast<bf16*>(cmem + SM::s0);
  bf16* GH = reinterpret_cast<bf16*>(cmem + SM::gq);
  float* Lc = reinterpret_cast<float*>(cmem + SM::lc);
  float* fac = reinterpret_cast<float*>(cmem + SM::fac);
  float* tot = reinterpret_cast<float*>(cmem + SM::tot);
  float* dup = reinterpret_cast<float*>(cmem + SM::dup);
  int* small = reinterpret_cast<int*>(cmem + SM::small);
  float* ub = reinterpret_cast<float*>(cmem + SM::ub);
  float* bonus = reinterpret_cast<float*>(cmem + SM::bonus);
  float* vdy = reinterpret_cast<float*>(cmem + SM::vdy);
  float* gs = reinterpret_cast<float*>(cmem + SM::gs);
  int* exrow = reinterpret_cast<int*>(cmem + SM::exrow);
  int* slow = reinterpret_cast<int*>(cmem + SM::slow);
  float* Ws = reinterpret_cast<float*>(cmem + SM::w);
  bf16* RtH = reinterpret_cast<bf16*>(cmem + SM::rt);
  bf16* KhH = reinterpret_cast<bf16*>(cmem + SM::kh);
  bf16* KdH = reinterpret_cast<bf16*>(cmem + SM::kd);
  bf16* Ax = reinterpret_cast<bf16*>(cmem + SM::ax);
  bf16* DAx = reinterpret_cast<bf16*>(cmem + SM::dax);
  float* Es = reinterpret_cast<float*>(cmem + SM::e);
  float* Bq = reinterpret_cast<float*>(cmem + SM::bq);

  // ---- 0. the chunk's tiles, both planes and w in flight, and S_Q's
  // rows for <G, S_Q>
  uint4 sq_hi, sq_lo;
  {
    const int row = tid >> 3, e = (tid & 7) * 8;   // 64 rows x 8 pieces
    const bool ok = t0 + row < p.T;
    const long long t = ok ? t0 + row : 0;
    copy16(Rs + row * kLd + e, p.r + b * p.srb + h * p.srh + t * p.srt + e, ok);
    copy16(Ks + row * kLd + e, p.k + b * p.skb + h * p.skh + t * p.skt + e, ok);
    copy16(Vs + row * kLd + e, p.v + b * p.svb + h * p.svh + t * p.svt + e, ok);
    copy16(DYs + row * kLd + e, p.dy + b * p.sdb + h * p.sdh + t * p.sdt + e, ok);
    const bf16* sp = p.sp + plane_at(p, b, h, c) + row * kHD + e;
    const bf16* gp = p.gp + plane_at(p, b, h, c + 1) + row * kHD + e;
    copy16(S0H + row * kLd + e, sp, true);
    copy16(S0H + kTile + row * kLd + e, sp + kHD * kHD, true);
    copy16(GH + row * kLd + e, gp, true);
    copy16(GH + kTile + row * kLd + e, gp + kHD * kHD, true);
    const float* wp = p.w + b * p.swb + h * p.swh + t * p.swt + e;
    copy16(Ws + row * kHD + e, wp, ok);           // w: 16 x 16 B a row
    copy16(Ws + row * kHD + e + 4, wp + 4, ok);
    cp_async_commit();
    // S_Q's row `row`, values e..e+7, in flight for <G, S_Q>_row
    const bf16* sq = p.sp + plane_at(p, b, h, c + 1) + row * kHD + e;
    sq_hi = *reinterpret_cast<const uint4*>(sq);
    sq_lo = *reinterpret_cast<const uint4*>(sq + kHD * kHD);
  }
  if (tid < kHD) ub[tid] = p.u[h * kHD + tid];

  // ---- 1a. log2 decays: thread (ch, qq) sums kSegLen steps of one
  // channel (past T: 0); a decay under kWMin flags the channel's row
  const int ch = tid & (kHD - 1), qq = tid >> 6;
  const float* wrow = p.w + b * p.swb + h * p.swh + ch;
  float run[kSegLen];
  {
    float acc = 0.f;
    int sm = 0;
#pragma unroll
    for (int tt = 0; tt < kSegLen; ++tt) {
      const int t = t0 + qq * kSegLen + tt;
      const float wv = t < p.T ? wrow[(long long)t * p.swt] : 1.f;
      sm |= wv < kWMin;
      acc += log2_decay(wv);
      run[tt] = acc;
    }
    tot[qq * kHD + ch] = acc;
    small[qq * kHD + ch] = sm;
  }
  cp_async_wait_all();
  __syncthreads();
  {   // <G, S_Q>_row: 8 threads a row, 8 values each
    const int row = tid >> 3, e = (tid & 7) * 8;
    float sh[8], sl[8], gh[8], gl[8];
    unpack8(sq_hi, sh);
    unpack8(sq_lo, sl);
    unpack8(*reinterpret_cast<const uint4*>(GH + row * kLd + e), gh);
    unpack8(*reinterpret_cast<const uint4*>(GH + kTile + row * kLd + e), gl);
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) d = fmaf(gh[i] + gl[i], sh[i] + sl[i], d);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    if ((tid & 7) == 0) gs[row] = d;
  }

  // ---- 1b. Lc, the factor table F_ij, which diagonal blocks and which
  // rows take the exact paths; v . dy and the bonus r . (u o k) a row
  {
    float pre[kSegs + 1], bv[kNSub + 1];
    pre[0] = 0.f;
#pragma unroll
    for (int q = 0; q < kSegs; ++q) pre[q + 1] = pre[q] + tot[q * kHD + ch];
#pragma unroll
    for (int m = 0; m <= kNSub; ++m) bv[m] = pre[m * kSub / kSegLen];
    const float off = pick(pre, qq);
#pragma unroll
    for (int tt = 0; tt < kSegLen; ++tt)
      Lc[(qq * kSegLen + tt + 1) * kLdL + ch] = run[tt] + off;
    if (qq == 0) Lc[ch] = 0.f;
    for (int row = qq; row < kPairs; row += kSegs) {
      const int jj = pair_j(row), ii = row - pair(0, jj);
      fac[row * kHD + ch] = fast_exp2(pick(bv, jj) - pick(bv, ii + 1));
    }
    const int jb = qq * kSegLen / kSub;
    const bool wide = pick(bv, jb) - pick(bv, jb + 1) > kSpanMax;
    const bool any = __any_sync(0xffffffffu, wide);
    if (lane == 0) slow[warp] = any;
    if (qq == 0) {
      int f = 0;
#pragma unroll
      for (int q = 0; q < kSegs; ++q) f |= small[q * kHD + ch];
      exrow[ch] = f;
    }
  }
  {
    const int row = tid >> 3, e = (tid & 7) * 8;
    float rr[8], kk[8], vv[8], dd[8], uu[8];
    unpack8(*reinterpret_cast<const uint4*>(Rs + row * kLd + e), rr);
    unpack8(*reinterpret_cast<const uint4*>(Ks + row * kLd + e), kk);
    unpack8(*reinterpret_cast<const uint4*>(Vs + row * kLd + e), vv);
    unpack8(*reinterpret_cast<const uint4*>(DYs + row * kLd + e), dd);
    load8(ub + e, uu);
    float vd = 0.f, bo = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      vd = fmaf(vv[i], dd[i], vd);
      bo = fmaf(rr[i] * uu[i], kk[i], bo);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      vd += __shfl_xor_sync(0xffffffffu, vd, o);
      bo += __shfl_xor_sync(0xffffffffu, bo, o);
    }
    if ((tid & 7) == 0) {
      vdy[row] = vd;
      bonus[row] = bo;
    }
  }
  __syncthreads();
  auto slow_block = [&](int jj) {   // its 4 warps' votes
    return (slow[4 * jj] | slow[4 * jj + 1] | slow[4 * jj + 2] |
            slow[4 * jj + 3]) != 0;
  };

  // ---- 2a. operands, 8 channels an item, as bf16 hi + lo (exponents <= 0):
  //   Rt[t] = r_t 2^{Lc[t] - Bv[j(t)]}
  //   Kh[s] = k_s 2^{Bv[i(s)+1] - Lc[s+1]},  Kd[s] = k_s 2^{Lc[Q] - Lc[s+1]}
  // (the forward's item order: each 8 lanes read two rows of Lc at 4
  // column offsets, 32 banks)
  {
    const int i = tid;
    const int row = 2 * (i >> 4) + ((i >> 2) & 1);
    const int e = ((i & 3) + 4 * ((i >> 3) & 1)) * 8;
    float x[8], lx[8], lb[8], f[8];
    uint32_t hi[4], lo[4];
    unpack8(*reinterpret_cast<const uint4*>(Rs + row * kLd + e), x);
    load8(Lc + row * kLdL + e, lx);
    load8(Lc + (row / kSub) * kSub * kLdL + e, lb);
#pragma unroll
    for (int q = 0; q < 8; ++q) f[q] = x[q] * fast_exp2(lx[q] - lb[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q) split2(f[2 * q], f[2 * q + 1], hi[q], lo[q]);
    *reinterpret_cast<uint4*>(RtH + row * kLd + e) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(RtH + kTile + row * kLd + e) = make_uint4(lo[0], lo[1], lo[2], lo[3]);

    float lq[8];
    unpack8(*reinterpret_cast<const uint4*>(Ks + row * kLd + e), x);
    load8(Lc + (row + 1) * kLdL + e, lx);
    load8(Lc + (row / kSub + 1) * kSub * kLdL + e, lb);
    load8(Lc + kQ * kLdL + e, lq);
#pragma unroll
    for (int q = 0; q < 8; ++q) f[q] = x[q] * fast_exp2(lb[q] - lx[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q) split2(f[2 * q], f[2 * q + 1], hi[q], lo[q]);
    *reinterpret_cast<uint4*>(KhH + row * kLd + e) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(KhH + kTile + row * kLd + e) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
#pragma unroll
    for (int q = 0; q < 8; ++q) f[q] = x[q] * fast_exp2(lq[q] - lx[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q) split2(f[2 * q], f[2 * q + 1], hi[q], lo[q]);
    *reinterpret_cast<uint4*>(KdH + row * kLd + e) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(KdH + kTile + row * kLd + e) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }

  // ---- 2b. diagonal A blocks too wide to factor (the forward's 2b)
  if (kAblate != 2 && tid < kNSub * 64 && slow_block(tid >> 6))
    exact_diag_a(tid, Rs, Ks, Lc, ub, Ax);
  __syncthreads();   // operands, exact A blocks in place

  // ---- 3. units u < 20: the A tiles (the forward's 3a: columns 8 (u %
  // 2).. of pair u / 2, Kh's fragments rescaled by F); units 20..29: the
  // dA tile of pair u - 20, dY_j V_i^T (exact bf16 inputs), masked to s <
  // t on the diagonal. Warp w takes units w and w + 16 ----
  for (int u = warp; u < 2 * kPairs + kPairs && kAblate != 2; u += 16) {
    if (u < 2 * kPairs) {
      const int jj = pair_j(u >> 1);
      if (u >> 1 == pair(jj, jj) && slow_block(jj)) continue;   // written in 2b
      a_tile_unit(u, lane, RtH, KhH, fac, bonus, Ax);
    } else {
      const int pr = u - 2 * kPairs;
      const int jj = pair_j(pr), ii = pr - pair(0, jj);
      float D[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kHD / 16; ++kk) {
        uint32_t a[4], bb[4];
        ldsm_x4(a, DYs + (jj * kSub + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
        ldsm_x4(bb, Vs + (ii * kSub + (lane & 7) + (lane >> 4) * 8) * kLd + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma16816(D[0], a, bb[0], bb[1]);
        mma16816(D[1], a, bb[2], bb[3]);
      }
      bf16* DH = DAx + pr * 2 * kDTile;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int tl = g + 8 * rr, sl = 8 * nt + 2 * tq;
          float x0 = D[nt][2 * rr], x1 = D[nt][2 * rr + 1];
          if (ii == jj) {
            x0 = sl < tl ? x0 : 0.f;
            x1 = sl + 1 < tl ? x1 : 0.f;
          }
          uint32_t vh, vl;
          split2(x0, x1, vh, vl);
          const int off = tl * kLdD + sl;
          *reinterpret_cast<uint32_t*>(DH + off) = vh;
          *reinterpret_cast<uint32_t*>(DH + kDTile + off) = vl;
        }
    }
  }
  __syncthreads();   // every A and dA tile in place

  // ---- 4. warp (rb, cb): rows 16 rb.. and columns c0 = 16 cb.. of dV,
  // dR and dK; element (nt, e) of a warp's 16 x 16 output: row 16 rb + g
  // + 8 (e >> 1), column c0 + 8 nt + 2 tq + (e & 1) ----
  const int rb = warp >> 2, c0 = (warp & 3) * 16;
  const bool slow_rb = slow_block(rb);
  const long long o_row = (long long)p.NH * kHD;   // outputs are contiguous
  const long long o_base = ((long long)b * p.T + t0) * o_row + (long long)h * kHD;
  auto store_pair = [&](bf16* out, int row, int col, float x0, float x1) {
    if (kAblate != 5 && t0 + row < p.T)
      *reinterpret_cast<__nv_bfloat162*>(out + o_base + row * o_row + col) =
          __floats2bfloat162_rn(x0, x1);
  };
  // A operand of a 16 x 16 tile [t][s] transposed (m = s, k = t), and
  // untransposed (m = t, k = s)
  const int toff_t = ((lane & 7) + (lane >> 4) * 8) * kLdD + ((lane >> 3) & 1) * 8;
  const int toff = (lane & 15) * kLdD + (lane >> 4) * 8;

  // dV = A^T dY + Kd G
  {
    float acc[2][4] = {};
    if (kAblate != 3) {
      for (int jj = rb; jj < kNSub; ++jj) {
        const bf16* AH = Ax + pair(rb, jj) * 2 * kDTile;
        uint32_t ah[4], al[4], bq[4];
        ldsm_x4_t(ah, AH + toff_t);
        ldsm_x4_t(al, AH + kDTile + toff_t);
        ldsm_x4_t(bq, DYs + (jj * kSub + (lane & 15)) * kLd + c0 + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma16816(acc[nt], al, bq[2 * nt], bq[2 * nt + 1]);
          mma16816(acc[nt], ah, bq[2 * nt], bq[2 * nt + 1]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kHD / 16; ++kk) {
        uint32_t kh[4], kl[4], gh[4], gl[4];
        const int aoff = (rb * kSub + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8;
        ldsm_x4(kh, KdH + aoff);
        ldsm_x4(kl, KdH + kTile + aoff);
        const int boff = (kk * 16 + (lane & 15)) * kLd + c0 + (lane >> 4) * 8;
        ldsm_x4_t(gh, GH + boff);
        ldsm_x4_t(gl, GH + kTile + boff);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma16816(acc[nt], kl, gh[2 * nt], gh[2 * nt + 1]);
          mma16816(acc[nt], kh, gl[2 * nt], gl[2 * nt + 1]);
          mma16816(acc[nt], kh, gh[2 * nt], gh[2 * nt + 1]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        store_pair(p.dv, rb * kSub + g + 8 * rr, c0 + 8 * nt + 2 * tq,
                   acc[nt][2 * rr], acc[nt][2 * rr + 1]);
  }

  // dR' and dK' of the warp's elements (kept for dw)
  float dRp[2][4], dKp[2][4];
  // the exact diagonal block of a slow sub-chunk: sum over the block's
  // pairs s < t of dA[t][s] x[c] 2^{Lc[t] - Lc[s+1]}, x = k_s for dR
  // (over s, row t) or r_t for dK (over t, row s)
  auto exact_diag = [&](float (&out)[2][4], bool t_side) {
    const bf16* DH = DAx + pair(rb, rb) * 2 * kDTile;
    const bf16* X = t_side ? Ks : Rs;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int own = g + 8 * (e >> 1);           // the element's row in the block
        const int col = c0 + 8 * nt + 2 * tq + (e & 1);
        float acc = 0.f;
        for (int o = 0; o < kSub; ++o) {
          const int tl = t_side ? own : o, sl = t_side ? o : own;
          if (sl >= tl) continue;
          const float d = __bfloat162float(DH[tl * kLdD + sl]) +
                          __bfloat162float(DH[kDTile + tl * kLdD + sl]);
          const float x = __bfloat162float(X[(rb * kSub + o) * kLd + col]);
          const float ex = Lc[(rb * kSub + tl) * kLdL + col] -
                           Lc[(rb * kSub + sl + 1) * kLdL + col];
          acc = fmaf(d * x, fast_exp2(ex), acc);
        }
        out[nt][e] += acc;
      }
  };

  // dR' = 2^{Lc[t]} dY S0^T + 2^{Lc[t] - Bv[rb]} sum_{i <= rb} F (dA Kh_i)
  {
    float X[2][4] = {}, acc[2][4] = {};
    if (kAblate != 3) {
#pragma unroll
      for (int kk = 0; kk < kHD / 16; ++kk) {
        uint32_t a[4], sh[4], sl[4];
        ldsm_x4(a, DYs + (rb * kSub + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
        const int boff = (c0 + (lane & 7) + (lane >> 4) * 8) * kLd + kk * 16 +
                         ((lane >> 3) & 1) * 8;
        ldsm_x4(sh, S0H + boff);
        ldsm_x4(sl, S0H + kTile + boff);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma16816(X[nt], a, sl[2 * nt], sl[2 * nt + 1]);
          mma16816(X[nt], a, sh[2 * nt], sh[2 * nt + 1]);
        }
      }
      for (int i = 0; i <= rb; ++i) {
        if (i == rb && slow_rb) break;
        const bf16* DH = DAx + pair(i, rb) * 2 * kDTile;
        uint32_t dh[4], dl[4], kh[4], kl[4];
        ldsm_x4(dh, DH + toff);
        ldsm_x4(dl, DH + kDTile + toff);
        const int boff = (i * kSub + (lane & 15)) * kLd + c0 + (lane >> 4) * 8;
        ldsm_x4_t(kh, KhH + boff);
        ldsm_x4_t(kl, KhH + kTile + boff);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float tmp[4] = {};
          mma16816(tmp, dl, kh[2 * nt], kh[2 * nt + 1]);
          mma16816(tmp, dh, kl[2 * nt], kl[2 * nt + 1]);
          mma16816(tmp, dh, kh[2 * nt], kh[2 * nt + 1]);
          const float2 f = *reinterpret_cast<const float2*>(
              fac + pair(i, rb) * kHD + c0 + 8 * nt + 2 * tq);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = fmaf(e & 1 ? f.y : f.x, tmp[e], acc[nt][e]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = rb * kSub + g + 8 * (e >> 1);
        const int col = c0 + 8 * nt + 2 * tq + (e & 1);
        const float lt = Lc[t * kLdL + col];
        dRp[nt][e] = fast_exp2(lt) * X[nt][e] +
                     fast_exp2(lt - Lc[rb * kSub * kLdL + col]) * acc[nt][e];
      }
    if (slow_rb && kAblate != 3) exact_diag(dRp, true);
  }

  // dK' = 2^{Lc[Q] - Lc[s+1]} V G^T + 2^{Bv[rb+1] - Lc[s+1]} sum_{j >= rb} F (dA^T Rt_j)
  {
    float X[2][4] = {}, acc[2][4] = {};
    if (kAblate != 3) {
#pragma unroll
      for (int kk = 0; kk < kHD / 16; ++kk) {
        uint32_t a[4], gh[4], gl[4];
        ldsm_x4(a, Vs + (rb * kSub + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
        const int boff = (c0 + (lane & 7) + (lane >> 4) * 8) * kLd + kk * 16 +
                         ((lane >> 3) & 1) * 8;
        ldsm_x4(gh, GH + boff);
        ldsm_x4(gl, GH + kTile + boff);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma16816(X[nt], a, gl[2 * nt], gl[2 * nt + 1]);
          mma16816(X[nt], a, gh[2 * nt], gh[2 * nt + 1]);
        }
      }
      for (int jj = rb; jj < kNSub; ++jj) {
        if (jj == rb && slow_rb) continue;
        const bf16* DH = DAx + pair(rb, jj) * 2 * kDTile;
        uint32_t dh[4], dl[4], rh[4], rl[4];
        ldsm_x4_t(dh, DH + toff_t);
        ldsm_x4_t(dl, DH + kDTile + toff_t);
        const int boff = (jj * kSub + (lane & 15)) * kLd + c0 + (lane >> 4) * 8;
        ldsm_x4_t(rh, RtH + boff);
        ldsm_x4_t(rl, RtH + kTile + boff);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float tmp[4] = {};
          mma16816(tmp, dl, rh[2 * nt], rh[2 * nt + 1]);
          mma16816(tmp, dh, rl[2 * nt], rl[2 * nt + 1]);
          mma16816(tmp, dh, rh[2 * nt], rh[2 * nt + 1]);
          const float2 f = *reinterpret_cast<const float2*>(
              fac + pair(rb, jj) * kHD + c0 + 8 * nt + 2 * tq);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = fmaf(e & 1 ? f.y : f.x, tmp[e], acc[nt][e]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = rb * kSub + g + 8 * (e >> 1);
        const int col = c0 + 8 * nt + 2 * tq + (e & 1);
        const float ls1 = Lc[(s + 1) * kLdL + col];
        dKp[nt][e] = fast_exp2(Lc[kQ * kLdL + col] - ls1) * X[nt][e] +
                     fast_exp2(Lc[(rb + 1) * kSub * kLdL + col] - ls1) * acc[nt][e];
      }
    if (slow_rb && kAblate != 3) exact_diag(dKp, false);
  }

  // the bonus terms, the stores, and E = r o dR' - k o dK', k o dK' for dw
  float Ev[2][4], Bv[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    float dr4[4], dk4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = rb * kSub + g + 8 * (e >> 1);
      const int col = c0 + 8 * nt + 2 * tq + (e & 1);
      const float rv = __bfloat162float(Rs[t * kLd + col]);
      const float kv = __bfloat162float(Ks[t * kLd + col]);
      const float uv = ub[col] * vdy[t];
      dr4[e] = fmaf(uv, kv, dRp[nt][e]);
      dk4[e] = fmaf(uv, rv, dKp[nt][e]);
      Bv[nt][e] = kv * dKp[nt][e];
      Ev[nt][e] = fmaf(rv, dRp[nt][e], -Bv[nt][e]);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = rb * kSub + g + 8 * rr, col = c0 + 8 * nt + 2 * tq;
      store_pair(p.dr, row, col, dr4[2 * rr], dr4[2 * rr + 1]);
      store_pair(p.dk, row, col, dk4[2 * rr], dk4[2 * rr + 1]);
    }
  }
  __syncthreads();   // no warp reads the operands any more: E over them
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int off = (rb * kSub + g + 8 * rr) * kLdL + c0 + 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(Es + off) = make_float2(Ev[nt][2 * rr], Ev[nt][2 * rr + 1]);
      *reinterpret_cast<float2*>(Bq + off) = make_float2(Bv[nt][2 * rr], Bv[nt][2 * rr + 1]);
    }
  __syncthreads();
  if (kAblate == 4) return;

  // ---- 5a. w dw_tau = <G, S_Q> + sum_{t > tau} E_t - (k o dK')_tau, and
  // dw = (w dw) / w on rows with no decay under kWMin: thread (ch, qq),
  // its kSegLen steps in reverse after the later segments' sums; du's
  // share of the chunk ----
  {
    float seg = 0.f, dus = 0.f;
#pragma unroll
    for (int tt = 0; tt < kSegLen; ++tt) {
      const int t = qq * kSegLen + tt;
      seg += Es[t * kLdL + ch];
      dus = fmaf(__bfloat162float(Rs[t * kLd + ch]) * __bfloat162float(Ks[t * kLd + ch]),
                 vdy[t], dus);
    }
    tot[qq * kHD + ch] = seg;
    dup[qq * kHD + ch] = dus;
  }
  __syncthreads();
  if (!exrow[ch]) {
    float after = 0.f;
    for (int q = qq + 1; q < kSegs; ++q) after += tot[q * kHD + ch];
    const float gsc = gs[ch];
#pragma unroll
    for (int tt = kSegLen - 1; tt >= 0; --tt) {
      const int t = qq * kSegLen + tt;
      const float x = gsc + after - Bq[t * kLdL + ch];
      after += Es[t * kLdL + ch];
      if (t0 + t < p.T) p.dw[o_base + t * o_row + ch] = x / Ws[t * kHD + ch];
    }
  }
  if (qq == 0) {
    float du = 0.f;
#pragma unroll
    for (int q = 0; q < kSegs; ++q) du += dup[q * kHD + ch];
    p.du_part[(((long long)b * p.nc + c) * p.NH + h) * kHD + ch] = du;
  }

  // ---- 5b. the exact rows, a warp a row
  for (int row = warp; row < kHD && kAblate != 6; row += 16)
    if (exrow[row])
      exact_row(row, lane, t0, p.T, Ws, Rs, Ks, Vs, DYs, S0H, GH,
                p.dw + o_base + row, o_row);
}

int launch_chunked(CParams p, cudaStream_t stream) {
  static bool attr_set = false;   // once per process
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv6_bwd_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ChunkSmem::bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rwkv6_bwd_deltas,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 DeltaSmem::bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          rwkv6_bwd_deltas, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  p.nc = (p.T + kQ - 1) / kQ;
  cudaError_t err;
  if (kAblate != 1) {
    rwkv6_bwd_deltas<<<dim3(p.nc, p.NH, 2 * p.B), 256, DeltaSmem::bytes, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // element pairs: 2 directions x half of 64 x 64 per (b, h)
    const long long pairs = (long long)p.B * p.NH * kHD * kHD;
    rwkv6_bwd_scan<<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rwkv6_bwd_chunk<<<dim3(p.nc, p.NH, p.B), kCThreads, ChunkSmem::bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = p.NH * kHD;
  rwkv6_bwd_du<<<(n + 255) / 256, 256, 0, stream>>>(p.du_part, p.du, p.B * p.nc, n);
  return (int)cudaGetLastError();
}

}  // namespace

// route: 0 = the step kernel (f32 or bf16, hd 32, 64 or 128), 1 = the
// chunked kernels (bf16 at hd 64, with r, k, v, w and dy on 16-byte
// aligned bases and strides); the caller picks, and a route the inputs
// do not allow returns cudaErrorInvalidValue. dtype (of r, k, v, dy and
// dr, dk, dv): 0 = float32, 1 = bfloat16. w, u and the states are
// float32, u [NH,hd] contiguous; r, k, w, v, dy are read by their strides
// (in elements, unit-stride last dim, strides given in that order); dr,
// dk, dv, dw [B,T,NH,hd], du [NH,hd], s0, ds, ds0 [B,NH,hd,hd] are
// contiguous. Scratch of the step kernel: f32 [B, NH, ceil(T / L), hd,
// hd], L = 131072 / (4 hd^2), and du_part [B,NH,hd]; two launches (the
// walk, then du's sum over b). Scratch of the chunked route: bf16
// [2][B][NH][nc + 1][2][64][64], nc = ceil(T / 64) (S's planes, then
// G's), then f32 [B][NH][2][nc][64][64] (the carries' terms) and
// [B][NH][2][nc][64] (their decays), and du_part [B][nc][NH][64]; four
// launches (the carries' terms, their scans, the chunks, du's sum over
// (b, chunk)). T, B and NH must be positive. Returns cudaGetLastError()
// after the launches.
extern "C" int rwkv6_scan_bwd(
    int route, int dtype, int hd, const void* r, const void* k,
    const void* v, const void* w, const void* dy, const void* u,
    const void* s0, const void* ds, void* dr, void* dk, void* dv, void* dw,
    void* du_part, void* du, void* ds0, void* scratch, int B, int T, int NH,
    long long srb, long long srt, long long srh, long long skb,
    long long skt, long long skh, long long swb, long long swt,
    long long swh, long long svb, long long svt, long long svh,
    long long sdb, long long sdt, long long sdh, void* stream) {
  if (B <= 0 || T <= 0 || NH <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const bool ok = dtype == 1 && hd == kHD &&
                    aligned16(r, 2, srb, srt, srh) &&
                    aligned16(k, 2, skb, skt, skh) &&
                    aligned16(v, 2, svb, svt, svh) &&
                    aligned16(w, 4, swb, swt, swh) &&
                    aligned16(dy, 2, sdb, sdt, sdh);
    if (!ok) return (int)cudaErrorInvalidValue;
    CParams p;
    p.r = static_cast<const bf16*>(r);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.dy = static_cast<const bf16*>(dy);
    p.w = static_cast<const float*>(w);
    p.u = static_cast<const float*>(u);
    p.s0 = static_cast<const float*>(s0);
    p.ds = static_cast<const float*>(ds);
    p.srb = srb; p.srt = srt; p.srh = srh;
    p.skb = skb; p.skt = skt; p.skh = skh;
    p.svb = svb; p.svt = svt; p.svh = svh;
    p.swb = swb; p.swt = swt; p.swh = swh;
    p.sdb = sdb; p.sdt = sdt; p.sdh = sdh;
    const int nc = (T + kQ - 1) / kQ;
    const long long planes = (long long)B * NH * (nc + 1) * 2 * kHD * kHD;
    const long long deltas = (long long)B * NH * 2 * nc * kHD * kHD;
    p.sp = static_cast<bf16*>(scratch);
    p.gp = p.sp + planes;
    p.delta = reinterpret_cast<float*>(p.gp + planes);
    p.dec = p.delta + deltas;
    p.dr = static_cast<bf16*>(dr);
    p.dk = static_cast<bf16*>(dk);
    p.dv = static_cast<bf16*>(dv);
    p.dw = static_cast<float*>(dw);
    p.du_part = static_cast<float*>(du_part);
    p.du = static_cast<float*>(du);
    p.ds0 = static_cast<float*>(ds0);
    p.B = B; p.T = T; p.NH = NH; p.nc = nc;
    return launch_chunked(p, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  Params p;
  const void* x[kArrays] = {r, k, w, v, dy};
  const long long sb[kArrays] = {srb, skb, swb, svb, sdb};
  const long long st[kArrays] = {srt, skt, swt, svt, sdt};
  const long long sh[kArrays] = {srh, skh, swh, svh, sdh};
  for (int a = 0; a < kArrays; ++a) {
    p.x[a] = x[a];
    p.sb[a] = sb[a];
    p.st[a] = st[a];
    p.sh[a] = sh[a];
  }
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.ds = static_cast<const float*>(ds);
  p.dr = dr; p.dk = dk; p.dv = dv;
  p.dw = static_cast<float*>(dw);
  p.du_part = static_cast<float*>(du_part);
  p.du = static_cast<float*>(du);
  p.ds0 = static_cast<float*>(ds0);
  p.scratch = static_cast<float4*>(scratch);
  p.B = B; p.T = T; p.NH = NH; p.nsc = 0;
  if (dtype == 0) return dispatch<float>(hd, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(hd, p, s);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// of each backward kernel at hd 64 in bf16, as launched: out[0] the step
// kernel, out[1] the chunked route's carries, out[2] its chunk blocks.
extern "C" int rwkv6_bwd_occupancy(int* out) {
  using P64 = Plan<64>;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_bwd<__nv_bfloat16, 64>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P64::bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rwkv6_bwd_deltas,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DeltaSmem::bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        rwkv6_bwd_deltas, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rwkv6_bwd_chunk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ChunkSmem::bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, rwkv6_bwd<__nv_bfloat16, 64>, P64::kThreads, P64::bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 1, rwkv6_bwd_deltas, 256, DeltaSmem::bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 2, rwkv6_bwd_chunk, kCThreads, ChunkSmem::bytes);
  return (int)err;
}
