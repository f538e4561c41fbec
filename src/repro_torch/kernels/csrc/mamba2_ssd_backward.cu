// The Mamba2 SSD scan's backward: the gradients of the function that
// kernels/ref.py::mamba2_ssd_ref computes,
//
//   a_t = exp(A dt_t)                          (one scalar per b, t, h)
//   S_t = a_t S_{t-1} + B_t (dt_t x_t)^T       S_{-1} = state, S_{T-1} final
//   y_t = S_t^T C_t + D x_t
//
// for x [B,T,NH,P] (f32 or bf16), dt [B,T,NH] f32, A, D [NH] f32, B_mat,
// C_mat [B,T,N] in x's type (one group, shared by the heads) and state
// [B,NH,N,P] f32, given dy [B,T,NH,P] (x's type) and the final state's
// gradient ds [B,NH,N,P] f32. With G_t = dL/dS_t (G_{T-1} = ds + C dy^T,
// G_{t-1} = a_t G_t + C_{t-1} dy_{t-1}^T), each step t gives
//
//   dx_t[p]  = dt_t sum_n G_t[n][p] B_t[n] + D dy_t[p]
//   dB_t[n]  = dt_t sum_p G_t[n][p] x_t[p]          (summed over the heads)
//   dC_t[n]  = sum_p S_t[n][p] dy_t[p]              (summed over the heads)
//   ddt_t    = sum_{n,p} G_t B_t[n] x_t[p] + A a_t sum_{n,p} G_t S_{t-1}
//   dA      += dt_t a_t sum_{n,p} G_t S_{t-1}       (over b and t)
//   dD      += sum_p dy_t[p] x_t[p]                 (over b and t)
//   d state  = a_0 G_0
//
// in f32 for both input types; dx, dB and dC are written in x's type.
// S_{t-1} is never recovered by dividing by a_t (a_t is exactly 0 once
// A dt < -104 in f32, and the plain function is exact there).
//
// There is no Pallas backward to replace: the reference trains through
// jax.value_and_grad over src/repro/kernels/ref.py::mamba2_ssd_ref.
//
// What bounds it on the H100: per (t, h, n, p) the walk takes G's two
// updates, S_t from S_{t-1} and the four sums, 12 operations; one call at
// zamba2-2.7b's training shape ([2,1024,80,64], N 64, bf16) is 8.1 GFLOP
// against ~73 MB (x, dy and dx in bf16, 21 MB each; dt, ddt, B, C, dB,
// dC and the three states a few MB more): 110 operations a byte, under
// the card's ~295 at the bf16 peak, so the floor is the bytes (0.022 ms
// at 3.35 TB/s). On the f32 CUDA cores alone the same 8.1 GFLOP take
// 0.12 ms, 5x that floor. Two routes, as the forward has:
//
//   - bf16 at N = 64 with P a multiple of 64 and 16-byte aligned x, B, C
//     and dy (zamba2's training shape): the chunked form on the tensor
//     cores, ssd_bwd_states + ssd_bwd_walk + ssd_bwd_sum (below);
//   - f32 (exact on the CUDA cores) and every other shape: the step
//     kernel ssd_bwd + ssd_bwd_sum, described first.
//
// The step kernel. Layout. The decay is one scalar per (t, h), so every element of G
// evolves on its own, and only the sums tie them together. A block owns
// (batch, head, a slice of kCols = 16 state columns): P/16 x NH x B
// blocks, 640 at the training shape. Thread r owns row r of G (and of
// S) over the slice's 16 columns, in registers, so dB's, dC's and the
// S_{t-1} term's sums over p are sums inside the thread; dx's sum over n
// runs down the columns: a halving exchange over a warp's 32 rows (16
// shuffles for 16 values), then the warps' partial sums in order,
// through shared memory. The sums over rows (ddt's two terms), over the
// slice's columns (dD) and over the steps (dA, dD) run once a sub-chunk,
// a warp a step (its lanes in order, then an xor butterfly). What sums
// across blocks (dB and dC over the slices and the heads, ddt over the
// slices, dA and dD over the slices and b) is written as each block's
// partials to scratch, and a second launch adds them in a fixed order.
// No atomics: two calls give the same bits. N = 16 runs 32 threads, the
// upper 16 rows held at 0.
//
// The walk needs S_{t-1} in reverse order. A first sweep runs the
// recurrence forward and writes the state at the start of every sub-
// chunk of kL steps to scratch [B, NH, P/16, ceil(T/kL), 16 x rows] f32;
// then, sub-chunk by sub-chunk in reverse, each thread recomputes its
// own values of the sub-chunk's states from the kept one into shared
// memory (kHistBytes = 32 KB a block: kL = 8 at N 64, 4 at N 128, 16 at
// N 16 and 32) and walks the steps backwards, S_t taken from S_{t-1} by
// the same expression as the recompute. At the training shape the kept
// states are 336 MB and the partials of dB and dC 336 MB more, written
// once and read once (0.4 ms of the card's bandwidth), freed after the
// call. A block takes 45.6 KB of shared memory at N 64, plus the 1 KB
// the card keeps a block: cudaOccupancyMaxActiveBlocksPerMultiprocessor
// gives 4 blocks an SM (528 on 132 SMs), so the 640 blocks of the
// training shape run in two waves, the second of 112 (B = 1: one).
//
// The chunked route, for bf16 at N 64. It runs the SSD block
// decomposition of the forward's ssd_chunked backwards, in chunks of Q =
// 64 steps with L the inclusive cumulative sum of A dt log2(e) (each
// step clamped at -128: its decay is 0 either way, and L keeps its
// digits), M_ts = 2^(L_t - L_s) for s <= t, K = C B^T, E = dy x^T, w_s =
// 2^(L_Q - L_s) dt_s, R' = M o K o E, S0 the state at the chunk's start
// and G = dL/dS at its end:
//
//   dx  = ((M o K) diag(dt))^T dy + diag(w) B G + D dy
//   dC  = diag(2^L) dy S0^T + ((M o E) diag(dt)) B      (over the heads)
//   dB  = ((M o E) diag(dt))^T C + diag(w) x G^T        (over the heads)
//   G  <- 2^L_Q G + C^T diag(2^L) dy                    (d state at 0)
//   dL  = u + rows(R' dt) - (cols(R') + v') dt, and 2^L_Q <G, S0> +
//         sum v' dt more at t = Q-1, with u_t = 2^L_t sum_n C_t (dy
//         S0^T)_t and v'_s = 2^(L_Q - L_s) sum_n B_s (x G^T)_s
//   ddt = cols(R') + v' + A revcumsum(dL); dA += sum dt revcumsum(dL);
//   dD += trace E
//
// Nothing divides by a decay. Three launches: ssd_bwd_states runs the
// forward's carry over the chunks and keeps S0 of every chunk as bf16
// hi + lo planes (42 MB at the training shape, against the step
// kernel's 336 MB of kept states); ssd_bwd_walk takes the chunks in
// reverse with G in f32 mma accumulators, one block per (b, h, 64
// columns), 8 warps: 4 own 16 rows t (dC, u, the rows of R', <G, S0>,
// dD, then G's update), 4 own 16 rows s (dx, dB, v', the columns of R',
// from K^T and E^T), and one of those forms dL and its scan; each block
// writes its partials of dB and dC (84 MB, against 336 MB) and ddt, and
// ssd_bwd_sum adds them in a fixed order (no atomics: two calls give the
// same bits). Every product is mma.sync m16n8k16 with an f32 operand
// split into bf16 hi + lo (one rounding moves the f32 gradients by 1e-3
// of their largest, tests/test_torch_ssd_chunked_backward.py); chunk
// c-1's x, dy, B, C come in by cp.async into a second buffer while chunk
// c is computed, S0 into its one buffer once the t-row warps are done
// with it: two __syncthreads a chunk, against the step kernel's 256
// stagings a block. At 114 KB of shared memory and 256 threads under
// 128 registers, 2 walk blocks fit an SM, so the training shape's 160
// are one wave. Per (b, h, chunk) ~16 products of 64^3 with the splits:
// ~22 GFLOP on the tensor cores at the training shape.
//
// nvcc -Xptxas -v (CUDA 12.8, sm_90a): ssd_bwd 128 registers at N 16-64
// (4-8 bytes spilled at N 32 and 64), 80 (bf16) and 72 (f32) at N 128;
// ssd_bwd_sum 32; ssd_bwd_walk 128 (84 bytes spilled), ssd_bwd_states
// 88.
#include <initializer_list>

#include "tensor_core.cuh"

namespace {

using namespace repro_torch;

constexpr int kCols = 16;            // state columns a block
constexpr int kHistBytes = 32768;    // one sub-chunk's states, a block
constexpr unsigned kFull = 0xffffffffu;

struct Params {  // strides in elements
  const void* x;
  const float* dt;
  const void* Bm;
  const void* Cm;
  const void* dy;       // [B,T,NH,P] contiguous
  const float* A;
  const float* D;
  const float* s0;      // [B,NH,N,P]
  const float* ds;      // [B,NH,N,P]: d(final state)
  void* dx;             // [B,T,NH,P], x's type
  float* ds0;           // [B,NH,N,P]: d state
  float4* states;       // [B,NH,ns,nsc,4,rows] float4, thread-slot order
  float* dB_part;       // [B,NH,ns,T,N]
  float* dC_part;       // [B,NH,ns,T,N]
  float* ddt_part;      // [B,NH,ns,T]
  float* dA_part;       // [B,NH,ns]
  float* dD_part;       // [B,NH,ns]
  void* dB;             // [B,T,N], x's type
  void* dC;
  float* ddt;           // [B,T,NH]
  float* dA;            // [NH]
  float* dD;            // [NH]
  int B, T, NH, P, N, nsc;
  long long sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, scb, sct;
};

template <int N>
struct Plan {
  static constexpr int kThreads = N < 32 ? 32 : N;   // a state row each
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kL = kHistBytes / (kThreads * kCols * 4);
  // shared memory, in floats
  static constexpr int hist = 0;                    // [kL][4][rows] float4
  static constexpr int xs = hist + kL * kCols * kThreads;   // x [kL][16]
  static constexpr int xd = xs + kL * kCols;             // dt x [kL][16]
  static constexpr int dys = xd + kL * kCols;            // dy [kL][16]
  static constexpr int bs = dys + kL * kCols;            // B [kL][N]
  static constexpr int cs = bs + kL * N;                 // C [kL][N]
  static constexpr int dts = cs + kL * N;                // dt [kL]
  static constexpr int dec = dts + kL;                   // exp(A dt) [kL]
  static constexpr int col = dec + kL;                   // [kL][kWarps][16]
  static constexpr int outs = col + kL * kWarps * kCols;  // [3][kL][rows]
  static constexpr int red = outs + 3 * kL * kThreads;   // [2][kWarps]
  static constexpr int bytes = (red + 2 * kWarps) * 4;
  static_assert(kL >= 1 && bytes <= 232448, "shared memory plan too large");
};

// One sub-chunk's inputs into shared memory as f32: x and dt x for steps
// t0 .. t0+n-1, B, dt and exp(A dt), and with `walk` dy and C too.
template <typename T, int N>
__device__ __forceinline__ void stage(const Params& p, float* sm, int b,
                                      int h, int col0, int t0, int n,
                                      float a_h, bool walk) {
  using P = Plan<N>;
  const int tid = threadIdx.x;
  const T* x = static_cast<const T*>(p.x) + b * p.sxb + h * p.sxh + col0;
  const T* dy = static_cast<const T*>(p.dy) +
                ((long long)b * p.T * p.NH + h) * p.P + col0;
  const float* dt = p.dt + b * p.sdb + h * p.sdh;
  for (int e = tid; e < n * kCols; e += P::kThreads) {
    const long long t = t0 + e / kCols;
    const int j = e % kCols;
    const float xv = to_float(x[t * p.sxt + j]);
    sm[P::xs + e] = xv;
    sm[P::xd + e] = dt[t * p.sdt] * xv;
    if (walk) sm[P::dys + e] = to_float(dy[t * p.NH * p.P + j]);
  }
  const T* Bm = static_cast<const T*>(p.Bm) + b * p.sbb;
  const T* Cm = static_cast<const T*>(p.Cm) + b * p.scb;
  for (int e = tid; e < n * N; e += P::kThreads) {
    const long long t = t0 + e / N;
    const int c = e % N;
    sm[P::bs + e] = to_float(Bm[t * p.sbt + c]);
    if (walk) sm[P::cs + e] = to_float(Cm[t * p.sct + c]);
  }
  for (int s = tid; s < n; s += P::kThreads) {
    const float d = dt[(long long)(t0 + s) * p.sdt];
    sm[P::dts + s] = d;
    sm[P::dec + s] = expf(a_h * d);
  }
}

// S <- a_s S + B_s[r] (dt_s x_s) on the thread's row
template <int N>
__device__ __forceinline__ void advance(float (&S)[kCols], const float* sm,
                                        int s, int r) {
  using P = Plan<N>;
  const float a = sm[P::dec + s];
  const float bn = r < N ? sm[P::bs + s * N + r] : 0.f;
  const float* xd = sm + P::xd + s * kCols;
#pragma unroll
  for (int j = 0; j < kCols; ++j) S[j] = fmaf(a, S[j], bn * xd[j]);
}

// One half of x[0, 2M) stays in the lane and is summed with the partner
// lane's (lane ^ Off) copy of it: the lower half where `upper` is false.
template <int M, int Off>
__device__ __forceinline__ void halve(float (&x)[kCols], bool upper) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float keep = upper ? x[i + M] : x[i];
    const float send = upper ? x[i] : x[i + M];
    x[i] = keep + __shfl_xor_sync(kFull, send, Off);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(Plan<N>::kThreads)
    ssd_bwd(const Params p) {
  using P = Plan<N>;
  constexpr int NT = P::kThreads, L = P::kL;
  extern __shared__ __align__(16) float sm[];
  float4* hist = reinterpret_cast<float4*>(sm + P::hist);

  const int r = threadIdx.x, lane = r & 31, warp = r >> 5;
  const bool live = r < N;
  const int slice = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ns = gridDim.x, col0 = slice * kCols, nsc = p.nsc;
  const long long bhs = ((long long)b * p.NH + h) * ns + slice;
  const float a_h = p.A[h], d_h = p.D[h];
  const long long row = (((long long)b * p.NH + h) * N + r) * p.P + col0;
  float4* kept = p.states + bhs * nsc * 4 * NT + r;

  // ---- 1. sweep: S forward, its value at each sub-chunk's start kept ----
  float S[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) S[j] = live ? p.s0[row + j] : 0.f;
  for (int sc = 0; sc < nsc; ++sc) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
      kept[((long long)sc * 4 + m) * NT] =
          make_float4(S[4 * m], S[4 * m + 1], S[4 * m + 2], S[4 * m + 3]);
    if (sc == nsc - 1) break;
    __syncthreads();                     // the last sub-chunk is consumed
    stage<T, N>(p, sm, b, h, col0, sc * L, L, a_h, false);
    __syncthreads();
    for (int s = 0; s < L; ++s) advance<N>(S, sm, s, r);
  }

  // ---- 2. the walk, sub-chunk by sub-chunk in reverse ----
  float G[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) G[j] = live ? p.ds[row + j] : 0.f;
  float da = 0.f, dd = 0.f;              // this warp's steps' dA, dD terms
  T* dx = static_cast<T*>(p.dx);
  for (int sc = nsc - 1; sc >= 0; --sc) {
    const int t0 = sc * L, n = min(L, p.T - t0);
    __syncthreads();                     // the last epilogue is done
    stage<T, N>(p, sm, b, h, col0, t0, n, a_h, true);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 s4 = kept[((long long)sc * 4 + m) * NT];
      S[4 * m] = s4.x;
      S[4 * m + 1] = s4.y;
      S[4 * m + 2] = s4.z;
      S[4 * m + 3] = s4.w;
    }
    __syncthreads();
    // recompute S_{t0-1} .. S_{t0+n-2} into hist, each thread its own row
    for (int s = 0; s < n; ++s) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        hist[(s * 4 + m) * NT + r] =
            make_float4(S[4 * m], S[4 * m + 1], S[4 * m + 2], S[4 * m + 3]);
      advance<N>(S, sm, s, r);
    }
    for (int s = n - 1; s >= 0; --s) {
      const float a = sm[P::dec + s];
      const float bn = live ? sm[P::bs + s * N + r] : 0.f;
      const float cn = live ? sm[P::cs + s * N + r] : 0.f;
      const float* xr = sm + P::xs + s * kCols;
      const float* xdr = sm + P::xd + s * kCols;
      const float* dyr = sm + P::dys + s * kCols;
      float db = 0.f, dc = 0.f, gs = 0.f, colv[kCols];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 p4 = hist[(s * 4 + m) * NT + r];
        const float4 x4 = *reinterpret_cast<const float4*>(xr + 4 * m);
        const float4 q4 = *reinterpret_cast<const float4*>(xdr + 4 * m);
        const float4 d4 = *reinterpret_cast<const float4*>(dyr + 4 * m);
        const float sp[4] = {p4.x, p4.y, p4.z, p4.w};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float xq[4] = {q4.x, q4.y, q4.z, q4.w};
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * m + e;
          const float g = fmaf(cn, dv[e], G[i]);          // G_t
          const float sn = fmaf(a, sp[e], bn * xq[e]);    // S_t
          db = fmaf(g, xv[e], db);
          dc = fmaf(sn, dv[e], dc);
          gs = fmaf(g, sp[e], gs);
          colv[i] = g * bn;
          G[i] = a * g;                                   // a_t G_t
        }
      }
      sm[P::outs + s * NT + r] = db;
      sm[P::outs + (L + s) * NT + r] = dc;
      sm[P::outs + (2 * L + s) * NT + r] = gs;
      // down the columns: the warp's 32 rows by halving, then the warps
      halve<8, 16>(colv, lane & 16);
      halve<4, 8>(colv, lane & 8);
      halve<2, 4>(colv, lane & 4);
      halve<1, 2>(colv, lane & 2);
      colv[0] += __shfl_xor_sync(kFull, colv[0], 1);
      if ((lane & 1) == 0) {
        const int j = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                      ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
        sm[P::col + (s * P::kWarps + warp) * kCols + j] = colv[0];
      }
    }
    __syncthreads();                     // outs and col in place

    // epilogue: dx, the partials of dB and dC, and the per-step sums
    for (int e = r; e < n * kCols; e += NT) {
      const int s = e / kCols, j = e % kCols;
      const float* cw = sm + P::col + s * P::kWarps * kCols + j;
      float acc = cw[0];
#pragma unroll
      for (int w = 1; w < P::kWarps; ++w) acc += cw[w * kCols];
      const long long o =
          (((long long)b * p.T + t0 + s) * p.NH + h) * p.P + col0 + j;
      store_from_float(dx + o, fmaf(sm[P::dts + s], acc,
                                    d_h * sm[P::dys + e]));
    }
    const long long part = bhs * p.T + t0;
    for (int e = r; e < n * N; e += NT) {
      const int s = e / N, c = e % N;
      p.dB_part[(part + s) * N + c] =
          sm[P::dts + s] * sm[P::outs + s * NT + c];
      p.dC_part[(part + s) * N + c] = sm[P::outs + (L + s) * NT + c];
    }
    // warp w takes steps w, w + kWarps, ..: its lanes' rows in order, then
    // an xor butterfly
    for (int s = warp; s < n; s += P::kWarps) {
      float u1 = 0.f, g = 0.f;
      for (int c = lane; c < N; c += 32) {
        u1 = fmaf(sm[P::bs + s * N + c], sm[P::outs + s * NT + c], u1);
        g += sm[P::outs + (2 * L + s) * NT + c];
      }
      float xy = lane < kCols ? sm[P::dys + s * kCols + lane] *
                                    sm[P::xs + s * kCols + lane]
                              : 0.f;
      u1 = warp_sum(u1);
      g = warp_sum(g);
      xy = warp_sum(xy);
      const float a = sm[P::dec + s];
      if (lane == 0) p.ddt_part[part + s] = fmaf(a_h * a, g, u1);
      da = fmaf(sm[P::dts + s] * a, g, da);
      dd += xy;
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) p.ds0[row + j] = G[j];
  }
  if (lane == 0) {
    sm[P::red + warp] = da;
    sm[P::red + P::kWarps + warp] = dd;
  }
  __syncthreads();
  if (r == 0) {
    float sa = sm[P::red], sd = sm[P::red + P::kWarps];
    for (int w = 1; w < P::kWarps; ++w) {
      sa += sm[P::red + w];
      sd += sm[P::red + P::kWarps + w];
    }
    p.dA_part[bhs] = sa;
    p.dD_part[bhs] = sd;
  }
}

// The sums across blocks, each in a fixed order: dB and dC over (head,
// slice), ddt over the slices, dA and dD over (batch, slice).
template <typename T>
__global__ void ssd_bwd_sum(const Params p, int ns) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long TN = (long long)p.T * p.N;
  if (i < p.B * TN) {
    const long long b = i / TN, tn = i % TN;
    const float* pb = p.dB_part + b * p.NH * ns * TN + tn;
    const float* pc = p.dC_part + b * p.NH * ns * TN + tn;
    float accb = pb[0], accc = pc[0];
    for (int k = 1; k < p.NH * ns; ++k) {
      accb += pb[k * TN];
      accc += pc[k * TN];
    }
    store_from_float(static_cast<T*>(p.dB) + i, accb);
    store_from_float(static_cast<T*>(p.dC) + i, accc);
  }
  const long long TH = (long long)p.T * p.NH;
  if (i < p.B * TH) {
    const long long b = i / TH, t = (i % TH) / p.NH, h = i % p.NH;
    const float* q = p.ddt_part + (b * p.NH + h) * ns * p.T + t;
    float acc = q[0];
    for (int s = 1; s < ns; ++s) acc += q[(long long)s * p.T];
    p.ddt[i] = acc;
  }
  if (i < p.NH) {
    float sa = 0.f, sd = 0.f;
    for (int b = 0; b < p.B; ++b)
      for (int s = 0; s < ns; ++s) {
        const long long k = ((long long)b * p.NH + i) * ns + s;
        sa += p.dA_part[k];
        sd += p.dD_part[k];
      }
    p.dA[i] = sa;
    p.dD[i] = sd;
  }
}

template <typename T, int N>
int launch(Params p, cudaStream_t stream) {
  using P = Plan<N>;
  static bool attr_set = false;   // once per process and instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P::bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  p.nsc = (p.T + P::kL - 1) / P::kL;
  const int ns = p.P / kCols;
  ssd_bwd<T, N><<<dim3(ns, p.NH, p.B), P::kThreads, P::bytes, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long n = (long long)p.B * p.T * (p.N > p.NH ? p.N : p.NH);
  if (n < p.NH) n = p.NH;
  ssd_bwd_sum<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(p, ns);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  switch (p.N) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------------
// chunked backward: bf16 at N = 64, P a multiple of 64, on the tensor
// cores (mma.sync)
// ----------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kQ = 64;          // steps a chunk
constexpr int kCN = 64;         // state dim (zamba2's)
constexpr int kCP = 64;         // state columns a block
constexpr int kLd = 72;         // bf16 a tile row: 64 + 8 of padding
constexpr int kTile = kQ * kLd;                 // elements of one tile
constexpr float kClamp2 = -128.f;  // log2 decay of one step: below, 2^x is 0

// Development switch (chip_smoke.py --ssd-backward-ablation): the walk
// without 1 the chunk-start state (its loads, <G, S0>, dy S0^T), 2 warp
// 4's dL scan, 3 the K and E tiles and their products, 4 G's products (B
// G, x G^T, G's update), 5 the stores of dx, ddt and the partials; the
// output is then wrong. 0 in every real build.
#ifndef SSD_BWD_ABLATE
#define SSD_BWD_ABLATE 0
#endif
constexpr int kAblate = SSD_BWD_ABLATE;

// L: the inclusive cumulative sum of max(A dt log2(e), -128) over the
// chunk's 64 steps, each lane two, into Lw[64]. A step clamped there
// decays by at most 2^-128, which ex2.approx.ftz flushes to 0 (as exp()
// gives 0 below -104 in f32), and every exponent stays above -8192, so
// L_t - L_s keeps its digits.
__device__ __forceinline__ void chunk_logdecay(const float* dts, float a2,
                                               float* Lw, int lane) {
  const float l0 = fmaxf(a2 * dts[2 * lane], kClamp2);
  const float l1 = fmaxf(a2 * dts[2 * lane + 1], kClamp2);
  float run = l0 + l1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(kFull, run, off);
    if (lane >= off) run += v;
  }
  Lw[2 * lane] = run - l1;
  Lw[2 * lane + 1] = run;
  __syncwarp();
}

// ---- launch 1: the state at every chunk's start, as bf16 hi + lo ----
struct StatesSmem {
  static constexpr int b = 0;                       // B [kQ][kLd] bf16
  static constexpr int x = b + kTile * 2;           // x [kQ][kLd] bf16
  static constexpr int dt = x + kTile * 2;          // dt [kQ] f32
  static constexpr int buf = dt + kQ * 4;
  static constexpr int l = 2 * buf;                 // [4 warps][kQ] f32
  static constexpr int bytes = l + 4 * kQ * 4;
};

// One block per (batch, head, 64 columns), 4 warps, each 16 rows of S in
// mma accumulators: S <- e^{L_Q} S + (B o w)^T x, w_s = e^{L_Q - L_s}
// dt_s, as ssd_chunked's carry warps (B o w split hi + lo). Writes S at
// chunk c's start to states [B, NH, nc, 2, N, P] (hi plane, lo plane).
__global__ void __launch_bounds__(128) ssd_bwd_states(const Params p) {
  using SM = StatesSmem;
  constexpr int NT = kCP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int p0 = blockIdx.x * kCP, h = blockIdx.y, b = blockIdx.z;
  const float a2 = p.A[h] * kLog2e;
  const int nc = p.nsc;
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.sxb + h * p.sxh + p0;
  const bf16* bg = static_cast<const bf16*>(p.Bm) + b * p.sbb;
  const float* dg = p.dt + b * p.sdb + h * p.sdh;
  bf16* st = reinterpret_cast<bf16*>(p.states) +
             ((long long)b * p.NH + h) * nc * 2 * kCN * p.P + p0;

  auto load_tiles = [&](int c, int buf) {
    unsigned char* base = smem + buf * SM::buf;
    const int t0 = c * kQ;
    for (int i = tid; i < kQ * 8; i += 128) {
      const int r = i >> 3, e = (i & 7) * 8;
      const bool ok = t0 + r < p.T;
      const long long t = ok ? t0 + r : 0;
      copy16(base + SM::b + (r * kLd + e) * 2, bg + t * p.sbt + e, ok);
      copy16(base + SM::x + (r * kLd + e) * 2, xg + t * p.sxt + e, ok);
    }
    cp_async_commit();
  };
  auto load_dt = [&](int c) {
    const int t = c * kQ + tid;
    return (tid < kQ && t < p.T) ? dg[(long long)t * p.sdt] : 0.f;
  };

  float S[NT][4];
  {
    const float* s0 = p.s0 + ((long long)b * p.NH + h) * kCN * p.P + p0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = warp * 16 + g, col = j * 8 + 2 * tq;
      S[j][0] = s0[(long long)n * p.P + col];
      S[j][1] = s0[(long long)n * p.P + col + 1];
      S[j][2] = s0[(long long)(n + 8) * p.P + col];
      S[j][3] = s0[(long long)(n + 8) * p.P + col + 1];
    }
  }
  load_tiles(0, 0);
  float dt_next = load_dt(0);
  float* Lw = reinterpret_cast<float*>(smem + SM::l) + warp * kQ;

  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1;
    unsigned char* base = smem + buf * SM::buf;
    float* dts = reinterpret_cast<float*>(base + SM::dt);
    if (tid < kQ) dts[tid] = dt_next;
    cp_async_wait_all();
    __syncthreads();   // chunk c in place; chunk c-1 is done
    if (c + 1 < nc) {
      load_tiles(c + 1, buf ^ 1);
      dt_next = load_dt(c + 1);
    }
    bf16* hi = st + (long long)c * 2 * kCN * p.P;
    bf16* lo = hi + (long long)kCN * p.P;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long off =
            (long long)(warp * 16 + g + 8 * r) * p.P + j * 8 + 2 * tq;
        uint32_t vh, vl;
        split2(S[j][2 * r], S[j][2 * r + 1], vh, vl);
        *reinterpret_cast<uint32_t*>(hi + off) = vh;
        *reinterpret_cast<uint32_t*>(lo + off) = vl;
      }
    if (c + 1 == nc) break;

    const bf16* Bs = reinterpret_cast<const bf16*>(base + SM::b);
    const bf16* Xs = reinterpret_cast<const bf16*>(base + SM::x);
    chunk_logdecay(dts, a2, Lw, lane);
    const float LQ = Lw[kQ - 1];
    const float decay = fast_exp2(LQ);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[j][e] *= decay;
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = kk * 16 + 2 * tq + (e & 1) + (e >> 1) * 8;
        w[e] = fast_exp2(LQ - Lw[s]) * dts[s];
      }
      uint32_t r[4], wh[4], wl[4];
      ldsm_x4_t(r, Bs + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                       warp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 bv = unpack(r[q]);
        const int we = (q >> 1) * 2;   // r0, r1: s 2tq..; r2, r3: s +8
        split2(bv.x * w[we], bv.y * w[we + 1], wh[q], wl[q]);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        ldsm_x4_t(r, Xs + (kk * 16 + (lane & 15)) * kLd + j * 8 +
                         (lane >> 4) * 8);
        mma16816(S[j], wh, r[0], r[1]);
        mma16816(S[j], wl, r[0], r[1]);
        mma16816(S[j + 1], wh, r[2], r[3]);
        mma16816(S[j + 1], wl, r[2], r[3]);
      }
    }
  }
}

// ---- launch 2: the walk over the chunks in reverse ----
struct WalkSmem {
  // one buffer: x, dy, B, C tiles and dt; two buffers, then the chunk
  // start state S0 and the carried gradient G as bf16 hi and lo planes
  static constexpr int x = 0;
  static constexpr int dy = x + kTile * 2;
  static constexpr int b = dy + kTile * 2;
  static constexpr int c = b + kTile * 2;
  static constexpr int dt = c + kTile * 2;
  static constexpr int buf = dt + kQ * 4;
  static constexpr int s0 = 2 * buf;               // [hi, lo][kCN][kLd]
  static constexpr int g = s0 + 2 * kTile * 2;     // [hi, lo][kCN][kLd]
  static constexpr int l = g + 2 * kTile * 2;      // [8 warps][kQ] f32
  static constexpr int u = l + 8 * kQ * 4;         // [kQ] each: u_t,
  static constexpr int rs = u + kQ * 4;            //  sum_s R'_ts dt_s,
  static constexpr int cs = rs + kQ * 4;           //  sum_t R'_ts,
  static constexpr int vp = cs + kQ * 4;           //  v'_s
  static constexpr int red = vp + kQ * 4;          // [4] <G, S0>, [4] dD
  static constexpr int bytes = red + 8 * 4;
  // two blocks an SM: 2 x (bytes + the 1 KB a block reserves) <= 228 KB
  static_assert(2 * (bytes + 1024) <= 233472, "two walk blocks an SM");
};

__device__ __forceinline__ void named_sync_128() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// One block per (batch, head, 64 columns), 8 warps, the chunks in
// reverse (the algebra is in the header). Warps 0-3 own 16 rows t each
// (dC, u_t, the row sums of R' dt, <G, S0>, dD, then G's update, with G
// in their f32 mma accumulators for the whole walk); warps 4-7 own 16
// rows s each (dx, dB, v'_s, the column sums of R', from K^T = B C^T and
// E^T = x dy^T), and warp 4 then forms dL, its reverse sum, ddt and the
// dA and dD terms. The roles run separate loops, so G's registers are
// not live in the s-row code; both meet at the same two __syncthreads a
// chunk.
__global__ void __launch_bounds__(256, 2) ssd_bwd_walk(const Params p) {
  using SM = WalkSmem;
  constexpr int NT = kCP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bool rows_t = warp < 4;
  const int wr = warp & 3;                 // the warp's 16-row tile
  const int cb = blockIdx.x, p0 = cb * kCP, h = blockIdx.y, b = blockIdx.z;
  const int ncb = gridDim.x, nc = p.nsc;
  const float a_h = p.A[h], a2 = a_h * kLog2e, d_h = p.D[h];
  const long long bhc = ((long long)b * p.NH + h) * ncb + cb;

  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.sxb + h * p.sxh + p0;
  const long long dy_row = (long long)p.NH * p.P;      // dy, dx contiguous
  const bf16* dyg = static_cast<const bf16*>(p.dy) +
                    (long long)b * p.T * dy_row + h * p.P + p0;
  bf16* dxg = static_cast<bf16*>(p.dx) + (long long)b * p.T * dy_row +
              h * p.P + p0;
  const bf16* bg = static_cast<const bf16*>(p.Bm) + b * p.sbb;
  const bf16* cg = static_cast<const bf16*>(p.Cm) + b * p.scb;
  const float* dg = p.dt + b * p.sdb + h * p.sdh;
  const bf16* st = reinterpret_cast<const bf16*>(p.states) +
                   ((long long)b * p.NH + h) * nc * 2 * kCN * p.P + p0;

  bf16* S0h = reinterpret_cast<bf16*>(smem + SM::s0);
  bf16* S0l = S0h + kTile;
  bf16* Gh = reinterpret_cast<bf16*>(smem + SM::g);
  bf16* Gl = Gh + kTile;
  float* U = reinterpret_cast<float*>(smem + SM::u);
  float* RS = reinterpret_cast<float*>(smem + SM::rs);
  float* CS = reinterpret_cast<float*>(smem + SM::cs);
  float* VP = reinterpret_cast<float*>(smem + SM::vp);
  float* red = reinterpret_cast<float*>(smem + SM::red);
  float* Lw = reinterpret_cast<float*>(smem + SM::l) + warp * kQ;

  auto load_tiles = [&](int c, int buf) {
    unsigned char* base = smem + buf * SM::buf;
    const int t0 = c * kQ;
    for (int i = tid; i < kQ * 8; i += 256) {
      const int r = i >> 3, e = (i & 7) * 8;
      const bool ok = t0 + r < p.T;
      const long long t = ok ? t0 + r : 0;
      const int o = (r * kLd + e) * 2;
      copy16(base + SM::x + o, xg + t * p.sxt + e, ok);
      copy16(base + SM::dy + o, dyg + t * dy_row + e, ok);
      copy16(base + SM::b + o, bg + t * p.sbt + e, ok);
      copy16(base + SM::c + o, cg + t * p.sct + e, ok);
    }
    cp_async_commit();
  };
  // S0 of chunk c, by the `nthr` threads from `first` on
  auto load_state = [&](int c, int first, int nthr) {
    const bf16* src = st + (long long)c * 2 * kCN * p.P;
    for (int i = tid - first; i < 2 * kCN * 8; i += nthr) {
      const int plane = i >> 9, r = (i >> 3) & 63, e = (i & 7) * 8;
      copy16(smem + SM::s0 + ((plane * kCN + r) * kLd + e) * 2,
             src + ((long long)plane * kCN + r) * p.P + e, true);
    }
    cp_async_commit();
  };
  auto load_dt = [&](int c) {
    const int t = c * kQ + tid;
    return (tid < kQ && t < p.T) ? dg[(long long)t * p.sdt] : 0.f;
  };
  load_tiles(nc - 1, 0);
  load_state(nc - 1, 0, 256);
  float dt_next = load_dt(nc - 1);
  // the top of chunk c: its dt into place, then one __syncthreads (chunk
  // c, its S0 and G in place; chunk c+1 done), chunk c-1's tiles and dt
  // requested, and L. Both roles' loops call it once a chunk.
  auto begin_chunk = [&](int c) {
    const int buf = (nc - 1 - c) & 1;
    float* dts = reinterpret_cast<float*>(smem + buf * SM::buf + SM::dt);
    if (tid < kQ) dts[tid] = dt_next;
    cp_async_wait_all();
    __syncthreads();
    if (c > 0) {
      load_tiles(c - 1, buf ^ 1);
      dt_next = load_dt(c - 1);
    }
    chunk_logdecay(dts, a2, Lw, lane);
    return buf;
  };
  const int r0 = wr * 16 + g, r1 = r0 + 8;   // this thread's rows

  if (rows_t) {
    // G: f32 mma accumulators, rows n = wr * 16.. over the 64 columns
    float G[NT][4];
    auto store_g = [&]() {   // as bf16 hi + lo into Gh, Gl
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = (r0 + 8 * r) * kLd + j * 8 + 2 * tq;
          uint32_t vh, vl;
          split2(G[j][2 * r], G[j][2 * r + 1], vh, vl);
          *reinterpret_cast<uint32_t*>(Gh + off) = vh;
          *reinterpret_cast<uint32_t*>(Gl + off) = vl;
        }
    };
    const float* ds = p.ds + ((long long)b * p.NH + h) * kCN * p.P + p0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j * 8 + 2 * tq;
      G[j][0] = ds[(long long)r0 * p.P + col];
      G[j][1] = ds[(long long)r0 * p.P + col + 1];
      G[j][2] = ds[(long long)r1 * p.P + col];
      G[j][3] = ds[(long long)r1 * p.P + col + 1];
    }
    store_g();

    for (int c = nc - 1; c >= 0; --c) {
      const int buf = begin_chunk(c);
      unsigned char* base = smem + buf * SM::buf;
      const float* dts = reinterpret_cast<const float*>(base + SM::dt);
      const bf16* X = reinterpret_cast<const bf16*>(base + SM::x);
      const bf16* DY = reinterpret_cast<const bf16*>(base + SM::dy);
      const bf16* BM = reinterpret_cast<const bf16*>(base + SM::b);
      const bf16* CM = reinterpret_cast<const bf16*>(base + SM::c);
      const float LQ = Lw[kQ - 1], L0 = Lw[r0], L1 = Lw[r1];
      const int t0 = c * kQ;

      // <G, S0> over this warp's 16 rows n
      float gs = 0.f;
#pragma unroll
      for (int j = 0; j < (kAblate == 1 ? 0 : NT); ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = (wr * 16 + g + 8 * r) * kLd + j * 8 + 2 * tq;
          const float2 sh = unpack(*reinterpret_cast<const uint32_t*>(S0h + off));
          const float2 sl = unpack(*reinterpret_cast<const uint32_t*>(S0l + off));
          gs = fmaf(G[j][2 * r], sh.x + sl.x, gs);
          gs = fmaf(G[j][2 * r + 1], sh.y + sl.y, gs);
        }
      gs = warp_sum(gs);
      if (lane == 0) red[wr] = gs;

      // dC = diag(e^L) dy S0^T for rows t (k = p), and u_t
      float dC[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dC[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < (kAblate == 1 ? 0 : kCP / 16); ++kk) {
        uint32_t a[4];
        ldsm_x4(a, DY + (wr * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          const int off = (jj * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                          kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t r[4];
          ldsm_x4(r, S0h + off);
          mma16816(dC[2 * jj], a, r[0], r[1]);
          mma16816(dC[2 * jj + 1], a, r[2], r[3]);
          ldsm_x4(r, S0l + off);
          mma16816(dC[2 * jj], a, r[0], r[1]);
          mma16816(dC[2 * jj + 1], a, r[2], r[3]);
        }
      }
      {
        float u0 = 0.f, u1 = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = j * 8 + 2 * tq;
          const float2 c0 = unpack(*reinterpret_cast<const uint32_t*>(CM + r0 * kLd + n));
          const float2 c1 = unpack(*reinterpret_cast<const uint32_t*>(CM + r1 * kLd + n));
          u0 = fmaf(c0.x, dC[j][0], fmaf(c0.y, dC[j][1], u0));
          u1 = fmaf(c1.x, dC[j][2], fmaf(c1.y, dC[j][3], u1));
        }
        u0 += __shfl_xor_sync(kFull, u0, 1);
        u0 += __shfl_xor_sync(kFull, u0, 2);
        u1 += __shfl_xor_sync(kFull, u1, 1);
        u1 += __shfl_xor_sync(kFull, u1, 2);
        const float e0 = fast_exp2(L0), e1 = fast_exp2(L1);
        if (tq == 0) {
          U[r0] = e0 * u0;
          U[r1] = e1 * u1;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          dC[j][0] *= e0; dC[j][1] *= e0;
          dC[j][2] *= e1; dC[j][3] *= e1;
        }
      }
      named_sync_128();   // warps 0-3 are done with S0
      if (c > 0 && kAblate != 1) load_state(c - 1, 0, 128);

      // K and E for rows t, 16 columns s at a time up to the diagonal:
      // dC += ((M o E) diag(dt)) B, R' dt summed along the row, dD
      float rs0 = 0.f, rs1 = 0.f, dd = 0.f;
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        if (kk > wr || kAblate == 3) continue;
        float K[2][4], E[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) K[q][e] = E[q][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int arow = (wr * 16 + (lane & 15)) * kLd + ks * 16 + (lane >> 4) * 8;
          const int brow = (kk * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                           ks * 16 + ((lane >> 3) & 1) * 8;
          uint32_t a[4], r[4];
          ldsm_x4(a, CM + arow);
          ldsm_x4(r, BM + brow);
          mma16816(K[0], a, r[0], r[1]);
          mma16816(K[1], a, r[2], r[3]);
          ldsm_x4(a, DY + arow);
          ldsm_x4(r, X + brow);
          mma16816(E[0], a, r[0], r[1]);
          mma16816(E[1], a, r[2], r[3]);
        }
        uint32_t mh[4], ml[4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int s = kk * 16 + q * 8 + 2 * tq;
          const float Ls0 = Lw[s], Ls1 = Lw[s + 1];
          const float d0 = dts[s], d1 = dts[s + 1];
          const float m00 = s <= r0 ? fast_exp2(L0 - Ls0) : 0.f;
          const float m01 = s + 1 <= r0 ? fast_exp2(L0 - Ls1) : 0.f;
          const float m10 = s <= r1 ? fast_exp2(L1 - Ls0) : 0.f;
          const float m11 = s + 1 <= r1 ? fast_exp2(L1 - Ls1) : 0.f;
          rs0 = fmaf(m00 * K[q][0] * E[q][0], d0, rs0);
          rs0 = fmaf(m01 * K[q][1] * E[q][1], d1, rs0);
          rs1 = fmaf(m10 * K[q][2] * E[q][2], d0, rs1);
          rs1 = fmaf(m11 * K[q][3] * E[q][3], d1, rs1);
          split2(m00 * E[q][0] * d0, m01 * E[q][1] * d1, mh[2 * q], ml[2 * q]);
          split2(m10 * E[q][2] * d0, m11 * E[q][3] * d1, mh[2 * q + 1],
                 ml[2 * q + 1]);
          if (kk == wr) {   // E's diagonal: dy_t . x_t
            if (s == r0) dd += E[q][0];
            if (s + 1 == r0) dd += E[q][1];
            if (s == r1) dd += E[q][2];
            if (s + 1 == r1) dd += E[q][3];
          }
        }
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          uint32_t r[4];
          ldsm_x4_t(r, BM + (kk * 16 + (lane & 15)) * kLd + jj * 16 +
                           (lane >> 4) * 8);
          mma16816(dC[2 * jj], mh, r[0], r[1]);
          mma16816(dC[2 * jj], ml, r[0], r[1]);
          mma16816(dC[2 * jj + 1], mh, r[2], r[3]);
          mma16816(dC[2 * jj + 1], ml, r[2], r[3]);
        }
      }
      rs0 += __shfl_xor_sync(kFull, rs0, 1);
      rs0 += __shfl_xor_sync(kFull, rs0, 2);
      rs1 += __shfl_xor_sync(kFull, rs1, 1);
      rs1 += __shfl_xor_sync(kFull, rs1, 2);
      if (tq == 0) {
        RS[r0] = rs0;
        RS[r1] = rs1;
      }
      dd = warp_sum(dd);
      if (lane == 0) red[4 + wr] = dd;
      float* dcp = p.dC_part + (bhc * p.T + t0) * kCN;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int tr = r ? r1 : r0;
        if (t0 + tr < p.T && kAblate != 5) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
            *reinterpret_cast<float2*>(dcp + tr * kCN + j * 8 + 2 * tq) =
                make_float2(dC[j][2 * r], dC[j][2 * r + 1]);
        }
      }

      // G <- e^{L_Q} G + C^T diag(e^L) dy, rows n of this warp (k = t)
      const float decay = fast_exp2(LQ);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) G[j][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < (kAblate == 4 ? 0 : kQ / 16); ++kk) {
        uint32_t r[4], ah[4], al[4];
        ldsm_x4_t(r, CM + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                         wr * 16 + ((lane >> 3) & 1) * 8);
        const int t = kk * 16 + 2 * tq;
        const float ea = fast_exp2(Lw[t]), eb = fast_exp2(Lw[t + 1]);
        const float ec = fast_exp2(Lw[t + 8]), ed = fast_exp2(Lw[t + 9]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 cv = unpack(r[q]);
          if (q < 2)
            split2(cv.x * ea, cv.y * eb, ah[q], al[q]);
          else
            split2(cv.x * ec, cv.y * ed, ah[q], al[q]);
        }
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          ldsm_x4_t(r, DY + (kk * 16 + (lane & 15)) * kLd + jj * 16 +
                           (lane >> 4) * 8);
          mma16816(G[2 * jj], ah, r[0], r[1]);
          mma16816(G[2 * jj], al, r[0], r[1]);
          mma16816(G[2 * jj + 1], ah, r[2], r[3]);
          mma16816(G[2 * jj + 1], al, r[2], r[3]);
        }
      }
      __syncthreads();   // G, S0 read; U, RS, CS, VP and red in place
      store_g();         // the chunk before's G
    }
    float* ds0 = p.ds0 + ((long long)b * p.NH + h) * kCN * p.P + p0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j * 8 + 2 * tq;
      ds0[(long long)r0 * p.P + col] = G[j][0];
      ds0[(long long)r0 * p.P + col + 1] = G[j][1];
      ds0[(long long)r1 * p.P + col] = G[j][2];
      ds0[(long long)r1 * p.P + col + 1] = G[j][3];
    }
    return;
  }

  // rows s (warps 4-7); warp 4 also forms dL, ddt and the dA, dD terms
  float dA_acc = 0.f, dD_acc = 0.f;   // warp 4's, in chunk order
  for (int c = nc - 1; c >= 0; --c) {
    const int buf = begin_chunk(c);
    unsigned char* base = smem + buf * SM::buf;
    const float* dts = reinterpret_cast<const float*>(base + SM::dt);
    const bf16* X = reinterpret_cast<const bf16*>(base + SM::x);
    const bf16* DY = reinterpret_cast<const bf16*>(base + SM::dy);
    const bf16* BM = reinterpret_cast<const bf16*>(base + SM::b);
    const bf16* CM = reinterpret_cast<const bf16*>(base + SM::c);
    const float LQ = Lw[kQ - 1], L0 = Lw[r0], L1 = Lw[r1];
    const int t0 = c * kQ;
    {
      const float q0 = fast_exp2(LQ - L0), q1 = fast_exp2(LQ - L1);
      const float ds0 = dts[r0], ds1 = dts[r1];
      const float w0 = q0 * ds0, w1 = q1 * ds1;
      // dx = w o (B G) for rows s (k = n)
      float dx[NT][4], dB[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dx[j][e] = dB[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < (kAblate == 4 ? 0 : kCN / 16); ++kk) {
        uint32_t a[4];
        ldsm_x4(a, BM + (wr * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          const int off = (kk * 16 + (lane & 15)) * kLd + jj * 16 + (lane >> 4) * 8;
          uint32_t r[4];
          ldsm_x4_t(r, Gh + off);
          mma16816(dx[2 * jj], a, r[0], r[1]);
          mma16816(dx[2 * jj + 1], a, r[2], r[3]);
          ldsm_x4_t(r, Gl + off);
          mma16816(dx[2 * jj], a, r[0], r[1]);
          mma16816(dx[2 * jj + 1], a, r[2], r[3]);
        }
      }
      // dB = w o (x G^T) for rows s (k = p), and v'_s
#pragma unroll
      for (int kk = 0; kk < (kAblate == 4 ? 0 : kCP / 16); ++kk) {
        uint32_t a[4];
        ldsm_x4(a, X + (wr * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          const int off = (jj * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                          kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t r[4];
          ldsm_x4(r, Gh + off);
          mma16816(dB[2 * jj], a, r[0], r[1]);
          mma16816(dB[2 * jj + 1], a, r[2], r[3]);
          ldsm_x4(r, Gl + off);
          mma16816(dB[2 * jj], a, r[0], r[1]);
          mma16816(dB[2 * jj + 1], a, r[2], r[3]);
        }
      }
      {
        float v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = j * 8 + 2 * tq;
          const float2 b0 = unpack(*reinterpret_cast<const uint32_t*>(BM + r0 * kLd + n));
          const float2 b1 = unpack(*reinterpret_cast<const uint32_t*>(BM + r1 * kLd + n));
          v0 = fmaf(b0.x, dB[j][0], fmaf(b0.y, dB[j][1], v0));
          v1 = fmaf(b1.x, dB[j][2], fmaf(b1.y, dB[j][3], v1));
        }
        v0 += __shfl_xor_sync(kFull, v0, 1);
        v0 += __shfl_xor_sync(kFull, v0, 2);
        v1 += __shfl_xor_sync(kFull, v1, 1);
        v1 += __shfl_xor_sync(kFull, v1, 2);
        if (tq == 0) {
          VP[r0] = q0 * v0;
          VP[r1] = q1 * v1;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        dx[j][0] *= w0; dx[j][1] *= w0; dx[j][2] *= w1; dx[j][3] *= w1;
        dB[j][0] *= w0; dB[j][1] *= w0; dB[j][2] *= w1; dB[j][3] *= w1;
      }

      // K^T and E^T for rows s, 16 columns t at a time from the
      // diagonal on: dx += ((M o K) diag(dt))^T dy, dB += ((M o E)
      // diag(dt))^T C, R' summed down the column
      float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        if (kk < wr || kAblate == 3) continue;
        float K[2][4], E[2][4];
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) K[q][e] = E[q][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int arow = (wr * 16 + (lane & 15)) * kLd + ks * 16 + (lane >> 4) * 8;
          const int brow = (kk * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                           ks * 16 + ((lane >> 3) & 1) * 8;
          uint32_t a[4], r[4];
          ldsm_x4(a, BM + arow);
          ldsm_x4(r, CM + brow);
          mma16816(K[0], a, r[0], r[1]);
          mma16816(K[1], a, r[2], r[3]);
          ldsm_x4(a, X + arow);
          ldsm_x4(r, DY + brow);
          mma16816(E[0], a, r[0], r[1]);
          mma16816(E[1], a, r[2], r[3]);
        }
        uint32_t kh[4], kl[4], eh[4], el[4];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int t = kk * 16 + q * 8 + 2 * tq;
          const float La = Lw[t], Lb = Lw[t + 1];
          const float m00 = r0 <= t ? fast_exp2(La - L0) : 0.f;
          const float m01 = r0 <= t + 1 ? fast_exp2(Lb - L0) : 0.f;
          const float m10 = r1 <= t ? fast_exp2(La - L1) : 0.f;
          const float m11 = r1 <= t + 1 ? fast_exp2(Lb - L1) : 0.f;
          const float k00 = m00 * K[q][0], k01 = m01 * K[q][1];
          const float k10 = m10 * K[q][2], k11 = m11 * K[q][3];
          cs0 = fmaf(k00, E[q][0], cs0);
          cs0 = fmaf(k01, E[q][1], cs0);
          cs1 = fmaf(k10, E[q][2], cs1);
          cs1 = fmaf(k11, E[q][3], cs1);
          split2(k00 * ds0, k01 * ds0, kh[2 * q], kl[2 * q]);
          split2(k10 * ds1, k11 * ds1, kh[2 * q + 1], kl[2 * q + 1]);
          split2(m00 * E[q][0] * ds0, m01 * E[q][1] * ds0, eh[2 * q],
                 el[2 * q]);
          split2(m10 * E[q][2] * ds1, m11 * E[q][3] * ds1, eh[2 * q + 1],
                 el[2 * q + 1]);
        }
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj) {
          const int off = (kk * 16 + (lane & 15)) * kLd + jj * 16 + (lane >> 4) * 8;
          uint32_t r[4];
          ldsm_x4_t(r, DY + off);
          mma16816(dx[2 * jj], kh, r[0], r[1]);
          mma16816(dx[2 * jj], kl, r[0], r[1]);
          mma16816(dx[2 * jj + 1], kh, r[2], r[3]);
          mma16816(dx[2 * jj + 1], kl, r[2], r[3]);
          ldsm_x4_t(r, CM + off);
          mma16816(dB[2 * jj], eh, r[0], r[1]);
          mma16816(dB[2 * jj], el, r[0], r[1]);
          mma16816(dB[2 * jj + 1], eh, r[2], r[3]);
          mma16816(dB[2 * jj + 1], el, r[2], r[3]);
        }
      }
      cs0 += __shfl_xor_sync(kFull, cs0, 1);
      cs0 += __shfl_xor_sync(kFull, cs0, 2);
      cs1 += __shfl_xor_sync(kFull, cs1, 1);
      cs1 += __shfl_xor_sync(kFull, cs1, 2);
      if (tq == 0) {
        CS[r0] = cs0;
        CS[r1] = cs1;
      }
      // dx += D dy, in bf16; dB's partial in f32
      float* dbp = p.dB_part + (bhc * p.T + t0) * kCN;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int tr = r ? r1 : r0;
        if (t0 + tr >= p.T || kAblate == 5) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = j * 8 + 2 * tq;
          const float2 dv = unpack(*reinterpret_cast<const uint32_t*>(DY + tr * kLd + col));
          *reinterpret_cast<__nv_bfloat162*>(dxg + (long long)(t0 + tr) * dy_row + col) =
              __floats2bfloat162_rn(fmaf(d_h, dv.x, dx[j][2 * r]),
                                    fmaf(d_h, dv.y, dx[j][2 * r + 1]));
          *reinterpret_cast<float2*>(dbp + tr * kCN + col) =
              make_float2(dB[j][2 * r], dB[j][2 * r + 1]);
        }
      }
    }
    __syncthreads();   // G, S0 read; U, RS, CS, VP and red in place

    if (warp == 4 && kAblate != 2) {
      // dL_t = u_t + sum_s R'_ts dt_s - (sum_t' R'_t't + v'_t) dt_t, and
      // at t = Q-1 also e^{L_Q} <G, S0> + sum_s v'_s dt_s
      const int ta = 2 * lane, tb = ta + 1;
      const float da = dts[ta], db = dts[tb];
      float la = U[ta] + RS[ta] - (CS[ta] + VP[ta]) * da;
      float lb = U[tb] + RS[tb] - (CS[tb] + VP[tb]) * db;
      const float vdt = warp_sum(VP[ta] * da + VP[tb] * db);
      if (lane == 31)
        lb += fast_exp2(LQ) * (((red[0] + red[1]) + red[2]) + red[3]) + vdt;
      // reverse cumulative sum over the chunk
      float run = la + lb;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_down_sync(kFull, run, off);
        if (lane + off < 32) run += v;
      }
      const float rca = run, rcb = run - la;
      float* ddt = p.ddt_part + bhc * p.T + t0;
      if (t0 + ta < p.T && kAblate != 5) ddt[ta] = CS[ta] + VP[ta] + a_h * rca;
      if (t0 + tb < p.T && kAblate != 5) ddt[tb] = CS[tb] + VP[tb] + a_h * rcb;
      dA_acc += warp_sum(da * rca + db * rcb);
      dD_acc += ((red[4] + red[5]) + red[6]) + red[7];
    }
  }

  if (warp == 4 && lane == 0) {
    p.dA_part[bhc] = dA_acc;
    p.dD_part[bhc] = dD_acc;
  }
}

int launch_chunked(Params p, cudaStream_t stream) {
  static bool attr_set = false;   // once per process
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WalkSmem::bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          ssd_bwd_walk, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  p.nsc = (p.T + kQ - 1) / kQ;
  const dim3 grid(p.P / kCP, p.NH, p.B);
  ssd_bwd_states<<<grid, 128, StatesSmem::bytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_walk<<<grid, 256, WalkSmem::bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long n = (long long)p.B * p.T * (p.N > p.NH ? p.N : p.NH);
  if (n < p.NH) n = p.NH;
  ssd_bwd_sum<bf16><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      p, p.P / kCP);
  return (int)cudaGetLastError();
}

// cp.async moves 16-byte pieces: bases and strides (in bf16 elements,
// multiples of 8) on 16 bytes
bool aligned16(const void* ptr, std::initializer_list<long long> strides) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (long long s : strides)
    if (s % 8) return false;
  return true;
}

}  // namespace

#define SSD_BWD_ARGS                                                     \
  int dtype, int n_state, const void *x, const void *dt, const void *A,  \
      const void *Bm, const void *Cm, const void *D, const void *s0,     \
      const void *dy, const void *ds, void *dx, void *ddt, void *dA,     \
      void *dB, void *dC, void *dD, void *ds0, void *states,             \
      void *dB_part, void *dC_part, void *ddt_part, void *dA_part,       \
      void *dD_part, int B, int T, int NH, int P, long long sxb,         \
      long long sxt, long long sxh, long long sdb, long long sdt,        \
      long long sdh, long long sbb, long long sbt, long long scb,        \
      long long sct, void *stream

namespace {

Params params_of(const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, const void* D,
                 const void* s0, const void* dy, const void* ds, void* dx,
                 void* ddt, void* dA, void* dB, void* dC, void* dD,
                 void* ds0, void* states, void* dB_part, void* dC_part,
                 void* ddt_part, void* dA_part, void* dD_part, int n_state,
                 int B, int T, int NH, int P, long long sxb, long long sxt,
                 long long sxh, long long sdb, long long sdt, long long sdh,
                 long long sbb, long long sbt, long long scb, long long sct) {
  Params p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.Bm = Bm; p.Cm = Cm; p.dy = dy;
  p.A = static_cast<const float*>(A);
  p.D = static_cast<const float*>(D);
  p.s0 = static_cast<const float*>(s0);
  p.ds = static_cast<const float*>(ds);
  p.dx = dx;
  p.ds0 = static_cast<float*>(ds0);
  p.states = static_cast<float4*>(states);
  p.dB_part = static_cast<float*>(dB_part);
  p.dC_part = static_cast<float*>(dC_part);
  p.ddt_part = static_cast<float*>(ddt_part);
  p.dA_part = static_cast<float*>(dA_part);
  p.dD_part = static_cast<float*>(dD_part);
  p.dB = dB; p.dC = dC;
  p.ddt = static_cast<float*>(ddt);
  p.dA = static_cast<float*>(dA);
  p.dD = static_cast<float*>(dD);
  p.B = B; p.T = T; p.NH = NH; p.P = P; p.N = n_state; p.nsc = 0;
  p.sxb = sxb; p.sxt = sxt; p.sxh = sxh;
  p.sdb = sdb; p.sdt = sdt; p.sdh = sdh;
  p.sbb = sbb; p.sbt = sbt; p.scb = scb; p.sct = sct;
  return p;
}

}  // namespace

#define SSD_BWD_PARAMS                                                   \
  params_of(x, dt, A, Bm, Cm, D, s0, dy, ds, dx, ddt, dA, dB, dC, dD, ds0, \
            states, dB_part, dC_part, ddt_part, dA_part, dD_part, n_state, \
            B, T, NH, P, sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, scb, sct)

// The step kernel. dtype (of x, B_mat, C_mat, dy and dx, dB, dC): 0 =
// float32, 1 = bfloat16. dt, A, D, the states and ddt, dA, dD are
// float32; A, D, dA, dD [NH], s0, ds, ds0 [B,NH,N,P], dy and dx
// [B,T,NH,P], dB and dC [B,T,N] and ddt [B,T,NH] are contiguous; x, dt,
// B_mat and C_mat are read by their strides (in elements; x, B_mat and
// C_mat with a unit-stride last dim). Scratch, f32: states
// [B,NH,P/16,ceil(T/L),16 R] (R = max(N, 32) rows, L = 32768 / (64 R)),
// dB_part and dC_part [B,NH,P/16,T,N], ddt_part [B,NH,P/16,T], dA_part
// and dD_part [B,NH,P/16]. P must be a multiple of 16; B, T and NH
// positive. Two launches (the walk, then the sums across blocks);
// returns cudaGetLastError() after them.
extern "C" int mamba2_ssd_bwd(SSD_BWD_ARGS) {
  if (B <= 0 || T <= 0 || NH <= 0 || P <= 0 || P % kCols)
    return (int)cudaErrorInvalidValue;
  const Params p = SSD_BWD_PARAMS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

// The chunked kernels: the same arguments, for bf16 (dtype 1) at N = 64
// and P a multiple of 64, with x, B_mat, C_mat and dy at 16-byte aligned
// bases and strides; anything else returns cudaErrorInvalidValue (the
// wrapper picks the route, and never falls back). Scratch: states bf16
// [B,NH,ceil(T/64),2,N,P] (hi plane, lo plane), dB_part and dC_part f32
// [B,NH,P/64,T,N], ddt_part [B,NH,P/64,T], dA_part and dD_part
// [B,NH,P/64]. Three launches (the chunk states, the walk, the sums).
extern "C" int mamba2_ssd_bwd_chunked(SSD_BWD_ARGS) {
  const long long row = (long long)NH * P;
  if (dtype != 1 || n_state != kCN || B <= 0 || T <= 0 || NH <= 0 ||
      P <= 0 || P % kCP || !aligned16(x, {sxb, sxt, sxh}) ||
      !aligned16(Bm, {sbb, sbt}) || !aligned16(Cm, {scb, sct}) ||
      !aligned16(dy, {row}))
    return (int)cudaErrorInvalidValue;
  return launch_chunked(SSD_BWD_PARAMS, static_cast<cudaStream_t>(stream));
}

// Resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// of each backward kernel at N = 64 in bf16, as launched: out[0] the step
// kernel, out[1] the chunked route's state launch, out[2] its walk.
extern "C" int mamba2_ssd_bwd_occupancy(int* out) {
  using P64 = Plan<64>;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd<__nv_bfloat16, 64>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P64::bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_walk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WalkSmem::bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        ssd_bwd_walk, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, ssd_bwd<__nv_bfloat16, 64>, P64::kThreads, P64::bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 1, ssd_bwd_states, 128, StatesSmem::bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 2, ssd_bwd_walk, 256, WalkSmem::bytes);
  return (int)err;
}
