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
// 0.12 ms. This kernel is the simple form: the steps run in order, on
// the CUDA cores.
//
// Layout. The decay is one scalar per (t, h), so every element of G
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
// call. A block takes 45.6 KB of shared memory at N 64, so at most five
// share an SM's 228 KB: the 640 blocks fit one wave only at five.
//
// nvcc -Xptxas -v (CUDA 12.8, sm_90a): ssd_bwd 128 registers at N 16-64
// (4-8 bytes spilled at N 32 and 64), 80 (bf16) and 72 (f32) at N 128;
// ssd_bwd_sum 32.
#include "common.cuh"

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

}  // namespace

// dtype (of x, B_mat, C_mat, dy and dx, dB, dC): 0 = float32, 1 =
// bfloat16. dt, A, D, the states and ddt, dA, dD are float32; A, D, dA,
// dD [NH], s0, ds, ds0 [B,NH,N,P], dy and dx [B,T,NH,P], dB and dC
// [B,T,N] and ddt [B,T,NH] are contiguous; x, dt, B_mat and C_mat are
// read by their strides (in elements; x, B_mat and C_mat with a
// unit-stride last dim). Scratch, f32: states [B,NH,P/16,ceil(T/L),16 R]
// (R = max(N, 32) rows, L = 32768 / (64 R)), dB_part and dC_part
// [B,NH,P/16,T,N], ddt_part [B,NH,P/16,T], dA_part and dD_part
// [B,NH,P/16]. P must be a multiple of 16; B, T and NH positive. Two
// launches (the walk, then the sums across blocks); returns
// cudaGetLastError() after them.
extern "C" int mamba2_ssd_bwd(
    int dtype, int n_state, const void* x, const void* dt, const void* A,
    const void* Bm, const void* Cm, const void* D, const void* s0,
    const void* dy, const void* ds, void* dx, void* ddt, void* dA, void* dB,
    void* dC, void* dD, void* ds0, void* states, void* dB_part,
    void* dC_part, void* ddt_part, void* dA_part, void* dD_part, int B,
    int T, int NH, int P, long long sxb, long long sxt, long long sxh,
    long long sdb, long long sdt, long long sdh, long long sbb,
    long long sbt, long long scb, long long sct, void* stream) {
  if (B <= 0 || T <= 0 || NH <= 0 || P <= 0 || P % kCols)
    return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
