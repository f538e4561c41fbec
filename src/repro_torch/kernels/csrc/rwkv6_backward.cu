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
// is the bytes (0.036 ms at 3.35 TB/s). This kernel is the simple form:
// the steps run in order, on the CUDA cores.
//
// Layout. One block per (batch, head), 4 hd threads: thread (c, q) owns
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
// nvcc -Xptxas -v (CUDA 12.8, sm_90a): rwkv6_bwd 112 registers at hd 64
// (f32 and bf16), 128 at hd 128 (the cap at 512 threads), 180 (f32) and
// 210 (bf16) at hd 32, no spills; rwkv6_bwd_du 32.
#include "tensor_core.cuh"

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

}  // namespace

// dtype (of r, k, v, dy and dr, dk, dv): 0 = float32, 1 = bfloat16. w,
// u and the states are float32, u [NH,hd] contiguous; r, k, w, v, dy are
// read by their strides (in elements, unit-stride last dim, strides given
// in that order); dr, dk, dv, dw [B,T,NH,hd], du_part [B,NH,hd], du
// [NH,hd], s0, ds, ds0 [B,NH,hd,hd] are contiguous; scratch holds
// [B, NH, ceil(T / L), hd, hd] f32, L = 131072 / (4 hd^2). T, B and NH
// must be positive. Two launches (the walk, then du's sum over b);
// returns cudaGetLastError() after them.
extern "C" int rwkv6_scan_bwd(
    int dtype, int hd, const void* r, const void* k, const void* v,
    const void* w, const void* dy, const void* u, const void* s0,
    const void* ds, void* dr, void* dk, void* dv, void* dw, void* du_part,
    void* du, void* ds0, void* scratch, int B, int T, int NH, long long srb,
    long long srt, long long srh, long long skb, long long skt,
    long long skh, long long swb, long long swt, long long swh,
    long long svb, long long svt, long long svh, long long sdb,
    long long sdt, long long sdh, void* stream) {
  if (B <= 0 || T <= 0 || NH <= 0) return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(hd, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(hd, p, s);
  return (int)cudaErrorInvalidValue;
}
