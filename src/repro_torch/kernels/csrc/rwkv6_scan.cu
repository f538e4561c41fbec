// RWKV6 time-mix scan for prefill: r, k, v [B,T,NH,hd] (f32 or bf16),
// w [B,T,NH,hd] f32 decay in (0, 1), u [NH,hd] f32 bonus, state
// [B,NH,hd,hd] f32 (key x value) -> y [B,T,NH,hd] in r's type and the
// final state in f32:
//
//   y_t[j]   = sum_c r_t[c] * (S[c][j] + u[c] k_t[c] v_t[j])
//   S[c][j] <- w_t[c] S[c][j] + k_t[c] v_t[j]
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py,
// _rwkv6_kernel (called through rwkv6_scan).
//
// What bounds it on the H100: one call does about 4*T*NH*hd^2 operations
// and moves about T*NH*hd*(3*sizeof(r) + 4 + sizeof(r)) bytes plus the
// state twice. For rwkv6-3b (NH 40, hd 64, T 1024, bf16) that is 0.67
// GFLOP against 34 MB: about 20 operations per byte, under the card's
// ~295, so the floor is the bytes (~10 us at 3.35 TB/s). What holds this
// version far above it is the recurrence's latency: T steps in order.
//
// Design. The TPU kernel carries S in VMEM across its sequential chunk
// grid axis and uses the chunked form (a [C,C,hd] pairwise decay tensor
// and two MXU matmuls per chunk). Here blocks run in no order, so a block
// owns its state and loops over T itself, token by token (the classic
// RWKV CUDA form: no exponentials, so no exponent can overflow, and no
// pairwise tensor to hold). The value columns of S are independent
// (column j reads only v[:, j]), so a block takes kCols = 16 columns of
// one (batch, head): the grid is (hd/16, NH, B), 160 blocks for
// rwkv6-3b at B = 1 where (B, NH) alone would give 40. Inside a block,
// kSplit = 4 neighbouring lanes share a column and each holds hd/4 rows
// of it in registers (rows s, s+4, ...: no shared-memory bank conflict);
// their partial y meet through two shuffles. Every kT steps the block
// stages (r, k, w) of its head and v of its columns in shared memory with
// coalesced loads, then runs the kT steps from there. The kernel masks
// its ragged tail (steps past T are not run); inputs are read in place
// by their strides.
#include "common.cuh"

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
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(HD / kCols, p.NH, p.B);
  rwkv6_fwd<T, HD><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const Params& p, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v and y): 0 = float32, 1 = bfloat16. w, u and the
// states are float32; u [NH,hd], s0 and s1 [B,NH,hd,hd] and y
// [B,T,NH,hd] are contiguous; r, k, v, w are read by their strides (in
// elements, unit-stride last dim). Returns cudaGetLastError() after the
// launch.
extern "C" int rwkv6_scan_fwd(int dtype, int hd, const void* r, const void* k,
                              const void* v, const void* w, const void* u,
                              const void* s0, void* y, void* s1, int B, int T,
                              int NH, long long srb, long long srt,
                              long long srh, long long skb, long long skt,
                              long long skh, long long svb, long long svt,
                              long long svh, long long swb, long long swt,
                              long long swh, void* stream) {
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
  if (dtype == 0) return dispatch_hd<float>(hd, p, st);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, p, st);
  return (int)cudaErrorInvalidValue;
}
