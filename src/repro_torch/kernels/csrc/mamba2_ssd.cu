// Mamba2 SSD scan for prefill: x [B,T,NH,P] (f32 or bf16), dt [B,T,NH]
// f32 (> 0), A [NH] f32 (< 0), B_mat/C_mat [B,T,N] in x's type (one
// group, shared by the heads), D [NH] f32, state [B,NH,N,P] f32 ->
// y [B,T,NH,P] in x's type and the final state in f32:
//
//   S[n][p] <- exp(A dt_t) S[n][p] + B_t[n] dt_t x_t[p]
//   y_t[p]   = sum_n S[n][p] C_t[n] + D x_t[p]
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba2_ssd.py,
// _ssd_kernel (called through mamba2_ssd).
//
// What bounds it on the H100: one call does about 4*T*NH*N*P operations
// and moves x and y once (T*NH*P each), dt, B and C once and the state
// twice. For zamba2-2.7b (NH 80, P 64, N 64, T 1024, bf16) that is 1.34
// GFLOP against 24 MB: about 55 operations per byte, under the card's
// ~295, so the floor is the bytes (~7 us at 3.35 TB/s). What holds this
// version far above it is the recurrence's latency: T steps in order.
//
// Design. The TPU kernel carries S in VMEM across its sequential chunk
// grid axis and spends each chunk in MXU matmuls around a [C,C] decay
// tile (256 KB in f32 at zamba2's chunk of 256, above the 227 KB a block
// may use). Here a block owns its state and loops over T itself, step by
// step, so no [C,C] tile exists and the chunk length plays no part: any
// chunk gives the same function. The P columns of S are independent
// (column p reads only x[:, p]), so a block takes kCols = 16 columns of
// one (batch, head): the grid is (P/16, NH, B), 320 blocks for zamba2 at
// B = 1. kSplit = 4 neighbouring lanes share a column and each holds N/4
// rows of it in registers (rows s, s+4, ...); their partial y meet
// through two shuffles. Every kT steps the block stages B and C (the
// group shared by all heads, read once per block), dt, the decay
// exp(A dt) (A < 0 and dt >= 0, so its argument is <= 0) and x of its
// columns in shared memory. The skip D x is added in f32. The kernel masks
// its ragged tail; inputs are read in place by their strides.
#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int kSplit = 4;                 // lanes per state column
constexpr int kCols = 16;                 // state columns per block
constexpr int kThreads = kSplit * kCols;  // 64
constexpr int kT = 32;                    // steps staged at once

struct Params {  // strides in elements
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;
  const float* s0;
  void* y;
  float* s1;
  int B, T, NH, P;
  long long sxb, sxt, sxh, sdb, sdt, sdh, sbb, sbt, scb, sct;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) ssd_fwd(const Params p) {
  constexpr int kC = N / kSplit;  // rows of S per lane
  __shared__ float2 bc[kT][N];    // (B, C)
  __shared__ float xs[kT][kCols];
  __shared__ float dts[kT], decay[kT];

  const int col0 = blockIdx.x * kCols;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int s = tid % kSplit;
  const int jl = tid / kSplit;
  const int j = col0 + jl;
  const float a_h = p.A[h], d_h = p.D[h];

  const long long sbase = ((long long)b * p.NH + h) * N * p.P;
  float S[kC];
#pragma unroll
  for (int i = 0; i < kC; ++i)
    S[i] = p.s0[sbase + (long long)(s + kSplit * i) * p.P + j];

  const T* xb = static_cast<const T*>(p.x) + b * p.sxb + h * p.sxh + col0;
  const float* db = p.dt + b * p.sdb + h * p.sdh;
  const T* bb = static_cast<const T*>(p.Bm) + b * p.sbb;
  const T* cb = static_cast<const T*>(p.Cm) + b * p.scb;
  T* yb = static_cast<T*>(p.y) +
          ((long long)b * p.T * p.NH + h) * p.P + j;
  const long long y_step = (long long)p.NH * p.P;

  for (int t0 = 0; t0 < p.T; t0 += kT) {
    const int n = min(kT, p.T - t0);
    __syncthreads();  // the previous steps are consumed
    for (int i = tid; i < kT * N; i += kThreads) {
      const int tt = i / N, c = i % N;
      float2 q = make_float2(0.f, 0.f);
      if (tt < n) {
        const long long t = t0 + tt;
        q.x = to_float(bb[t * p.sbt + c]);
        q.y = to_float(cb[t * p.sct + c]);
      }
      bc[tt][c] = q;
    }
    for (int i = tid; i < kT * kCols; i += kThreads) {
      const int tt = i / kCols, jj = i % kCols;
      xs[tt][jj] = tt < n ? to_float(xb[(long long)(t0 + tt) * p.sxt + jj])
                          : 0.f;
    }
    for (int tt = tid; tt < kT; tt += kThreads) {
      const float d = tt < n ? db[(long long)(t0 + tt) * p.sdt] : 0.f;
      dts[tt] = d;
      decay[tt] = expf(a_h * d);
    }
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float xv = xs[tt][jl];
      const float xdt = dts[tt] * xv;
      const float a = decay[tt];
      float y0 = 0.f, y1 = 0.f;  // two chains halve the add latency
#pragma unroll
      for (int i = 0; i < kC; i += 2) {
        const float2 q0 = bc[tt][s + kSplit * i];
        S[i] = fmaf(a, S[i], q0.x * xdt);
        y0 = fmaf(S[i], q0.y, y0);
        const float2 q1 = bc[tt][s + kSplit * (i + 1)];
        S[i + 1] = fmaf(a, S[i + 1], q1.x * xdt);
        y1 = fmaf(S[i + 1], q1.y, y1);
      }
      float y = y0 + y1;
      y += __shfl_xor_sync(0xffffffffu, y, 1);
      y += __shfl_xor_sync(0xffffffffu, y, 2);
      if (s == 0) store_from_float(yb + (t0 + tt) * y_step, y + d_h * xv);
    }
  }

#pragma unroll
  for (int i = 0; i < kC; ++i)
    p.s1[sbase + (long long)(s + kSplit * i) * p.P + j] = S[i];
}

template <typename T, int N>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.P / kCols, p.NH, p.B);
  ssd_fwd<T, N><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(int n, const Params& p, cudaStream_t stream) {
  switch (n) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of x, B_mat, C_mat and y): 0 = float32, 1 = bfloat16. dt, A,
// D and the states are float32; A and D [NH], s0 and s1 [B,NH,N,P] and
// y [B,T,NH,P] are contiguous; x, dt, B_mat and C_mat are read by their
// strides (in elements; x, B_mat and C_mat with a unit-stride last dim).
// P must be a multiple of 16. Returns cudaGetLastError() after the launch.
extern "C" int mamba2_ssd_fwd(int dtype, int n_state, const void* x,
                              const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* D, const void* s0,
                              void* y, void* s1, int B, int T, int NH, int P,
                              long long sxb, long long sxt, long long sxh,
                              long long sdb, long long sdt, long long sdh,
                              long long sbb, long long sbt, long long scb,
                              long long sct, void* stream) {
  Params p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = Bm; p.Cm = Cm;
  p.D = static_cast<const float*>(D);
  p.s0 = static_cast<const float*>(s0);
  p.y = y;
  p.s1 = static_cast<float*>(s1);
  p.B = B; p.T = T; p.NH = NH; p.P = P;
  p.sxb = sxb; p.sxt = sxt; p.sxh = sxh;
  p.sdb = sdb; p.sdt = sdt; p.sdh = sdh;
  p.sbb = sbb; p.sbt = sbt; p.scb = scb; p.sct = sct;
  if (P % kCols != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_n<float>(n_state, p, st);
  if (dtype == 1) return dispatch_n<__nv_bfloat16>(n_state, p, st);
  return (int)cudaErrorInvalidValue;
}
