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
// of the recurrence and moves x and y once (T*NH*P each), dt, B and C
// once and the state twice. For zamba2-2.7b (NH 80, P 64, N 64, T 1024,
// bf16) that is 1.34 GFLOP against 24 MB: about 55 operations per byte,
// under the card's ~295, so the floor is the bytes (~7 us at 3.35 TB/s).
// A scan token by token is held far above it by the latency of T steps
// in order; the chunked form below does the same work as small matrix
// products on the tensor cores, with T/64 steps in order instead of T.
//
// bf16 at zamba2's shape, N = 64 and P a multiple of 64 (ssd_chunked):
// the SSD block decomposition of the TPU kernel, with chunks of kChunk =
// 64 steps and L the inclusive cumulative sum of A dt within a chunk
// (every exponent below is <= 0):
//
//   intra: y  = ((C B^T) o M) x,   M[t][s] = exp(L_t - L_s) dt_s (s <= t)
//   inter: y += exp(L_t) C S_0
//   carry: S  = exp(L_C) S_0 + (B o exp(L_C - L) dt)^T x
//
// One block owns (batch, head, kPS = 64 state columns: 80 blocks at
// zamba2's B = 1) and walks the chunks in order with its [64, 64] slice
// of S in f32 registers (the mma accumulator layout): no chunk state goes
// to device memory, where the three-pass split (chunk states, state
// passing, chunk scan) would write and read 2 x 21 MB of them at zamba2's
// shape, more than the 24 MB the function itself moves. That count chose
// this design; the three-pass split was not built or timed.
// Within a chunk, y and the carry depend only on S(c) and the chunk's
// inputs, so 4 warps compute y (16 chunk rows each: inter, C B^T up to
// the diagonal, intra, D skip) while 4 others update S (16 rows each)
// and leave S(c+1) in shared memory for the next chunk's inter product.
// Every product is mma.sync m16n8k16 bf16 with f32 accumulation, operands
// read by ldmatrix from padded rows (no bank conflicts). Chunk c+1's B, C
// and x tiles come in by cp.async and its dt by a register load while
// chunk c is computed, so one __syncthreads a chunk is the only stop. L
// is kept in the log2 domain, so every decay is one ex2 instruction.
//
// Precision. The inputs are exact in bf16, but M, S and the carry weights
// B exp(L_C - L) dt are f32 values, and one bf16 rounding of them misses
// the plain f32 scan by more than the tolerance (y 2e-2, state 2e-4).
// Each such operand is therefore split into two bf16 terms, hi = bf16(v)
// and lo = bf16(v - hi) (16 significant bits), and multiplied twice; the
// CPU tests mirror this rounding (tests/test_torch_recurrent_kernels.py).
//
// The step kernel ssd_fwd takes f32 inputs (exact on the CUDA cores), and
// bf16 inputs of any other N or P, or with bases or strides that are not
// 16-byte aligned (cp.async moves 16-byte pieces); zamba2's inputs on the
// card are none of these. A block owns 16 columns of one (batch, head), 4
// lanes share a column, each holding N/4 of its rows in registers, and
// the block scans T step by step, staging kT steps of B, C, dt and x in
// shared memory. Both kernels mask the ragged tail and read their inputs
// in place by strides.
#include <initializer_list>

#include "tensor_core.cuh"

namespace {

using namespace repro_torch;
using bf16 = __nv_bfloat16;

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

// ----------------------------------------------------------------------
// step kernel: f32, and bf16 with a small state
// ----------------------------------------------------------------------
constexpr int kSplit = 4;                 // lanes per state column
constexpr int kCols = 16;                 // state columns per block
constexpr int kThreads = kSplit * kCols;  // 64
constexpr int kT = 32;                    // steps staged at once

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
int launch_step(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.P / kCols, p.NH, p.B);
  ssd_fwd<T, N><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_step(int n, const Params& p, cudaStream_t stream) {
  switch (n) {
    case 16: return launch_step<T, 16>(p, stream);
    case 32: return launch_step<T, 32>(p, stream);
    case 64: return launch_step<T, 64>(p, stream);
    case 128: return launch_step<T, 128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------------
// chunked kernel: bf16 on the tensor cores (mma.sync)
// ----------------------------------------------------------------------
constexpr int kChunk = 64;      // steps per chunk
constexpr int kYWarps = 4;      // y: each owns 16 rows of the chunk
constexpr int kWarps = 2 * kYWarps;   // + 4 carry warps: 16 rows of S each
constexpr int kPad = 8;         // bf16 of row padding: ldmatrix without conflicts
constexpr int kN = 64;          // state dim (zamba2's)
constexpr int kPS = 64;         // state columns per block

// Shared-memory plan (bytes): two buffers of one chunk's B, C, x and dt,
// two of the state slice in bf16 (hi and lo) and one L row per warp.
struct ChunkSmem {
  static constexpr int ldbc = kN + kPad;   // B, C rows
  static constexpr int ldx = kPS + kPad;   // x and state rows
  static constexpr int b = 0;
  static constexpr int c = b + kChunk * ldbc * 2;
  static constexpr int x = c + kChunk * ldbc * 2;
  static constexpr int dt = x + kChunk * ldx * 2;
  static constexpr int buf = dt + kChunk * 4;
  static constexpr int s = 2 * buf;                    // [2][hi, lo][kN][ldx]
  static constexpr int s_half = kN * ldx;              // elements
  static constexpr int l = s + 2 * 2 * s_half * 2;     // [kWarps][kChunk] f32
  static constexpr int bytes = l + kWarps * kChunk * 4;
};

__global__ void __launch_bounds__(kWarps * 32) ssd_chunked(const Params p) {
  using SM = ChunkSmem;
  constexpr int KN = kN / 16;        // k-steps over the state dim
  constexpr int MT = kN / 64;        // 16-row tiles of S per carry warp
  constexpr int NT = kPS / 8;        // 8-column tiles
  constexpr int kThr = kWarps * 32;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bool carry = warp >= kYWarps;            // the warp's role
  const int wt = carry ? warp - kYWarps : warp;  // its 16-row tile
  const int p0 = blockIdx.x * kPS, h = blockIdx.y, b = blockIdx.z;
  const float a2 = p.A[h] * kLog2e, d_h = p.D[h];   // L in the log2 domain
  const int nc = (p.T + kChunk - 1) / kChunk;

  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.sxb + h * p.sxh + p0;
  const bf16* bg = static_cast<const bf16*>(p.Bm) + b * p.sbb;
  const bf16* cg = static_cast<const bf16*>(p.Cm) + b * p.scb;
  const float* dg = p.dt + b * p.sdb + h * p.sdh;
  bf16* yg = static_cast<bf16*>(p.y) + (long long)h * p.P + p0;
  const long long y_row = (long long)p.NH * p.P;   // y is contiguous
  const long long y_b = (long long)b * p.T * y_row;

  // chunk c's B, C and x tiles into buffer `buf` (asynchronously)
  auto load_tiles = [&](int c, int buf) {
    unsigned char* base = smem + buf * SM::buf;
    const int t0 = c * kChunk;
    constexpr int kVecBC = kN / 8, kVecX = kPS / 8;
    for (int i = tid; i < kChunk * kVecBC; i += kThr) {
      const int r = i / kVecBC, e = (i % kVecBC) * 8;
      const bool ok = t0 + r < p.T;
      const long long t = ok ? t0 + r : 0;
      copy16(base + SM::b + (r * SM::ldbc + e) * 2,
                       bg + t * p.sbt + e, ok);
      copy16(base + SM::c + (r * SM::ldbc + e) * 2,
                       cg + t * p.sct + e, ok);
    }
    for (int i = tid; i < kChunk * kVecX; i += kThr) {
      const int r = i / kVecX, e = (i % kVecX) * 8;
      const bool ok = t0 + r < p.T;
      const long long t = ok ? t0 + r : 0;
      copy16(base + SM::x + (r * SM::ldx + e) * 2,
                       xg + t * p.sxt + e, ok);
    }
    cp_async_commit();
  };
  auto load_dt = [&](int c) {
    const int t = c * kChunk + tid;
    return (tid < kChunk && t < p.T) ? dg[(long long)t * p.sdt] : 0.f;
  };

  // carry warps: S rows n = (wt * MT + mi) * 16 + g (+8), cols j*8 + 2tq
  float S[MT][NT][4];
  // S as bf16 hi and lo in shared-memory buffer sb, for the inter product
  auto store_state = [&](int sb) {
    bf16* hi = reinterpret_cast<bf16*>(smem + SM::s) + sb * 2 * SM::s_half;
    bf16* lo = hi + SM::s_half;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = (wt * MT + mi) * 16 + g + 8 * r;
          const int off = n * SM::ldx + j * 8 + 2 * tq;
          uint32_t vh, vl;
          split2(S[mi][j][2 * r], S[mi][j][2 * r + 1], vh, vl);
          *reinterpret_cast<uint32_t*>(hi + off) = vh;
          *reinterpret_cast<uint32_t*>(lo + off) = vl;
        }
  };
  if (carry) {
    const float* s0 = p.s0 + ((long long)b * p.NH + h) * kN * p.P + p0;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = (wt * MT + mi) * 16 + g, col = j * 8 + 2 * tq;
        S[mi][j][0] = s0[(long long)n * p.P + col];
        S[mi][j][1] = s0[(long long)n * p.P + col + 1];
        S[mi][j][2] = s0[(long long)(n + 8) * p.P + col];
        S[mi][j][3] = s0[(long long)(n + 8) * p.P + col + 1];
      }
    store_state(0);
  }

  float dt_next = 0.f;
  if (nc > 0) {
    load_tiles(0, 0);
    dt_next = load_dt(0);
  }
  float* Lw = reinterpret_cast<float*>(smem + SM::l) + warp * kChunk;

  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1;
    unsigned char* base = smem + buf * SM::buf;
    float* dts = reinterpret_cast<float*>(base + SM::dt);
    if (tid < kChunk) dts[tid] = dt_next;
    cp_async_wait_all();
    __syncthreads();   // chunk c and S(c) are in place; chunk c-1 is done
    if (c + 1 < nc) {
      load_tiles(c + 1, buf ^ 1);
      dt_next = load_dt(c + 1);
    }
    const bf16* Bs = reinterpret_cast<const bf16*>(base + SM::b);
    const bf16* Cs = reinterpret_cast<const bf16*>(base + SM::c);
    const bf16* Xs = reinterpret_cast<const bf16*>(base + SM::x);

    // L: inclusive cumulative sum of A dt log2(e) (each warp its own copy)
    {
      const float l0 = a2 * dts[2 * lane], l1 = a2 * dts[2 * lane + 1];
      float run = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += v;
      }
      Lw[2 * lane] = run - l1;
      Lw[2 * lane + 1] = run;
      __syncwarp();
    }
    const float Ltot = Lw[kChunk - 1];

    if (!carry) {
      // ---- y for rows wt*16.. of the chunk ----
      const bf16* Sh = reinterpret_cast<const bf16*>(smem + SM::s) +
                       buf * 2 * SM::s_half;
      const bf16* Sl = Sh + SM::s_half;
      const int tr0 = wt * 16 + g, tr1 = tr0 + 8;    // this thread's rows
      const float Lt0 = Lw[tr0], Lt1 = Lw[tr1];

      // C rows as A fragments (k = state dim)
      uint32_t cA[KN][4];
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        ldsm_x4(cA[kk], Cs + (wt * 16 + (lane & 15)) * SM::ldbc + kk * 16 +
                            (lane >> 4) * 8);

      // inter: y = exp(L_t) * C (S_hi + S_lo)
      float Y[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) Y[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          const int off = (kk * 16 + (lane & 15)) * SM::ldx + j * 8 +
                          (lane >> 4) * 8;
          uint32_t r[4];
          ldsm_x4_t(r, Sh + off);
          mma16816(Y[j], cA[kk], r[0], r[1]);
          mma16816(Y[j + 1], cA[kk], r[2], r[3]);
          ldsm_x4_t(r, Sl + off);
          mma16816(Y[j], cA[kk], r[0], r[1]);
          mma16816(Y[j + 1], cA[kk], r[2], r[3]);
        }
      {
        const float e0 = fast_exp2(Lt0), e1 = fast_exp2(Lt1);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          Y[j][0] *= e0; Y[j][1] *= e0;
          Y[j][2] *= e1; Y[j][3] *= e1;
        }
      }

      // G = C B^T for these rows, columns s up to the diagonal
      float G[kChunk / 8][4];
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) G[j][e] = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk / 16; ++jj) {
        if (jj > wt) continue;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          uint32_t r[4];
          ldsm_x4(r, Bs + (jj * 16 + (lane & 7) + (lane >> 4) * 8) * SM::ldbc +
                         kk * 16 + ((lane >> 3) & 1) * 8);
          mma16816(G[2 * jj], cA[kk], r[0], r[1]);
          mma16816(G[2 * jj + 1], cA[kk], r[2], r[3]);
        }
      }

      // intra: y += (G o M) x, G o M split into bf16 hi + lo A fragments
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        if (kk > wt) continue;
        uint32_t mh[4], ml[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int jt = 2 * kk + half;
          const int s = jt * 8 + 2 * tq;
          const float Ls0 = Lw[s], Ls1 = Lw[s + 1];
          const float d0 = dts[s], d1 = dts[s + 1];
          const float v00 = s <= tr0 ? G[jt][0] * fast_exp2(Lt0 - Ls0) * d0 : 0.f;
          const float v01 =
              s + 1 <= tr0 ? G[jt][1] * fast_exp2(Lt0 - Ls1) * d1 : 0.f;
          const float v10 = s <= tr1 ? G[jt][2] * fast_exp2(Lt1 - Ls0) * d0 : 0.f;
          const float v11 =
              s + 1 <= tr1 ? G[jt][3] * fast_exp2(Lt1 - Ls1) * d1 : 0.f;
          split2(v00, v01, mh[2 * half], ml[2 * half]);
          split2(v10, v11, mh[2 * half + 1], ml[2 * half + 1]);
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldsm_x4_t(r, Xs + (kk * 16 + (lane & 15)) * SM::ldx + j * 8 +
                           (lane >> 4) * 8);
          mma16816(Y[j], mh, r[0], r[1]);
          mma16816(Y[j], ml, r[0], r[1]);
          mma16816(Y[j + 1], mh, r[2], r[3]);
          mma16816(Y[j + 1], ml, r[2], r[3]);
        }
      }

      // y += D x; store the valid rows
      const int t0 = c * kChunk;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int tr = r ? tr1 : tr0;
          const int col = j * 8 + 2 * tq;
          const float2 xv = unpack(
              *reinterpret_cast<const uint32_t*>(Xs + tr * SM::ldx + col));
          if (t0 + tr < p.T) {
            const __nv_bfloat162 out = __floats2bfloat162_rn(
                Y[j][2 * r] + d_h * xv.x, Y[j][2 * r + 1] + d_h * xv.y);
            *reinterpret_cast<__nv_bfloat162*>(
                yg + y_b + (long long)(t0 + tr) * y_row + col) = out;
          }
        }
    } else {
      // ---- carry: S = exp(L_C) S + (B o w)^T x, w_s = exp(L_C - L_s) dt_s,
      // B o w split into bf16 hi + lo A fragments (rows n, k = s) ----
      const float decay = fast_exp2(Ltot);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) S[mi][j][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = kk * 16 + 2 * tq + (e & 1) + (e >> 1) * 8;
          w[e] = fast_exp2(Ltot - Lw[s]) * dts[s];
        }
        uint32_t xb[NT][2];
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldsm_x4_t(r, Xs + (kk * 16 + (lane & 15)) * SM::ldx + j * 8 +
                           (lane >> 4) * 8);
          xb[j][0] = r[0]; xb[j][1] = r[1];
          xb[j + 1][0] = r[2]; xb[j + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          uint32_t r[4];
          const int nb = (wt * MT + mi) * 16;
          ldsm_x4_t(r, Bs + (kk * 16 + (lane & 7) + (lane >> 4) * 8) *
                                SM::ldbc + nb + ((lane >> 3) & 1) * 8);
          uint32_t wh[4], wl[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 bv = unpack(r[q]);
            const int we = (q >> 1) * 2;   // r0, r1: s 2tq..; r2, r3: s +8
            split2(bv.x * w[we], bv.y * w[we + 1], wh[q], wl[q]);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            mma16816(S[mi][j], wh, xb[j][0], xb[j][1]);
            mma16816(S[mi][j], wl, xb[j][0], xb[j][1]);
          }
        }
      }
      store_state(buf ^ 1);
    }
  }

  if (!carry) return;
  float* s1 = p.s1 + ((long long)b * p.NH + h) * kN * p.P + p0;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = (wt * MT + mi) * 16 + g, col = j * 8 + 2 * tq;
      s1[(long long)n * p.P + col] = S[mi][j][0];
      s1[(long long)n * p.P + col + 1] = S[mi][j][1];
      s1[(long long)(n + 8) * p.P + col] = S[mi][j][2];
      s1[(long long)(n + 8) * p.P + col + 1] = S[mi][j][3];
    }
}

int launch_chunked(const Params& p, cudaStream_t stream) {
  constexpr int smem = ChunkSmem::bytes;
  static bool attr_set = false;   // once per process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunked, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid(p.P / kPS, p.NH, p.B);
  ssd_chunked<<<grid, kWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// cp.async moves 16-byte pieces: x, B and C need 16-byte aligned bases and
// strides (in bf16 elements, multiples of 8)
bool aligned16(const void* ptr, std::initializer_list<long long> strides) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (long long s : strides)
    if (s % 8) return false;
  return true;
}

int dispatch_bf16(int n, const Params& p, cudaStream_t stream) {
  const bool aligned = aligned16(p.x, {p.sxb, p.sxt, p.sxh}) &&
                       aligned16(p.Bm, {p.sbb, p.sbt}) &&
                       aligned16(p.Cm, {p.scb, p.sct});
  if (aligned && n == kN && p.P % kPS == 0) return launch_chunked(p, stream);
  return dispatch_step<bf16>(n, p, stream);
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
  if (dtype == 0) return dispatch_step<float>(n_state, p, st);
  if (dtype == 1) return dispatch_bf16(n_state, p, st);
  return (int)cudaErrorInvalidValue;
}
