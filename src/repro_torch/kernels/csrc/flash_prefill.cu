// Flash attention for prefill: causal, sliding-window or non-causal GQA
// attention with an online softmax, q [B,S,H,hd], k/v [B,T,KV,hd] ->
// o [B,S,H,hd], f32 or bf16 in, f32 accumulation. Head dims 32, 64, 80
// (zamba2's shared block) and 128: every tile walks hd in steps of 4
// (f32), 8 (staging) or 16 (WMMA), all of which divide 80.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_prefill.py,
// _flash_kernel (called through flash_attention).
//
// What bounds it on the H100: at prefill lengths the work is
// 4*S*T_eff*hd*H operations against O((S+T)*hd) bytes, far above the
// card's ~295 operations per byte, so it is bound by arithmetic: the
// 989 TFLOP/s bf16 tensor-core rate. bf16 inputs take the tensor cores
// through WMMA (16x16x16 mma.sync tiles, f32 accumulation); f32 inputs
// stay exact on the CUDA cores (67 TFLOP/s). wgmma/TMA, which the full
// rate needs, are the next step.
//
// Design. The TPU grid walks kv blocks in order and carries (m, l, acc)
// in VMEM scratch across grid steps. Here blocks run in no order, so one
// block owns (batch, query head, tile of query rows) and itself loops
// over the K/V tiles of 64 keys staged in shared memory.
//
// bf16 (flash_fwd_tc): 4 warps, 16 query rows each. Per tile a warp
// computes its 16x64 scores S = Q K^T with WMMA into shared memory; each
// pair of lanes owns one row for the online softmax (log2 domain), writes
// P in bf16 and rescales its row of the f32 output accumulator, kept in
// shared memory because WMMA fragments hide their row layout; then the
// warp adds P V with WMMA.
//
// f32 (flash_fwd): each tile is staged as f32 and read by every row of
// the block; the running max, denominator and accumulator stay in
// registers. Each query row belongs to
// NSPLIT = 1 or 2 threads (hd 128 is split in two so q and acc fit in
// registers); the partial dot products meet through one shuffle. Scores
// are kept in the log2 domain (q is pre-scaled by log2(e)/sqrt(hd)) and
// the accumulator is rescaled once per 16 keys. The key loop stops at the
// causal diagonal of the tile's last row and starts at the window's edge
// of its first row; the per-row mask (kpos < T, causal, window) handles
// the rest. Inputs are read in place by their strides: no transpose and
// no zero padding, unlike the TPU wrapper. Causal tiles are scheduled
// heaviest (last) first to shorten the tail.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 128;
constexpr int kBlockK = 64;   // keys staged in shared memory per tile
constexpr int kChunk = 16;    // keys scored between accumulator rescales

struct Params {  // strides in elements
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, T, H, KV;
  long long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
  int causal, window, q_offset;
  float scale_log2;
};

// ----------------------------------------------------------------------
// f32 on the CUDA cores
// ----------------------------------------------------------------------
template <int HD>
struct Tile {
  static constexpr int kSplit = HD >= 128 ? 2 : 1;  // threads per row
  static constexpr int kDims = HD / kSplit;         // dims per thread
  static constexpr int kRows = kThreads / kSplit;   // query rows per block
  static constexpr int kQuads = kDims / 4;          // float4 groups
};

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Params p) {
  using TL = Tile<HD>;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [kBlockK][HD]
  float* Vs = Ks + kBlockK * HD;                  // [kBlockK][HD]

  const int n_tiles = (p.S + TL::kRows - 1) / TL::kRows;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x;
  const int part = tid % TL::kSplit;
  const int row = qt * TL::kRows + tid / TL::kSplit;
  const bool active = row < p.S;
  const int qpos = p.q_offset + row;

  // this thread's dims: quad c covers [(c*kSplit + part)*4, +4)
  float q[TL::kDims], acc[TL::kDims];
  {
    const float* qp = static_cast<const float*>(p.q) + b * p.sqb +
                      (long long)(active ? row : 0) * p.sqs + h * p.sqh;
#pragma unroll
    for (int c = 0; c < TL::kQuads; ++c) {
      float tmp[4];
      load_widen<float, 4>(qp + (c * TL::kSplit + part) * 4, tmp);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        q[c * 4 + e] = active ? tmp[e] * p.scale_log2 : 0.f;
        acc[c * 4 + e] = 0.f;
      }
    }
  }

  // key range the whole tile needs
  const int q_first = p.q_offset + qt * TL::kRows;
  const int q_last = p.q_offset + min(qt * TL::kRows + TL::kRows, p.S) - 1;
  int k_end = p.T;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_first - p.window + 1);
  k_begin = (k_begin / kBlockK) * kBlockK;

  const float* kbase = static_cast<const float*>(p.k) + b * p.skb + kvh * p.skh;
  const float* vbase = static_cast<const float*>(p.v) + b * p.svb + kvh * p.svh;
  constexpr int VN = 4;
  constexpr int kVecPerRow = HD / VN;

  float m = -INFINITY, l = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBlockK * kVecPerRow; i += kThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * VN;
      const int kpos = k0 + r;
      float kt[VN], vt[VN];
      if (kpos < p.T) {
        load_widen<float, VN>(kbase + kpos * p.sks + c, kt);
        load_widen<float, VN>(vbase + kpos * p.svs + c, vt);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kt[e] = vt[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        Ks[r * HD + c + e] = kt[e];
        Vs[r * HD + c + e] = vt[e];
      }
    }
    __syncthreads();

    const int n_keys = min(kBlockK, k_end - k0);
    for (int j0 = 0; j0 < n_keys; j0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* kr = Ks + (j0 + jj) * HD;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < TL::kQuads; ++c) {
          const float4 kk =
              *reinterpret_cast<const float4*>(kr + (c * TL::kSplit + part) * 4);
          dot += q[c * 4] * kk.x + q[c * 4 + 1] * kk.y + q[c * 4 + 2] * kk.z +
                 q[c * 4 + 3] * kk.w;
        }
        if (TL::kSplit == 2) dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        const int kpos = k0 + j0 + jj;
        bool ok = (j0 + jj < n_keys);
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        s[jj] = ok ? dot : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float base = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = exp2f(m - base);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < TL::kDims; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float pj = exp2f(s[jj] - base);
        l += pj;
        const float* vr = Vs + (j0 + jj) * HD;
#pragma unroll
        for (int c = 0; c < TL::kQuads; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vr + (c * TL::kSplit + part) * 4);
          acc[c * 4] += pj * vv.x;
          acc[c * 4 + 1] += pj * vv.y;
          acc[c * 4 + 2] += pj * vv.z;
          acc[c * 4 + 3] += pj * vv.w;
        }
      }
      m = m_new;
    }
  }

  if (active) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* op = static_cast<float*>(p.o) +
                ((long long)b * p.S + row) * p.H * HD + (long long)h * HD;
#pragma unroll
    for (int c = 0; c < TL::kQuads; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        op[(c * TL::kSplit + part) * 4 + e] = acc[c * 4 + e] * inv;
  }
}

template <int HD>
int launch(const Params& p, cudaStream_t stream) {
  using TL = Tile<HD>;
  const int smem = 2 * kBlockK * HD * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + TL::kRows - 1) / TL::kRows, p.H, p.B);
  flash_fwd<HD><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch_f32(int hd, const Params& p, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(p, stream);
    case 64: return launch<64>(p, stream);
    case 80: return launch<80>(p, stream);
    case 128: return launch<128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------------
// bf16 on the tensor cores (WMMA)
// ----------------------------------------------------------------------
namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;   // query rows per block

// Shared-memory plan (byte offsets; every fragment start 32-byte aligned,
// rows padded against bank conflicts).
template <int HD>
struct TcSmem {
  static constexpr int kLdX = HD + 8;        // bf16 Q/K/V rows
  static constexpr int kLdS = kBlockK + 4;   // f32 scores
  static constexpr int kLdP = kBlockK + 8;   // bf16 probabilities
  static constexpr int kLdO = HD + 4;        // f32 output accumulator
  static constexpr int q = 0;
  static constexpr int k = q + kTcRows * kLdX * 2;
  static constexpr int v = k + kBlockK * kLdX * 2;
  static constexpr int s = v + kBlockK * kLdX * 2;
  static constexpr int p = s + kTcWarps * 16 * kLdS * 4;
  static constexpr int o = p + kTcWarps * 16 * kLdP * 2;
  static constexpr int bytes = o + kTcWarps * 16 * kLdO * 4;
};

// rows x HD bf16 from global (row stride ld_g elements) into shared
// (row stride ld_s), zero rows at or past n_valid.
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, int ld_s,
                                           const bf16* src, long long ld_g,
                                           int rows, int n_valid) {
  constexpr int kVec = HD / 8;   // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * kVec; i += kTcWarps * 32) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid) x = *reinterpret_cast<const uint4*>(src + r * ld_g + c);
    *reinterpret_cast<uint4*>(dst + r * ld_s + c) = x;
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcWarps * 32) flash_fwd_tc(const Params p) {
  using SM = TcSmem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + SM::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + SM::v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Ss = reinterpret_cast<float*>(smem + SM::s) + warp * 16 * SM::kLdS;
  bf16* Ps = reinterpret_cast<bf16*>(smem + SM::p) + warp * 16 * SM::kLdP;
  float* Os = reinterpret_cast<float*>(smem + SM::o) + warp * 16 * SM::kLdO;

  const int n_tiles = (p.S + kTcRows - 1) / kTcRows;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int row0 = qt * kTcRows;

  stage_rows<HD>(Qs, SM::kLdX,
                 static_cast<const bf16*>(p.q) + b * p.sqb + h * p.sqh +
                     row0 * p.sqs,
                 p.sqs, kTcRows, p.S - row0);
  for (int i = lane; i < 16 * HD; i += 32) Os[(i / HD) * SM::kLdO + i % HD] = 0.f;

  // this lane's row of the warp's 16, and which half of its columns
  const int r = lane >> 1, half = lane & 1;
  const int qrow = row0 + warp * 16 + r;
  const int qpos = p.q_offset + qrow;
  float m = -INFINITY, l = 0.f;

  const int q_first = p.q_offset + row0;
  const int q_last = p.q_offset + min(row0 + kTcRows, p.S) - 1;
  int k_end = p.T;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_first - p.window + 1);
  k_begin = (k_begin / kBlockK) * kBlockK;

  const bf16* kbase = static_cast<const bf16*>(p.k) + b * p.skb + kvh * p.skh;
  const bf16* vbase = static_cast<const bf16*>(p.v) + b * p.svb + kvh * p.svh;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    stage_rows<HD>(Ks, SM::kLdX, kbase + k0 * p.sks, p.sks, kBlockK,
                   p.T - k0);
    stage_rows<HD>(Vs, SM::kLdX, vbase + k0 * p.svs, p.svs, kBlockK,
                   p.T - k0);
    __syncthreads();

    {  // S = Q K^T for this warp's 16 rows
      wm::fragment<wm::accumulator, 16, 16, 16, float> acc[kBlockK / 16];
#pragma unroll
      for (int j = 0; j < kBlockK / 16; ++j) wm::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
        wm::load_matrix_sync(a, Qs + warp * 16 * SM::kLdX + kk * 16, SM::kLdX);
#pragma unroll
        for (int j = 0; j < kBlockK / 16; ++j) {
          wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> kf;
          wm::load_matrix_sync(kf, Ks + j * 16 * SM::kLdX + kk * 16, SM::kLdX);
          wm::mma_sync(acc[j], a, kf, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBlockK / 16; ++j)
        wm::store_matrix_sync(Ss + j * 16, acc[j], SM::kLdS, wm::mem_row_major);
    }
    __syncwarp();

    {  // online softmax on this lane's half row; P in bf16
      const int n_keys = min(kBlockK, k_end - k0);
      const float* srow = Ss + r * SM::kLdS + half * (kBlockK / 2);
      float sv[kBlockK / 2];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kBlockK / 2; ++c) {
        const int j = half * (kBlockK / 2) + c;
        const int kpos = k0 + j;
        bool ok = j < n_keys;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        sv[c] = ok ? srow[c] * p.scale_log2 : -INFINITY;
        cmax = fmaxf(cmax, sv[c]);
      }
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
      const float m_new = fmaxf(m, cmax);
      const float base = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = exp2f(m - base);
      float sum = 0.f;
      bf16* prow = Ps + r * SM::kLdP + half * (kBlockK / 2);
#pragma unroll
      for (int c = 0; c < kBlockK / 2; ++c) {
        const float pv = exp2f(sv[c] - base);
        prow[c] = __float2bfloat16(pv);
        sum += pv;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l = l * alpha + sum;
      m = m_new;
      float* orow = Os + r * SM::kLdO + half * (HD / 2);
#pragma unroll
      for (int c = 0; c < HD / 2; ++c) orow[c] *= alpha;
    }
    __syncwarp();

    {  // O += P V
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> pf[kBlockK / 16];
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk)
        wm::load_matrix_sync(pf[kk], Ps + kk * 16, SM::kLdP);
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        wm::fragment<wm::accumulator, 16, 16, 16, float> o;
        wm::load_matrix_sync(o, Os + c * 16, SM::kLdO, wm::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
          wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> vf;
          wm::load_matrix_sync(vf, Vs + kk * 16 * SM::kLdX + c * 16, SM::kLdX);
          wm::mma_sync(o, pf[kk], vf, o);
        }
        wm::store_matrix_sync(Os + c * 16, o, SM::kLdO, wm::mem_row_major);
      }
    }
    __syncwarp();
  }

  if (qrow < p.S) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    bf16* og = static_cast<bf16*>(p.o) + ((long long)b * p.S + qrow) * p.H * HD +
               (long long)h * HD + half * (HD / 2);
    const float* orow = Os + r * SM::kLdO + half * (HD / 2);
#pragma unroll
    for (int c = 0; c < HD / 2; ++c) og[c] = __float2bfloat16(orow[c] * inv);
  }
}

template <int HD>
int launch_tc(const Params& p, cudaStream_t stream) {
  constexpr int smem = TcSmem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + kTcRows - 1) / kTcRows, p.H, p.B);
  flash_fwd_tc<HD><<<grid, kTcWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch_bf16(int hd, const Params& p, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_tc<32>(p, stream);
    case 64: return launch_tc<64>(p, stream);
    case 80: return launch_tc<80>(p, stream);
    case 128: return launch_tc<128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the output
// is contiguous [B, S, H, hd]. Returns cudaGetLastError() after launch.
extern "C" int flash_prefill_fwd(int dtype, int hd, const void* q,
                                 const void* k, const void* v, void* o, int B,
                                 int S, int T, int H, int KV, long long sqb,
                                 long long sqs, long long sqh, long long skb,
                                 long long sks, long long skh, long long svb,
                                 long long svs, long long svh, int causal,
                                 int window, int q_offset, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.S = S; p.T = T; p.H = H; p.KV = KV;
  p.sqb = sqb; p.sqs = sqs; p.sqh = sqh;
  p.skb = skb; p.sks = sks; p.skh = skh;
  p.svb = svb; p.svs = svs; p.svh = svh;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale_log2 = kLog2e / sqrtf((float)hd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(hd, p, s);
  if (dtype == 1) return dispatch_bf16(hd, p, s);
  return (int)cudaErrorInvalidValue;
}
