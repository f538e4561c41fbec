// Paged attention for decode: one query token per sequence against K/V
// pages gathered through a block table, q [B,H,hd], pages [P,page,KV,hd],
// block_table [B,max_pages] int32, seq_lens [B] int32 -> o [B,H,hd],
// f32 or bf16 in, f32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_decode.py,
// _paged_kernel (called through paged_attention).
//
// What bounds it on the H100: it reads every live K/V byte once and does
// about 4*G operations per K/V element (G = H/KV query heads per kv
// head), about 1-4 operations per byte, far below the card's ~295: it is
// bound by memory bandwidth (3.35 TB/s), and the only gain is to stream
// the live pages at line rate and read nothing else.
//
// Design. The TPU grid walks pages in order per (batch, kv head) with the
// block table in SMEM as a scalar-prefetch operand. Here one block owns
// (batch, kv head), reads its own block-table row and seq_len, and walks
// only the pages below seq_len: each of its 8 warps takes every 8th run
// of 8 tokens and issues all 16 row loads of a run before it computes.
// A lane holds hd/32 consecutive dims of a K or V row, so a warp reads
// each row as one coalesced segment, in place in the [P,page,KV,hd] pool
// (no per-call transpose of the pool, unlike the TPU wrapper). The G
// query heads of the kv head share every row load; each keeps its own
// running max, denominator and accumulator in registers, and the 8
// warps' partial states are merged in shared memory at the end. With
// B=4 and KV=8 this launches 32 blocks on 132 SMs: splitting the page
// walk of one sequence across blocks (split-KV) is the next step.
#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int kWarps = 8;
constexpr int kTok = 8;    // tokens a warp loads before computing
constexpr int kMaxG = 8;   // query heads per kv head

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* block_table;
  const int* seq_lens;
  void* o;
  int B, H, KV, page, max_pages;
  long long sqb, sqh;
  long long skp, sks, skh, svp, svs, svh;
  long long sbt;
  float scale_log2;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32) paged_fwd(const Params p) {
  constexpr int DPL = HD / 32;  // dims per lane
  __shared__ float sm_m[kWarps][kMaxG];
  __shared__ float sm_l[kWarps][kMaxG];
  __shared__ float sm_acc[kWarps][kMaxG][HD];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = p.H / p.KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(p.seq_lens[b], p.max_pages * p.page);
  const int* bt = p.block_table + b * p.sbt;

  float q[kMaxG][DPL], acc[kMaxG][DPL], m[kMaxG], l[kMaxG];
  const T* qb = static_cast<const T*>(p.q) + b * p.sqb;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = q[g][e] = 0.f;
    if (g < G) {
      load_widen<T, DPL>(qb + (kvh * G + g) * p.sqh + lane * DPL, q[g]);
#pragma unroll
      for (int e = 0; e < DPL; ++e) q[g][e] *= p.scale_log2;
    }
  }

  const T* kb = static_cast<const T*>(p.k) + kvh * p.skh + lane * DPL;
  const T* vb = static_cast<const T*>(p.v) + kvh * p.svh + lane * DPL;
  for (int t0 = warp * kTok; t0 < len; t0 += kWarps * kTok) {
    // all 2*kTok row loads are issued before any is used; a token past
    // len re-reads the last one (clamped) and is masked below, so the
    // loads stay unconditional and the compiler keeps them together
    float kr[kTok][DPL], vr[kTok][DPL];
#pragma unroll
    for (int i = 0; i < kTok; ++i) {
      const int t = min(t0 + i, len - 1);
      const long long pg = __ldg(bt + t / p.page);
      const int slot = t % p.page;
      load_widen<T, DPL>(kb + pg * p.skp + slot * p.sks, kr[i]);
      load_widen<T, DPL>(vb + pg * p.svp + slot * p.svs, vr[i]);
    }
#pragma unroll
    for (int i = 0; i < kTok; ++i) {
      const bool valid = t0 + i < len;  // uniform across the warp
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < DPL; ++e) dot += q[g][e] * kr[i][e];
          dot = warp_sum(dot);  // every lane holds the score
          if (!valid) dot = -INFINITY;
          if (dot > m[g]) {     // new running max: rescale (warp-uniform)
            const float alpha = exp2f(m[g] - dot);
            l[g] *= alpha;
#pragma unroll
            for (int e = 0; e < DPL; ++e) acc[g][e] *= alpha;
            m[g] = dot;
          }
          const float pr = exp2f(dot - m[g]);
          l[g] += pr;
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] += pr * vr[i][e];
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) sm_acc[warp][g][lane * DPL + e] = acc[g][e];
  }
  __syncthreads();

  T* ob = static_cast<T*>(p.o) + ((long long)b * p.H + kvh * G) * HD;
  for (int i = threadIdx.x; i < G * HD; i += kWarps * 32) {
    const int g = i / HD;
    const int d = i % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (sm_m[w][g] == -INFINITY) continue;  // warp saw no token
      const float f = exp2f(sm_m[w][g] - mx);
      den += sm_l[w][g] * f;
      num += sm_acc[w][g][d] * f;
    }
    store_from_float(ob + g * HD + d, den > 0.f ? num / den : 0.f);
  }
}

template <typename T, int HD>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.KV, p.B);
  paged_fwd<T, HD><<<grid, kWarps * 32, 0, stream>>>(p);
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

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the output
// is contiguous [B, H, hd]; block_table rows are sbt apart. Returns
// cudaGetLastError() after launch.
extern "C" int paged_decode_fwd(int dtype, int hd, const void* q,
                                const void* k, const void* v,
                                const void* block_table, const void* seq_lens,
                                void* o, int B, int H, int KV, int page,
                                int max_pages, long long sqb, long long sqh,
                                long long skp, long long sks, long long skh,
                                long long svp, long long svs, long long svh,
                                long long sbt, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.block_table = static_cast<const int*>(block_table);
  p.seq_lens = static_cast<const int*>(seq_lens);
  p.B = B; p.H = H; p.KV = KV; p.page = page; p.max_pages = max_pages;
  p.sqb = sqb; p.sqh = sqh;
  p.skp = skp; p.sks = sks; p.skh = skh;
  p.svp = svp; p.svs = svs; p.svh = svh;
  p.sbt = sbt;
  p.scale_log2 = kLog2e / sqrtf((float)hd);
  if (H % KV != 0 || H / KV > kMaxG) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(hd, p, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, p, s);
  return (int)cudaErrorInvalidValue;
}
