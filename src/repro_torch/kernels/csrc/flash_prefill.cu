// Flash attention for prefill: causal, sliding-window or non-causal GQA
// attention with an online softmax, q [B,S,H,hd], k/v [B,T,KV,hd] ->
// o [B,S,H,hd], f32 or bf16 in, f32 accumulation, head dims 32, 64, 80
// (zamba2's shared block) and 128.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_prefill.py,
// _flash_kernel (called through flash_attention).
//
// What bounds it on the H100: at prefill lengths the work is
// 4*S*T_eff*hd*H operations against O((S+T)*hd) bytes, far above the
// card's ~295 operations per byte, so it is bound by arithmetic: the
// 989 TFLOP/s bf16 tensor-core rate, which only wgmma reaches. f32 inputs
// stay exact on the CUDA cores (67 TFLOP/s): TF32 would miss the f32
// tolerance. Besides the products, every score costs softmax work on the
// CUDA cores and one exp2, and every block streams its own K/V tiles
// from L2 (one pass per 128 query rows: 3.3 GB at S = 8192, H = 24);
// overlapping those with the products is what the design below is for.
//
// Design. The TPU grid walks kv blocks in order and carries (m, l, acc)
// in VMEM scratch across grid steps. Here blocks run in no order, so one
// block owns (batch, query head, tile of query rows) and itself loops
// over the K/V tiles. Both paths stop the key loop at the causal diagonal
// of the tile's last row and start it at the window's edge of its first
// row, mask the rest per row (kpos < T, causal, window), keep scores in
// the log2 domain, honour q_offset, read inputs in place by their
// strides, and schedule causal tiles heaviest (last) first. After the
// key loop, both can write each row's log-sum-exp (log2 domain, scale
// folded in: m + log2(l)) for the backward kernel (flash_backward.cu);
// the bf16 kernel has an instantiation with that store and one without,
// for serving. A row that sees no key (window > 0 and q_offset + row >=
// T + window - 1) gets the plain version's answer from a pass of its own
// (keyless_rows), launched only when such rows exist: its scores are all
// masked, so its softmax is uniform over the T keys and its output is
// the mean of V.
//
// bf16 (flash_fwd_hopper): a block owns 128 query rows and has three
// warpgroups. The producer warpgroup gives its registers away
// (setmaxnreg) and one of its threads issues every load as TMA
// (cp.async.bulk.tensor over 4-d tensor maps of the strided inputs, built
// on the host): Q once, then K/V tiles of 64 keys into a ring of 3
// stages, each with a full mbarrier (TMA bytes) and an empty one (one
// arrival per consumer warp). Each of the two consumer warpgroups owns
// 64 query rows and holds them, and O, in registers for the whole key
// loop: Q is read once from its tile into wgmma A fragments; S = Q K^T is
// wgmma m64n64k16 with K (stored [keys][hd], K-major) in shared memory;
// the online softmax works on the accumulator fragments (a thread holds
// 2 rows, so row max and sum take two shuffles; the 1/sqrt(hd) scale
// folds into one fma per score before a single-instruction exp2); P is
// converted in place to the bf16 A fragments of the next product (the
// accumulator layout of 16 keys is the A layout of one k-step); and
// O += P V is wgmma with V, stored [keys][hd], read through the
// transposed (MN-major) descriptor. The loop is software-pipelined: the
// scores of tile j are issued together with P V of tile j-1, and the
// softmax of tile j runs while that product is still on the tensor
// cores. Nothing but the TMA tiles goes through shared memory. TMA
// zero-fills rows past S or T. The tiles are swizzled as wide as a row
// allows: 128-byte rows (hd 64, and hd 128 as two 64-column boxes),
// 64-byte rows (hd 32) and, as 160-byte rows fit no swizzle pattern,
// five 32-byte boxes for hd 80, whose O += P V is then five n16 products
// a k-step. A wait that never completes traps instead of hanging.
//
// f32 (flash_fwd): each tile of 64 keys is staged as f32 and read by
// every row of the block; the running max, denominator and accumulator
// stay in registers. Each query row belongs to NSPLIT = 1 or 2 threads
// (hd 128 is split in two so q and acc fit in registers); the partial dot
// products meet through one shuffle, and the accumulator is rescaled once
// per 16 keys.
#include "hopper.cuh"

namespace {

using namespace repro_torch;
using namespace repro_torch::hopper;

constexpr int kThreads = 128;
constexpr int kBlockK = 64;   // keys staged in shared memory per tile
constexpr int kChunk = 16;    // keys scored between accumulator rescales

struct Params {  // strides in elements
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;   // [B, H, Sp] or null
  int B, S, T, H, KV, Sp;
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

  if (p.lse != nullptr && part == 0 && row < p.Sp)
    p.lse[((long long)b * p.H + h) * p.Sp + row] =
        active && l > 0.f ? m + log2f(l) : 0.f;
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
// bf16 on the tensor cores: wgmma + TMA, warp-specialised
// ----------------------------------------------------------------------
constexpr int kConsumers = 2;                    // warpgroups of query rows
constexpr int kRowsWG = 64;                      // query rows per warpgroup
constexpr int kHopRows = kConsumers * kRowsWG;   // query rows per block
constexpr int kKeys = 64;                        // keys per K/V tile
constexpr int kStages = 3;                       // depth of the K/V ring
constexpr int kHopThreads = (kConsumers + 1) * 128;
// Diagnostic builds only (chip_smoke.py --flash-ablation) switch one part
// of the bf16 kernel off, leaving its output wrong: 1 the softmax
// arithmetic (P = bf16(S)), 2 O += P V, 3 S = Q K^T (S = 0).
#ifndef FLASH_ABLATE
#define FLASH_ABLATE 0
#endif
constexpr int kAblate = FLASH_ABLATE;

template <int HD>
struct HopSmem {  // byte offsets from a 1024-aligned base
  using TL = HopTile<HD>;
  static constexpr int q = 0;                                  // [kConsumers]
  static constexpr int k = q + kConsumers * TL::kTileBytes;    // [kStages]
  static constexpr int v = k + kStages * TL::kTileBytes;       // [kStages]
  static constexpr int bars = v + kStages * TL::kTileBytes;    // full, empty, q
  static constexpr int bytes = bars + (2 * kStages + 1) * 8;
};

struct HopParams {
  void* o;
  float* lse;      // [B, H, Sp] (kLse)
  int B, S, T, H, KV, Sp;
  int causal, window, q_offset;
  float scale_log2;
  // coordinate slot (1..3) of the row, head and batch dims in each map
  int q_row, q_head, q_b, k_row, k_head, k_b, v_row, v_head, v_b;
};

// kLse: also write each row's log-sum-exp (a separate instantiation, so
// that serving's kernel carries none of it).
template <int HD, bool kLse>
__global__ void __launch_bounds__(kHopThreads, 1)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const HopParams p) {
  using TL = HopTile<HD>;
  using SM = HopSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + SM::bars);
  const uint32_t qbar = bars + 16 * kStages;

  const int n_tiles = (p.S + kHopRows - 1) / kHopRows;
  const int h = blockIdx.x;                 // every head's heaviest tile
  const int qt = n_tiles - 1 - blockIdx.y;  // is scheduled first
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int row0 = qt * kHopRows;

  // the keys this block's rows need, in whole tiles
  const int q_first = p.q_offset + row0;
  const int q_last = p.q_offset + min(row0 + kHopRows, p.S) - 1;
  int k_end = p.T;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_first - p.window + 1);
  k_begin = (k_begin / kKeys) * kKeys;
  const int n_kv = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;
  const int n_wg = min(kConsumers, (p.S - row0 + kRowsWG - 1) / kRowsWG);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                         // full: TMA bytes
      mbar_init(bars + 8 * (kStages + s), 4 * kConsumers);  // empty: warps
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, n_wg * TL::kTileBytes);
      for (int w = 0; w < n_wg; ++w) {
        const int row = row0 + w * kRowsWG;
        for (int bx = 0; bx < TL::kBoxes; ++bx)
          tma_load(smem + SM::q + w * TL::kTileBytes + bx * TL::kBoxBytes, &mq,
                   qbar, bx * TL::kBoxD,
                   coord(1, p.q_row, p.q_head, row, h, b),
                   coord(2, p.q_row, p.q_head, row, h, b),
                   coord(3, p.q_row, p.q_head, row, h, b));
      }
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStages;
        const uint32_t full = bars + 8 * st;
        mbar_wait(bars + 8 * (kStages + st), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * TL::kTileBytes);
        const int k0 = k_begin + it * kKeys;
        for (int bx = 0; bx < TL::kBoxes; ++bx) {
          tma_load(smem + SM::k + st * TL::kTileBytes + bx * TL::kBoxBytes,
                   &mk, full, bx * TL::kBoxD,
                   coord(1, p.k_row, p.k_head, k0, kvh, b),
                   coord(2, p.k_row, p.k_head, k0, kvh, b),
                   coord(3, p.k_row, p.k_head, k0, kvh, b));
          tma_load(smem + SM::v + st * TL::kTileBytes + bx * TL::kBoxBytes,
                   &mv, full, bx * TL::kBoxD,
                   coord(1, p.v_row, p.v_head, k0, kvh, b),
                   coord(2, p.v_row, p.v_head, k0, kvh, b),
                   coord(3, p.v_row, p.v_head, k0, kvh, b));
        }
      }
    }
    return;
  }

  // consumer warpgroups: 64 query rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;
  const int ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32, g = lane / 4, tq = lane % 4;
  const bool has_rows = cw < n_wg;
  const int wrow0 = row0 + cw * kRowsWG;
  const int r0 = wrow0 + warp * 16 + g, r1 = r0 + 8;   // this thread's rows
  const int qp0 = p.q_offset + r0, qp1 = p.q_offset + r1;
  const int wq_first = p.q_offset + wrow0;
  const int wq_last = p.q_offset + min(wrow0 + kRowsWG, p.S) - 1;
  int wk_end = p.T;
  if (p.causal) wk_end = min(wk_end, wq_last + 1);
  int wk_begin = 0;
  if (p.window > 0) wk_begin = max(0, wq_first - p.window + 1);
  // the ring's tiles [it_lo, it_hi) hold keys of these rows
  int it_lo = 0, it_hi = 0;
  if (has_rows && wk_end > k_begin) {
    it_lo = min(n_kv, max(0, (wk_begin - k_begin) / kKeys));
    it_hi = min(n_kv, (wk_end - k_begin + kKeys - 1) / kKeys);
  }

  // O accumulator in the wgmma layout: o[4j + e] is row r0 (e < 2) or r1,
  // column 8j + 2tq + (e & 1)
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const unsigned char* Qs = smem + SM::q + cw * TL::kTileBytes;
  // Q as wgmma A fragments in registers, read once from its swizzled
  // tile (16-byte chunk c of row r sits at chunk c ^ (r's swizzle phase))
  uint32_t qa[HD / 16][4];
  if (has_rows) {
    mbar_wait(qbar, 0);
    constexpr int kMask = TL::kRowBytes / 16 - 1;
    const int row = warp * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int bx = kk * 16 / TL::kBoxD;
      const int chunk = (kk * 16 % TL::kBoxD) / 8 + (lane >> 4);
      const int phase = ((row * TL::kRowBytes) >> 7) & kMask;
      ldsm_x4(qa[kk], Qs + bx * TL::kBoxBytes + row * TL::kRowBytes +
                          ((chunk ^ phase) << 4));
    }
  }

  auto full_wait = [&](int it) {
    mbar_wait(bars + 8 * (it % kStages), (it / kStages) & 1);
  };
  auto release = [&](int it) {   // one arrival per consumer warp
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + it % kStages));
  };
  // S = Q K^T of ring tile `it` (Q from registers, K K-major), issued
  auto issue_qk = [&](float (&s)[32], int it) {
    if constexpr (kAblate == 3) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      return;
    }
    const unsigned char* Ks = smem + SM::k + (it % kStages) * TL::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int bx = kk * 16 / TL::kBoxD;
      const int off = bx * TL::kBoxBytes + (kk * 16 % TL::kBoxD) * 2;
      wgmma_rs_n64_k(s, qa[kk], make_desc(Ks + off, 16, TL::kSbo, TL::kLayout),
                     kk > 0);
    }
  };
  // O += P V of ring tile `it` (V is MN-major: the transposed descriptor)
  auto issue_pv = [&](const uint32_t (&pa)[4][4], int it) {
    if constexpr (kAblate == 2) return;
    const unsigned char* Vs = smem + SM::v + (it % kStages) * TL::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int bx = 0; bx < TL::kBoxes; ++bx) {
        const uint64_t dv =
            make_desc(Vs + bx * TL::kBoxBytes + kk * 16 * TL::kRowBytes,
                      TL::kSbo, TL::kSbo, TL::kLayout);
        float* ob = o + bx * (TL::kBoxD / 2);
        if constexpr (TL::kBoxD == 64) wgmma_rs_n64(ob, pa[kk], dv);
        else if constexpr (TL::kBoxD == 32) wgmma_rs_n32(ob, pa[kk], dv);
        else wgmma_rs_n16(ob, pa[kk], dv);
      }
  };
  // online softmax of tile `it`'s scores in the log2 domain, on the
  // accumulator fragments: P goes to pa as bf16 A fragments (the
  // accumulator layout of 16 keys is the A layout of one k-step); returns
  // the factors that rescale O
  auto softmax = [&](float (&s)[32], uint32_t (&pa)[4][4], int it,
                     float& alpha0, float& alpha1) {
    if constexpr (kAblate == 1) {
      alpha0 = alpha1 = 1.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      return;
    }
    const int k0 = k_begin + it * kKeys;
    const bool masked = k0 + kKeys > p.T ||
                        (p.causal && k0 + kKeys - 1 > wq_first) ||
                        (p.window > 0 && k0 <= wq_last - p.window);
    float mx0 = -INFINITY, mx1 = -INFINITY;   // of the raw scores
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e];
        if (masked) {
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          bool ok = key < p.T;
          if (p.causal) ok = ok && key <= qp;
          if (p.window > 0) ok = ok && key > qp - p.window;
          x = ok ? x : -INFINITY;
        }
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // m is kept scaled (log2 domain); the scale is > 0, so it commutes
    // with the max and folds into one fma per score
    const float sc = p.scale_log2;
    const float mn0 = fmaxf(m0, mx0 * sc), mn1 = fmaxf(m1, mx1 * sc);
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    alpha0 = fast_exp2(m0 - base0);
    alpha1 = fast_exp2(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = fast_exp2(fmaf(s[4 * j], sc, -base0));
      s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], sc, -base0));
      s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], sc, -base1));
      s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], sc, -base1));
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };
  auto rescale = [&](float alpha0, float alpha1) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
  };
  auto keep = [&](uint32_t (&pa)[4][4]) {   // pa stays live until here
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pa[kk][r])::"memory");
  };

  for (int it = 0; it < it_lo; ++it) {   // tiles before these rows' keys
    full_wait(it);
    release(it);
  }
  if (it_lo < it_hi) {
    float s[32], alpha0, alpha1;
    uint32_t pa[4][4], pn[4][4];
    full_wait(it_lo);
    wgmma_fence();
    issue_qk(s, it_lo);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(s);
    softmax(s, pa, it_lo, alpha0, alpha1);
    // Pipelined: the scores of tile it are computed while P V of tile
    // it-1 is in flight, and its softmax overlaps that product.
    for (int it = it_lo + 1; it < it_hi; ++it) {
      full_wait(it);
      fence_regs<HD / 2>(o);
      wgmma_fence();
      issue_qk(s, it);
      wgmma_commit();
      issue_pv(pa, it - 1);
      wgmma_commit();
      wgmma_wait<1>();          // the scores are in; P V may still run
      fence_regs<32>(s);
      softmax(s, pn, it, alpha0, alpha1);
      wgmma_wait<0>();
      fence_regs<HD / 2>(o);
      keep(pa);
      release(it - 1);
      rescale(alpha0, alpha1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[kk][r] = pn[kk][r];
    }
    fence_regs<HD / 2>(o);
    wgmma_fence();
    issue_pv(pa, it_hi - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<HD / 2>(o);
    keep(pa);
    release(it_hi - 1);
  }
  for (int it = max(it_hi, it_lo); it < n_kv; ++it) {  // tiles past them
    full_wait(it);
    release(it);
  }

  if (!has_rows) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  if (kLse && tq == 0) {   // log2 domain, scale folded in
    float* lse = p.lse + ((long long)b * p.H + h) * p.Sp;
    if (r0 < p.Sp) lse[r0] = r0 < p.S && l0 > 0.f ? m0 + log2f(l0) : 0.f;
    if (r1 < p.Sp) lse[r1] = r1 < p.S && l1 > 0.f ? m1 + log2f(l1) : 0.f;
  }
  bf16* ob = static_cast<bf16*>(p.o) + (long long)h * HD + 2 * tq;
  const long long row_stride = (long long)p.H * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r0 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(
          ob + ((long long)b * p.S + r0) * row_stride + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (r1 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(
          ob + ((long long)b * p.S + r1) * row_stride + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

template <int HD, bool kLse>
int launch_hopper(const Params& p, cudaStream_t stream) {
  using TL = HopTile<HD>;
  constexpr int smem = HopSmem<HD>::bytes + 1024;   // + alignment slack
  const CUtensorMapSwizzle swizzle = tile_swizzle<HD>();
  HopParams hp;
  hp.o = p.o;
  hp.lse = p.lse;
  hp.B = p.B; hp.S = p.S; hp.T = p.T; hp.H = p.H; hp.KV = p.KV; hp.Sp = p.Sp;
  hp.causal = p.causal; hp.window = p.window; hp.q_offset = p.q_offset;
  hp.scale_log2 = p.scale_log2;
  CUtensorMap mq, mk, mv;
  int slot[3];
  int err = encode_map(&mq, slot, p.q, HD, p.S, p.H, p.B, p.sqs, p.sqh, p.sqb,
                       TL::kBoxD, swizzle);
  if (err) return err;
  hp.q_row = slot[0]; hp.q_head = slot[1]; hp.q_b = slot[2];
  err = encode_map(&mk, slot, p.k, HD, p.T, p.KV, p.B, p.sks, p.skh, p.skb,
                   TL::kBoxD, swizzle);
  if (err) return err;
  hp.k_row = slot[0]; hp.k_head = slot[1]; hp.k_b = slot[2];
  err = encode_map(&mv, slot, p.v, HD, p.T, p.KV, p.B, p.svs, p.svh, p.svb,
                   TL::kBoxD, swizzle);
  if (err) return err;
  hp.v_row = slot[0]; hp.v_head = slot[1]; hp.v_b = slot[2];
  static bool attr_set = false;   // once per process and head dim
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_hopper<HD, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid(p.H, (p.S + kHopRows - 1) / kHopRows, p.B);
  flash_fwd_hopper<HD, kLse><<<grid, kHopThreads, smem, stream>>>(mq, mk, mv,
                                                                 hp);
  return (int)cudaGetLastError();
}

template <bool kLse>
int dispatch_bf16(int hd, const Params& p, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hopper<32, kLse>(p, stream);
    case 64: return launch_hopper<64, kLse>(p, stream);
    case 80: return launch_hopper<80, kLse>(p, stream);
    case 128: return launch_hopper<128, kLse>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------------
// rows that see no key
// ----------------------------------------------------------------------
// A row that no key is visible to (window > 0 and q_offset + row >= T +
// window - 1: rows [first, S)) gets the plain version's answer: its
// scores are all masked, so its softmax is uniform over the T keys and
// its output is the mean of V. The key loops leave such rows 0 (and
// their log-sum-exp 0); this pass, launched only when they exist, writes
// them: a block per (row, head, batch), a thread per column, a plain
// loop over the T keys.
template <typename T>
__global__ void keyless_rows(const Params p, int first, int hd) {
  const int row = first + blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x;
  if (d >= hd) return;
  const int kvh = h / (p.H / p.KV);
  const T* v = static_cast<const T*>(p.v) + b * p.svb + kvh * p.svh + d;
  float sum = 0.f;
  for (int t = 0; t < p.T; ++t) sum += to_float(v[t * p.svs]);
  store_from_float(static_cast<T*>(p.o) +
                       (((long long)b * p.S + row) * p.H + h) * hd + d,
                   sum * (1.f / p.T));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the output
// is contiguous [B, S, H, hd]; lse, where not null, is f32 [B, H, Sp],
// Sp = S rounded up to 64: per query row the log-sum-exp of its scores in
// the log2 domain with the scale folded in (log2(sum 2^(s * log2(e) /
// sqrt(hd)))), 0 for a row that sees no key and for the rows past S.
// Returns cudaGetLastError() after launch.
extern "C" int flash_prefill_fwd_lse(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o,
    int B, int S, int T, int H, int KV, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh, long long svb,
    long long svs, long long svh, int causal, int window, int q_offset,
    void* lse, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = B; p.S = S; p.T = T; p.H = H; p.KV = KV;
  p.Sp = (S + 63) / 64 * 64;
  p.sqb = sqb; p.sqs = sqs; p.sqh = sqh;
  p.skb = skb; p.sks = sks; p.skh = skh;
  p.svb = svb; p.svs = svs; p.svh = svh;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale_log2 = kLog2e / sqrtf((float)hd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = (int)cudaErrorInvalidValue;
  if (dtype == 0) err = dispatch_f32(hd, p, s);
  if (dtype == 1)
    err = lse ? dispatch_bf16<true>(hd, p, s) : dispatch_bf16<false>(hd, p, s);
  const int past = T + window - 1 - q_offset;   // rows from here see no key
  const int first = window <= 0 ? S : past > 0 ? past : 0;
  if (err || first >= S) return err;
  const dim3 grid(S - first, H, B);
  if (dtype == 0) keyless_rows<float><<<grid, hd, 0, s>>>(p, first, hd);
  else keyless_rows<bf16><<<grid, hd, 0, s>>>(p, first, hd);
  return (int)cudaGetLastError();
}

// flash_prefill_fwd_lse without the log-sum-exp: what serving calls.
extern "C" int flash_prefill_fwd(int dtype, int hd, const void* q,
                                 const void* k, const void* v, void* o, int B,
                                 int S, int T, int H, int KV, long long sqb,
                                 long long sqs, long long sqh, long long skb,
                                 long long sks, long long skh, long long svb,
                                 long long svs, long long svh, int causal,
                                 int window, int q_offset, void* stream) {
  return flash_prefill_fwd_lse(dtype, hd, q, k, v, o, B, S, T, H, KV, sqb,
                               sqs, sqh, skb, sks, skh, svb, svs, svh, causal,
                               window, q_offset, nullptr, stream);
}
