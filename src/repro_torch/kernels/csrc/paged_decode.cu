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
// the live pages at line rate from enough SMs and read nothing else.
//
// Design: split-KV. The TPU grid walks one sequence's pages in order per
// (batch, kv head); one block per (batch, kv head) would put 8-32 blocks
// on 132 SMs. Here the page walk of each row is cut into `splits` runs
// of `split_pages` whole pages (the wrapper's plan, from host-known sizes
// only), and the grid is (split, kv head, batch):
//   - a block reads its slice of the block-table row into shared memory
//     once; a split that starts past seq_len exits at once (a live split
//     count per row follows from seq_len on the device);
//   - each of its W warps (8, or 4 for f32 at hd 128: one block per SM)
//     owns every W-th tile of 16 tokens and streams its tiles through
//     its own 3-stage shared-memory ring with cp.async
//     (16 bytes a lane, rows read in place from the [P,page,KV,hd] pool,
//     chunks XOR-swizzled), issuing tile k+2 before computing tile k, so
//     a warp needs only __syncwarp, never a block barrier, in its loop;
//   - bf16: the G <= 8 query heads of the kv head are the rows of an
//     mma.sync m16n8k16 A operand (padded to 16), so a tile's scores for
//     all heads are 2*hd/16 products read by ldmatrix, the probabilities
//     stay in registers as the A operand of O += P V (ldmatrix.trans of
//     V), and each head takes one max (2 shuffles) per tile;
//   - f32 (CUDA cores, same structure): a lane holds one token and half
//     of hd, so a score costs one shuffle; probabilities go through
//     shared memory to lanes that hold hd/32 dims each of O;
//   - the warps' (m, l, O) merge in shared memory; a row with one live
//     split writes o directly. Otherwise each split writes its partial
//     (O unnormalised, m, l) in f32 to the workspace [B,KV,splits,G,hd+2]
//     and takes a ticket (atomicAdd after __threadfence); the last live
//     split of the row merges all partials (skipping any with m = -inf),
//     writes o and resets the row's ticket to 0 for the next call, so a
//     call is one device operation.
#include <type_traits>

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int kTile = 16;           // tokens per tile
constexpr int kStages = 3;          // ring depth per warp
constexpr int kMaxG = 8;            // query heads per kv head
constexpr int kMaxSplitPages = 256; // block-table entries a split holds
constexpr int kMaxSplits = 512;     // partials the merge weighs in smem

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* block_table;
  const int* seq_lens;
  void* o;
  float* ws;       // [B, KV, splits, G, hd + 2] partials (splits > 1)
  int* tickets;    // [B * KV], 0 between calls
  int B, H, KV, page, max_pages, splits, split_pages;
  long long sqb, sqh;
  long long skp, sks, skh, svp, svs, svh;
  long long sbt;
  float scale_log2;
};

// Warps of one block and its shared memory, in bytes from the dynamic
// base: 8 warps where their rings fit in 200 KB (one block per SM), else
// 4 (f32 at hd 128).
template <typename T, int HD>
struct Cfg {
  static constexpr int kTileElems = kTile * HD;
  static constexpr int kWarps =
      8 * kStages * 2 * kTileElems * sizeof(T) <= 200 * 1024 ? 8 : 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRing = kWarps * kStages * 2 * kTileElems * sizeof(T);
  // the warps' (m, l, O) for the block merge, over the ring once done
  static constexpr int kMerge = kWarps * kMaxG * (HD + 2) * 4;
  static constexpr int kBt = 0;
  static constexpr int kOffs = kBt + kMaxSplitPages * 4;   // row offsets
  static constexpr int kMain = kOffs + kWarps * 2 * kTile * 8;
  static constexpr int kQ = kMain + (kRing > kMerge ? kRing : kMerge);
  static constexpr int kP = kQ + kMaxG * HD * 4;            // f32 only
  static constexpr int kBytes =
      sizeof(T) == 4 ? kP + kWarps * kMaxG * kTile * 4 : kQ;
  // the last split's merge weighs up to kMaxSplits partials there too
  static_assert(kRing >= kMaxSplits * kMaxG * 4, "ring too small");
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
// (src is not read).
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulation.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &h, 4);
  return r;
}

// The 16-byte chunk where logical chunk c of tile row r is stored: rows
// of CH chunks, XOR-swizzled so that 8 consecutive rows' chunk c fall in
// 8 different bank groups (ldmatrix and lane-per-row reads).
template <int CH>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (CH >= 8) return c ^ (r & 7);
  else return c ^ ((r >> 1) & (CH - 1));    // CH == 4: 64-byte rows
}

// One online-softmax step of a head: the running max m takes the tile's
// max; returns the factor that rescales l and O, and sets m_use, the
// exponent base (0 while every score so far is masked, so -inf never
// meets -inf).
__device__ __forceinline__ float online_step(float& m, float tile_max,
                                             float& m_use) {
  const float m_new = fmaxf(m, tile_max);
  m_use = m_new == -INFINITY ? 0.f : m_new;
  const float alpha = exp2f(m - m_use);
  m = m_new;
  return alpha;
}

// Warp-cooperative copy of one tile (kTile tokens from t0, rows at or
// past t_end zero-filled) of K and V for kv head kvh into ring slots ks,
// vs. Lanes 0-15 first turn the tile's rows into pool offsets.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const Params& p, const int* bt_s,
                                          long long* offs, int tok0, int t0,
                                          int t_end, int kvh, T* ks, T* vs,
                                          int lane) {
  constexpr int kEpc = 16 / sizeof(T);     // elements per chunk
  constexpr int CH = HD / kEpc;            // chunks per row
  constexpr int kPer = kTile * CH / 32;    // chunks per lane per tile
  __syncwarp();                            // earlier readers of offs done
  if (lane < kTile) {
    const int t = min(t0 + lane, t_end - 1);
    // the split starts on a page: its pages are local, slots are t % page
    const int i = (t - tok0) / p.page;
    const int slot = t - tok0 - i * p.page;
    const long long pg = bt_s[i];
    offs[lane] = pg * p.skp + slot * p.sks;
    offs[kTile + lane] = pg * p.svp + slot * p.svs;
  }
  __syncwarp();
  const T* kb = static_cast<const T*>(p.k) + kvh * p.skh;
  const T* vb = static_cast<const T*>(p.v) + kvh * p.svh;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = lane + 32 * j;
    const int r = i / CH;
    const int c = i % CH;
    const bool valid = t0 + r < t_end;
    const int dst = r * HD + swz<CH>(r, c) * kEpc;
    copy16(ks + dst, kb + offs[r] + c * kEpc, valid);
    copy16(vs + dst, vb + offs[kTile + r] + c * kEpc, valid);
  }
}

// ----------------------------------------------------------------------
// bf16: scores and O += P V on mma.sync, heads as the A operand's rows
// ----------------------------------------------------------------------
template <int HD>
struct WarpBf16 {
  using T = __nv_bfloat16;
  static constexpr int CH = HD / 8;
  uint32_t qa[HD / 16][4];   // Q rows g = lane/4 as A fragments; rows 8-15 0
  float o[HD / 8][4];        // O accumulators (rows 8-15 unused)
  float m, l;                // head lane/4; l is this lane's share

  __device__ __forceinline__ void init(const Params& p, int b, int kvh,
                                       int G, int lane) {
    const int g = lane >> 2;
    const T* qr = static_cast<const T*>(p.q) + b * p.sqb +
                  (long long)(kvh * G + g) * p.sqh + 2 * (lane & 3);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t lo = 0, hi = 0;
      if (g < G) {
        lo = *reinterpret_cast<const uint32_t*>(qr + 16 * ks);
        hi = *reinterpret_cast<const uint32_t*>(qr + 16 * ks + 8);
      }
      qa[ks][0] = lo;
      qa[ks][1] = 0u;
      qa[ks][2] = hi;
      qa[ks][3] = 0u;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    m = -INFINITY;
    l = 0.f;
  }

  __device__ __forceinline__ void tile(const Params& p, const T* ks,
                                       const T* vs, int t0, int t_end,
                                       int lane) {
    // S = Q K^T for the tile's 16 tokens: two n8 column blocks
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int mi = lane >> 3;
      const int row = (mi >> 1) * 8 + (lane & 7);
      const uint32_t base = smem_u32(ks + row * HD);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, base + swz<CH>(row, 2 * kk + (mi & 1)) * 16);
        mma16816(s[0], qa[kk], b[0], b[1]);
        mma16816(s[1], qa[kk], b[2], b[3]);
      }
    }
    float x[4];
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = t0 + 8 * nt + 2 * (lane & 3) + e;
        const float v = t < t_end ? s[nt][e] * p.scale_log2 : -INFINITY;
        x[2 * nt + e] = v;
        mx = fmaxf(mx, v);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float m_use;
    const float alpha = online_step(m, mx, m_use);
    float pr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) pr[e] = exp2f(x[e] - m_use);
    l = l * alpha + (pr[0] + pr[1] + pr[2] + pr[3]);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j][0] *= alpha;
      o[j][1] *= alpha;
    }
    // P as the A operand: k = tokens, rows 8-15 zero
    const uint32_t pa[4] = {pack_bf16(pr[0], pr[1]), 0u,
                            pack_bf16(pr[2], pr[3]), 0u};
    const int mi = lane >> 3;
    const int row = (mi & 1) * 8 + (lane & 7);
    const uint32_t base = smem_u32(vs + row * HD);
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      uint32_t b[4];
      ldsm_x4_t(b, base + swz<CH>(row, 2 * jj + (mi >> 1)) * 16);
      mma16816(o[2 * jj], pa, b[0], b[1]);
      mma16816(o[2 * jj + 1], pa, b[2], b[3]);
    }
  }

  // this warp's (m, l, O) for head g into the merge area
  __device__ __forceinline__ void finish(float* m_s, float* l_s,
                                         float* acc_s, int G, int lane) {
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int g = lane >> 2;
    if (g >= G) return;
    if ((lane & 3) == 0) {
      m_s[g] = m;
      l_s[g] = l;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc_s[g * HD + 8 * j + 2 * (lane & 3)] = o[j][0];
      acc_s[g * HD + 8 * j + 2 * (lane & 3) + 1] = o[j][1];
    }
  }
};

// ----------------------------------------------------------------------
// f32: the same structure on the CUDA cores
// ----------------------------------------------------------------------
template <int HD>
struct WarpF32 {
  using T = float;
  static constexpr int CH = HD / 4;
  static constexpr int DPL = HD / 32;   // O dims per lane
  const float* q_s;                     // [kMaxG][HD], times scale_log2
  float* p_s;                           // this warp's [kMaxG][kTile]
  float acc[kMaxG][DPL];
  float m[kMaxG], l[kMaxG];             // l: this lane's share (half 0)
  int G;

  __device__ __forceinline__ void init(const float* q, float* p, int g_,
                                       int) {
    q_s = q;
    p_s = p;
    G = g_;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
    }
  }

  __device__ __forceinline__ void tile(const Params&, const T* ks,
                                       const T* vs, int t0, int t_end,
                                       int lane) {
    // lane: token t, half h of hd
    const int t = lane & 15;
    const int h = lane >> 4;
    float sc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) sc[g] = 0.f;
#pragma unroll 4
    for (int c = 0; c < CH / 2; ++c) {
      const int cc = h * (CH / 2) + c;
      const float4 kv =
          *reinterpret_cast<const float4*>(ks + t * HD + swz<CH>(t, cc) * 4);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float4 qv =
              *reinterpret_cast<const float4*>(q_s + g * HD + cc * 4);
          sc[g] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
    }
    const bool valid = t0 + t < t_end;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float s = sc[g] + __shfl_xor_sync(0xffffffffu, sc[g], 16);
        s = valid ? s : -INFINITY;
        float mx = s;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float m_use;
        const float alpha = online_step(m[g], mx, m_use);
        const float pr = exp2f(s - m_use);
        l[g] = l[g] * alpha + (h == 0 ? pr : 0.f);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] *= alpha;
        if (h == 0) p_s[g * kTile + t] = pr;
      }
    }
    __syncwarp();
    // O += P V: lane holds dims lane*DPL ..
    const int d0 = lane * DPL;
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float vr[DPL];
      load_widen<float, DPL>(
          vs + r * HD + swz<CH>(r, d0 / 4) * 4 + d0 % 4, vr);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float pg = p_s[g * kTile + r];
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] += pg * vr[e];
        }
      }
    }
  }

  __device__ __forceinline__ void finish(float* m_s, float* l_s,
                                         float* acc_s, int, int lane) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float lg = l[g];
        for (int off = 16; off > 0; off >>= 1)
          lg += __shfl_xor_sync(0xffffffffu, lg, off);
        if (lane == 0) {
          m_s[g] = m[g];
          l_s[g] = lg;
        }
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc_s[g * HD + lane * DPL + e] = acc[g][e];
      }
    }
  }
};

template <typename T, int HD>
using Warp = typename std::conditional<sizeof(T) == 2, WarpBf16<HD>,
                                       WarpF32<HD>>::type;

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::kThreads)
    paged_split(const Params p) {
  using S = Cfg<T, HD>;
  constexpr int kWarps = S::kWarps;
  constexpr int kThreads = S::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  int* bt_s = reinterpret_cast<int*>(smem + S::kBt);

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the slice of the block-table row is read at once, beside seq_len
  // and not after it: entries past seq_len are read but never used
  const int* bt = p.block_table + b * p.sbt + split * p.split_pages;
  const int npages = min(p.split_pages, p.max_pages - split * p.split_pages);
  for (int i = threadIdx.x; i < npages; i += kThreads) bt_s[i] = bt[i];
  const int len = min(max(p.seq_lens[b], 0), p.max_pages * p.page);
  const int split_tok = p.split_pages * p.page;
  const int live = max(1, (len + split_tok - 1) / split_tok);
  if (split >= live) return;              // past seq_len: nothing to do
  const int tok0 = split * split_tok;
  const int t_end = min(tok0 + split_tok, len);
  const int ntok = max(t_end - tok0, 0);

  Warp<T, HD> w;
  if constexpr (sizeof(T) == 4) {
    float* q_s = reinterpret_cast<float*>(smem + S::kQ);
    const float* qb = static_cast<const float*>(p.q) + b * p.sqb;
    for (int i = threadIdx.x; i < G * HD; i += kThreads)
      q_s[i] = qb[(long long)(kvh * G + i / HD) * p.sqh + i % HD] *
               p.scale_log2;
    w.init(q_s,
           reinterpret_cast<float*>(smem + S::kP) + warp * kMaxG * kTile, G,
           lane);
  } else {
    w.init(p, b, kvh, G, lane);
  }
  __syncthreads();

  // this warp's tiles: warp, warp + kWarps, ... through a kStages ring
  const int ntiles = (ntok + kTile - 1) / kTile;
  const int mine = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps : 0;
  T* ring = reinterpret_cast<T*>(smem + S::kMain) +
            warp * kStages * 2 * S::kTileElems;
  long long* offs = reinterpret_cast<long long*>(smem + S::kOffs) +
                    warp * 2 * kTile;
  auto prefetch = [&](int k) {
    if (k < mine) {
      T* ks = ring + (k % kStages) * 2 * S::kTileElems;
      load_tile<T, HD>(p, bt_s, offs, tok0, tok0 + (warp + k * kWarps) * kTile,
                       t_end, kvh, ks, ks + S::kTileElems, lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) prefetch(k);
  for (int k = 0; k < mine; ++k) {
    cp_async_wait<kStages - 2>();
    __syncwarp();                         // tile k landed for every lane
    prefetch(k + kStages - 1);            // into the slot tile k-1 used
    const T* ks = ring + (k % kStages) * 2 * S::kTileElems;
    w.tile(p, ks, ks + S::kTileElems, tok0 + (warp + k * kWarps) * kTile,
           t_end, lane);
  }
  cp_async_wait<0>();
  __syncthreads();                        // the ring becomes the merge area

  float* m_s = reinterpret_cast<float*>(smem + S::kMain);
  float* l_s = m_s + kWarps * kMaxG;
  float* acc_s = l_s + kWarps * kMaxG;
  w.finish(m_s + warp * kMaxG, l_s + warp * kMaxG,
           acc_s + warp * kMaxG * HD, G, lane);
  __syncthreads();

  T* ob = static_cast<T*>(p.o) + ((long long)b * p.H + kvh * G) * HD;
  float* row = p.ws + ((((long long)b * p.KV + kvh) * p.splits + split) * G) *
                          (HD + 2);
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, m_s[v * kMaxG + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float mv = m_s[v * kMaxG + g];
      if (mv == -INFINITY) continue;      // warp saw no token
      const float f = exp2f(mv - mx);
      den += l_s[v * kMaxG + g] * f;
      num += acc_s[(v * kMaxG + g) * HD + d] * f;
    }
    if (live == 1) {
      store_from_float(ob + g * HD + d, den > 0.f ? num / den : 0.f);
    } else {
      row[g * (HD + 2) + d] = num;
      if (d == 0) {
        row[g * (HD + 2) + HD] = mx;
        row[g * (HD + 2) + HD + 1] = den;
      }
    }
  }
  if (live == 1) return;

  // the last live split of (b, kvh) to finish merges every partial
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  int* ticket = p.tickets + b * p.KV + kvh;
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == live - 1;
    if (last) *ticket = 0;                // every live split has counted
  }
  __syncthreads();
  if (!last) return;
  // (the merge area is free again: read back above, before the fence)
  __shared__ float red_s[kWarps][kMaxG];
  __shared__ float mrow_s[kMaxG], den_s[kMaxG];
  float* w_s = reinterpret_cast<float*>(smem + S::kMain);  // [live][kMaxG]
  __threadfence();
  const long long stride = (long long)G * (HD + 2);
  const float* rows = p.ws + ((long long)b * p.KV + kvh) * p.splits * stride;
  // 1: each head's max over the partials, the splits spread over threads
  float r8[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) r8[g] = -INFINITY;
  for (int s = threadIdx.x; s < live; s += kThreads)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) r8[g] = fmaxf(r8[g], __ldcg(rows + s * stride +
                                             g * (HD + 2) + HD));
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      float x = r8[g];
      for (int off = 16; off > 0; off >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
      if (lane == 0) red_s[warp][g] = x;
    }
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float x = red_s[0][threadIdx.x];
    for (int v = 1; v < kWarps; ++v) x = fmaxf(x, red_s[v][threadIdx.x]);
    mrow_s[threadIdx.x] = x;
    den_s[threadIdx.x] = 0.f;
  }
  __syncthreads();
  // 2: each partial's weight 2^(m - max), 0 for one that saw no token,
  // and the denominators
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) r8[g] = 0.f;
  for (int s = threadIdx.x; s < live; s += kThreads) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float* r = rows + s * stride + g * (HD + 2);
        const float ms = __ldcg(r + HD);
        const float f = ms == -INFINITY ? 0.f : exp2f(ms - mrow_s[g]);
        w_s[s * kMaxG + g] = f;
        r8[g] += __ldcg(r + HD + 1) * f;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      const float x = warp_sum(r8[g]);
      if (lane == 0) atomicAdd(&den_s[g], x);
    }
  }
  __syncthreads();
  // 3: the numerators; the loads of one output are independent
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    const float* r = rows + g * (HD + 2) + d;
    float num = 0.f;
#pragma unroll 8
    for (int s = 0; s < live; ++s)
      num += __ldcg(r + s * stride) * w_s[s * kMaxG + g];
    const float den = den_s[g];
    store_from_float(ob + g * HD + d, den > 0.f ? num / den : 0.f);
  }
}

template <typename T, int HD>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = Cfg<T, HD>::kBytes;
  static bool configured[64] = {};        // once per instance and device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(paged_split<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const dim3 grid(p.splits, p.KV, p.B);
  paged_split<T, HD><<<grid, Cfg<T, HD>::kThreads, bytes, stream>>>(p);
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
// is contiguous [B, H, hd]; block_table rows are sbt apart. The plan:
// `splits` runs of `split_pages` pages per row (split_pages <= 256,
// splits <= 512, splits * split_pages >= max_pages); ws holds B*KV*splits*G*(hd+2)
// floats and tickets B*KV zeroed ints when splits > 1. Returns
// cudaGetLastError() after launch.
extern "C" int paged_decode_fwd(int dtype, int hd, const void* q,
                                const void* k, const void* v,
                                const void* block_table, const void* seq_lens,
                                void* o, void* ws, void* tickets, int B,
                                int H, int KV, int page, int max_pages,
                                int splits, int split_pages, long long sqb,
                                long long sqh, long long skp, long long sks,
                                long long skh, long long svp, long long svs,
                                long long svh, long long sbt, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.block_table = static_cast<const int*>(block_table);
  p.seq_lens = static_cast<const int*>(seq_lens);
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<int*>(tickets);
  p.B = B; p.H = H; p.KV = KV; p.page = page; p.max_pages = max_pages;
  p.splits = splits; p.split_pages = split_pages;
  p.sqb = sqb; p.sqh = sqh;
  p.skp = skp; p.sks = sks; p.skh = skh;
  p.svp = svp; p.svs = svs; p.svh = svh;
  p.sbt = sbt;
  p.scale_log2 = kLog2e / sqrtf((float)hd);
  if (H % KV != 0 || H / KV > kMaxG || page < 1 || split_pages < 1 ||
      split_pages > kMaxSplitPages || splits > kMaxSplits ||
      (long long)splits * split_pages < max_pages ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_hd<float>(hd, p, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, p, s);
  return (int)cudaErrorInvalidValue;
}
