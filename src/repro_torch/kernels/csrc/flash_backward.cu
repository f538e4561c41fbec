// Flash attention's backward: dQ, dK and dV of the function that
// kernels/ref.py::flash_attention_ref computes (causal or not, sliding
// window, q_offset, ragged S != T, GQA with H % KV == 0), for q, o, dO
// [B,S,H,hd] and k/v [B,T,KV,hd], all contiguous, f32 or bf16 in and out,
// f32 accumulation, head dims 32, 64, 80 and 128, given the log-sum-exp
// of each query row that the forward kernel (flash_prefill.cu,
// flash_prefill_fwd_lse) wrote. A query row that the masks leave without
// a key follows the plain version: its scores are all -1e30, so its
// softmax is uniform, 1/T over the T keys; dV gets dO/T at every key, and
// its scores get no gradient (dQ = 0, nothing into dK).
//
// There is no Pallas backward to replace: the reference trains through
// jax.value_and_grad over src/repro/kernels/ref.py::flash_attention_ref.
//
// What bounds it on the H100: per visible (query, key) pair the backward
// does five products of length hd (S = Q K^T, dP = dO V^T, dV += P^T dO,
// dK += dS^T Q, dQ += dS K), 10 hd operations, against O((S+T) hd) bytes:
// far above the card's ~295 operations per byte, so arithmetic bounds it
// (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 on the CUDA
// cores). S and dP are computed twice, once for dK/dV and once for dQ, so
// the kernels execute 14 hd operations per pair; in exchange nothing is
// summed across blocks, so there are no atomics and the gradients are
// deterministic: each output element is written by one thread, once,
// after a fixed loop order.
//
// First bwd_delta, D = rowsum(dO * O) per query row in f32 (a pass over
// dO and O, bound by bytes); then dK/dV blocks, which own keys and loop
// over the query tiles of all G heads of their group, and dQ blocks,
// which own query rows of one head and loop over their key tiles. Each
// loop runs over the tiles that some pair of the block can see, plus
// (dK/dV) the trailing rows that see no key. lse and D are f32
// [B, H, Sp], Sp = S rounded up to 64.
//
// bf16 (bwd_hopper: dkdv_block, dq_block): the forward kernel's design,
// both kinds of block in one launch, dK/dV first (each runs longer), each
// kind heaviest first under causal masking, so that dQ blocks fill the
// SMs that short dK/dV blocks free. A block has three warpgroups: a
// producer, which gives its registers away (setmaxnreg) and issues every
// load from one thread as TMA over the 4-d tensor maps of hopper.cuh (and
// the lse and D rows as 1-d bulk copies) into a ring of stages with full
// (bytes) and empty (one arrival per consumer warp) mbarriers; and two
// consumer warpgroups, each owning 64 keys (dK/dV) or 64 query rows (dQ),
// which run every product on wgmma with their accumulators in registers.
// Tiles are 64 rows by hd, swizzled as the forward's, and every operand
// stays in its [tokens][hd] layout: a descriptor reads a tile K-major
// where hd is the product's depth and MN-major where tokens are.
//   dK/dV: a block owns 128 keys of one kv head and reads their K and V
//   once; Q, dO, lse and D tiles of 64 query rows stream through a ring
//   of 2 stages. The scores are computed transposed, keys as the M rows
//   of wgmma: S^T = K Q^T and dP^T = V dO^T with both operands in shared
//   memory (at hd 128 dK and dV take 128 registers a thread, so K and V
//   cannot also sit in registers); P^T = exp2(S^T scale_log2 - lse) and
//   dS^T = P^T (dP^T - D) on the accumulator fragments, masked element by
//   element only in tiles that hold a masked pair, are rounded in place
//   to bf16 A fragments (the accumulator layout of 16 query rows is the A
//   layout of one k-step), and dV += P^T dO, dK += dS^T Q read dO and Q
//   MN-major. A warpgroup skips a tile in which its keys see no row and
//   that holds no row without keys.
//   dQ: a block owns 128 query rows of one head and reads their Q and dO
//   once; K and V tiles of 64 keys stream through a ring of 3 stages:
//   S = Q K^T, dP = dO V^T (both operands in shared memory), dS as above
//   into bf16 A fragments, dQ += dS K with K MN-major.
// P and dS are rounded to bf16 before their products, as the forward
// rounds P; the sums stay in f32.
//
// f32 (bwd_dkdv, then bwd_dq): on the CUDA cores, exact (TF32 would miss
// the f32 tolerance): 256 threads, tiles of 64 query rows by 64 keys staged in
// shared memory as f32 (rows padded by one float, so the strided reads of
// the products hit distinct banks). A thread owns a 4x4 block of a score
// tile, rows ty + 16a and keys tx + 16b. bwd_dkdv holds its K and V tile
// and its dK and dV accumulators (registers, a thread owns keys ty + 16a
// and dims tx + 16j) and loops over the query tiles: P = exp2(S - lse),
// dS = P (dP - D) go through shared memory into dV += P^T dO and
// dK += dS^T Q. bwd_dq loops over the key tiles, dQ += dS K in registers.
#include "hopper.cuh"

namespace {

using namespace repro_torch;
using namespace repro_torch::hopper;

constexpr int kThreads = 256;
constexpr int kTile = 64;   // query rows and keys per tile
constexpr int kSub = 4;     // a thread's rows (keys) of a tile, 16 apart
constexpr int kPad = kTile + 1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;   // [B, H, Sp], log2 domain (the forward's)
  float* delta;       // [B, H, Sp]
  int B, S, T, H, KV, Sp;
  int causal, window, q_offset;
  float scale_log2, scale;   // log2(e) / sqrt(hd), 1 / sqrt(hd)
};

__device__ __forceinline__ bool visible(const Params& p, int i, int t) {
  const int qpos = i + p.q_offset;
  return i < p.S && t < p.T && (!p.causal || t <= qpos) &&
         (p.window <= 0 || t > qpos - p.window);
}

// A row that no key is visible to: past every key by the window.
__device__ __forceinline__ bool keyless(const Params& p, int i) {
  return i < p.S && p.window > 0 && i + p.q_offset >= p.T + p.window - 1;
}

// Keys [lo, hi] visible to some row of [i_first, i_last]; lo > hi if none.
__device__ __forceinline__ void key_range(const Params& p, int i_first,
                                          int i_last, int* lo, int* hi) {
  *lo = p.window > 0 ? max(0, i_first + p.q_offset - p.window + 1) : 0;
  *hi = p.causal ? min(p.T - 1, i_last + p.q_offset) : p.T - 1;
}

// The query tiles (of kTile rows) that the keys [t0, t0 + keys) need:
// from `first` up, those before `seen_end` (some row sees a key) and from
// `tail` on (rows that see no key), of `n`.
struct QueryTiles {
  int first, seen_end, tail, n;
  __device__ __forceinline__ QueryTiles(const Params& p, int t0, int keys) {
    const int t_last = t0 + keys - 1;
    const int qlo = p.causal ? max(0, t0 - p.q_offset) : 0;
    const int qhi = p.window > 0
                        ? min(p.S - 1, t_last + p.window - 1 - p.q_offset)
                        : p.S - 1;
    n = (p.S + kTile - 1) / kTile;
    seen_end = qlo <= qhi ? qhi / kTile + 1 : 0;
    const int keyless_from =
        p.window > 0 ? max(0, p.T + p.window - 1 - p.q_offset) : p.S;
    tail = keyless_from < p.S ? max(keyless_from / kTile, seen_end) : n;
    first = qlo <= qhi ? qlo / kTile : tail;
  }
  __device__ __forceinline__ int next(int qt) const {
    ++qt;
    return qt >= seen_end && qt < tail ? tail : qt;
  }
};

// dst[kTile][HD + 1] (f32) <- rows [0, rows) of src, rows row_stride
// elements apart; rows past ``rows`` are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int rows) {
  constexpr int N = 4;   // one 16-byte load
  constexpr int kVecs = HD / N;
  for (int idx = threadIdx.x; idx < kTile * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * N;
    float x[N];
    if (r < rows) {
      load_widen<float, N>(src + r * row_stride + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[r * (HD + 1) + c + e] = x[e];
  }
}

// acc[a][b] = sum_d A[ty + 16a][d] * Bt[tx + 16b][d]
template <int HD>
__device__ __forceinline__ void score_block(const float* A, const float* Bt,
                                            float acc[kSub][kSub], int ty,
                                            int tx) {
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int b = 0; b < kSub; ++b) acc[a][b] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float x[kSub], y[kSub];
#pragma unroll
    for (int a = 0; a < kSub; ++a) x[a] = A[(ty + 16 * a) * (HD + 1) + d];
#pragma unroll
    for (int b = 0; b < kSub; ++b) y[b] = Bt[(tx + 16 * b) * (HD + 1) + d];
#pragma unroll
    for (int a = 0; a < kSub; ++a)
#pragma unroll
      for (int b = 0; b < kSub; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
  }
}

// acc[a][j] += sum_r W(r, ty + 16a) * X[r][tx + 16j] over the tile's 64
// r: the thread's four indices ty + 16a are W's columns (kOwnCols:
// W(r, c) = W[r][c]) or its rows (W(r, c) = W[c][r]). W is
// [kTile][kPad], X is [kTile][HD + 1].
template <int HD, bool kOwnCols>
__device__ __forceinline__ void accumulate(const float* W, const float* X,
                                           float acc[kSub][HD / 16], int ty,
                                           int tx) {
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float w[kSub], x[HD / 16];
#pragma unroll
    for (int a = 0; a < kSub; ++a)
      w[a] = kOwnCols ? W[r * kPad + ty + 16 * a]
                      : W[(ty + 16 * a) * kPad + r];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) x[j] = X[r * (HD + 1) + tx + 16 * j];
#pragma unroll
    for (int a = 0; a < kSub; ++a)
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) acc[a][j] = fmaf(w[a], x[j], acc[a][j]);
  }
}

// Element offsets of row (b, i, head) of q/o/dO/dQ and of (b, t, kv head)
// of k/v/dK/dV.
__device__ __forceinline__ long long q_row(const Params& p, int b, int i,
                                           int h, int hd) {
  return ((long long)(b * p.S + i) * p.H + h) * hd;
}
__device__ __forceinline__ long long k_row(const Params& p, int b, int t,
                                           int kh, int hd) {
  return ((long long)(b * p.T + t) * p.KV + kh) * hd;
}


// ----------------------------------------------------------------------
// D = rowsum(dO * O) per query row: one warp a row of [B, H, Sp], 0 past S
// ----------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) bwd_delta(const Params p) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.H * p.Sp) return;
  const int i = (int)(row % p.Sp);
  const int h = (int)(row / p.Sp % p.H), b = (int)(row / p.Sp / p.H);
  float dd = 0.f;
  if (i < p.S) {
    const long long at = q_row(p, b, i, h, HD);
    const T* o = static_cast<const T*>(p.o) + at;
    const T* dout = static_cast<const T*>(p.dout) + at;
    for (int d = lane; d < HD; d += 32)
      dd += to_float(o[d]) * to_float(dout[d]);
  }
  dd = warp_sum(dd);
  if (lane == 0) p.delta[row] = dd;
}

// P and dS of one (query tile, key tile) pair into shared memory, rows
// of the query tile by keys: s and dp are a thread's blocks of S and dP.
__device__ __forceinline__ void probs_and_dscores(
    const Params& p, int i0, int t0, const float s[kSub][kSub],
    const float dp[kSub][kSub], const float* sL, const float* sD,
    float* sP, float* sdS, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int c = 0; c < kSub; ++c) {
      const int r = ty + 16 * a, cc = tx + 16 * c;
      const int i = i0 + r, t = t0 + cc;
      float pv = 0.f, ds = 0.f;
      if (visible(p, i, t)) {
        pv = exp2f(s[a][c] * p.scale_log2 - sL[r]);
        ds = pv * (dp[a][c] - sD[r]);
      } else if (keyless(p, i) && t < p.T) {
        pv = 1.f / p.T;
      }
      if (sP != nullptr) sP[r * kPad + cc] = pv;
      sdS[r * kPad + cc] = ds;
    }
}

// ----------------------------------------------------------------------
// f32 on the CUDA cores: dK, dV of one key tile over the query tiles of
// its group's G heads
// ----------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv(const Params p) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * (HD + 1);
  float* sQ = sV + kTile * (HD + 1);
  float* sdO = sQ + kTile * (HD + 1);
  float* sP = sdO + kTile * (HD + 1);
  float* sdS = sP + kTile * kPad;
  float* sL = sdS + kTile * kPad;
  float* sD = sL + kTile;
  const int t0 = blockIdx.x * kTile, kh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int keys = min(kTile, p.T - t0);
  const float* q = static_cast<const float*>(p.q);
  const float* dout = static_cast<const float*>(p.dout);
  load_tile<HD>(sK, static_cast<const float*>(p.k) + k_row(p, b, t0, kh, HD),
                   (long long)p.KV * HD, keys);
  load_tile<HD>(sV, static_cast<const float*>(p.v) + k_row(p, b, t0, kh, HD),
                   (long long)p.KV * HD, keys);

  // query rows that see some key of this tile, then the keyless rows
  const QueryTiles tiles(p, t0, keys);

  float dk[kSub][HD / 16], dv[kSub][HD / 16];
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) dk[a][j] = dv[a][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int qt = tiles.first; qt < tiles.n; qt = tiles.next(qt)) {
      const int i0 = qt * kTile;
      const int rows = min(kTile, p.S - i0);
      __syncthreads();   // the last tile's readers are done
      load_tile<HD>(sQ, q + q_row(p, b, i0, h, HD), (long long)p.H * HD,
                       rows);
      load_tile<HD>(sdO, dout + q_row(p, b, i0, h, HD),
                       (long long)p.H * HD, rows);
      if (threadIdx.x < kTile) {
        const long long at =
            ((long long)b * p.H + h) * p.Sp + i0 + threadIdx.x;
        sL[threadIdx.x] = threadIdx.x < rows ? p.lse[at] : 0.f;
        sD[threadIdx.x] = threadIdx.x < rows ? p.delta[at] : 0.f;
      }
      __syncthreads();
      float s[kSub][kSub], dp[kSub][kSub];
      score_block<HD>(sQ, sK, s, ty, tx);
      score_block<HD>(sdO, sV, dp, ty, tx);
      probs_and_dscores(p, i0, t0, s, dp, sL, sD, sP, sdS, ty, tx);
      __syncthreads();
      accumulate<HD, true>(sP, sdO, dv, ty, tx);
      accumulate<HD, true>(sdS, sQ, dk, ty, tx);
    }
  }

  float* dk_out = static_cast<float*>(p.dk);
  float* dv_out = static_cast<float*>(p.dv);
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int c = ty + 16 * a;
    if (c >= keys) continue;
    const long long row = k_row(p, b, t0 + c, kh, HD);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      store_from_float(dk_out + row + tx + 16 * j, dk[a][j] * p.scale);
      store_from_float(dv_out + row + tx + 16 * j, dv[a][j]);
    }
  }
}

// ----------------------------------------------------------------------
// f32 on the CUDA cores: dQ of one query tile over its visible key tiles
// ----------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq(const Params p) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * (HD + 1);
  float* sK = sdO + kTile * (HD + 1);
  float* sV = sK + kTile * (HD + 1);
  float* sdS = sV + kTile * (HD + 1);
  float* sL = sdS + kTile * kPad;
  float* sD = sL + kTile;
  // causal: the last query tile sees the most keys; run it first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int i0 = qt * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.KV);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int rows = min(kTile, p.S - i0);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  load_tile<HD>(sQ, static_cast<const float*>(p.q) + q_row(p, b, i0, h, HD),
                   (long long)p.H * HD, rows);
  load_tile<HD>(sdO,
                   static_cast<const float*>(p.dout) + q_row(p, b, i0, h, HD),
                   (long long)p.H * HD, rows);
  if (threadIdx.x < kTile) {
    const long long at = ((long long)b * p.H + h) * p.Sp + i0 + threadIdx.x;
    sL[threadIdx.x] = threadIdx.x < rows ? p.lse[at] : 0.f;
    sD[threadIdx.x] = threadIdx.x < rows ? p.delta[at] : 0.f;
  }

  float acc[kSub][HD / 16];
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) acc[a][j] = 0.f;
  int lo, hi;
  key_range(p, i0, i0 + rows - 1, &lo, &hi);
  for (int t0 = lo - lo % kTile; lo <= hi && t0 <= hi; t0 += kTile) {
    const int keys = min(kTile, p.T - t0);
    __syncthreads();   // sdS, sK of the last tile are read
    load_tile<HD>(sK, k + k_row(p, b, t0, kh, HD), (long long)p.KV * HD,
                     keys);
    load_tile<HD>(sV, v + k_row(p, b, t0, kh, HD), (long long)p.KV * HD,
                     keys);
    __syncthreads();
    float s[kSub][kSub], dp[kSub][kSub];
    score_block<HD>(sQ, sK, s, ty, tx);
    score_block<HD>(sdO, sV, dp, ty, tx);
    probs_and_dscores(p, i0, t0, s, dp, sL, sD, nullptr, sdS, ty, tx);
    __syncthreads();
    accumulate<HD, false>(sdS, sK, acc, ty, tx);
  }

  float* dq = static_cast<float*>(p.dq);
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int r = ty + 16 * a;
    if (r >= rows) continue;
    const long long row = q_row(p, b, i0 + r, h, HD);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      store_from_float(dq + row + tx + 16 * j, acc[a][j] * p.scale);
  }
}


// ----------------------------------------------------------------------
// bf16 on the tensor cores: wgmma + TMA, warp-specialised
// ----------------------------------------------------------------------
constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kRowsWG = 64;                     // keys or query rows each
constexpr int kBlockRows = kConsumers * kRowsWG;
constexpr int kHopThreads = (kConsumers + 1) * 128;
constexpr int kStagesKV = 2;   // dK/dV: ring of Q, dO, lse and D tiles
constexpr int kStagesQ = 3;    // dQ: ring of K and V tiles
constexpr int kRowBytesF32 = kTile * 4;         // one tile's lse or D

template <int HD>
struct DkdvSmem {  // byte offsets from a 1024-aligned base
  using TL = HopTile<HD>;
  static constexpr int k = 0;                                   // [kConsumers]
  static constexpr int v = k + kConsumers * TL::kTileBytes;     // [kConsumers]
  static constexpr int q = v + kConsumers * TL::kTileBytes;     // [kStagesKV]
  static constexpr int dout = q + kStagesKV * TL::kTileBytes;   // [kStagesKV]
  static constexpr int lse = dout + kStagesKV * TL::kTileBytes; // [kStagesKV]
  static constexpr int delta = lse + kStagesKV * kRowBytesF32;  // [kStagesKV]
  static constexpr int bars = delta + kStagesKV * kRowBytesF32;
  // full[kStagesKV], empty[kStagesKV], kv
  static constexpr int bytes = bars + (2 * kStagesKV + 1) * 8;
};

template <int HD>
struct DqSmem {
  using TL = HopTile<HD>;
  static constexpr int q = 0;                                   // [kConsumers]
  static constexpr int dout = q + kConsumers * TL::kTileBytes;  // [kConsumers]
  static constexpr int k = dout + kConsumers * TL::kTileBytes;  // [kStagesQ]
  static constexpr int v = k + kStagesQ * TL::kTileBytes;       // [kStagesQ]
  static constexpr int bars = v + kStagesQ * TL::kTileBytes;  // full, empty, q
  static constexpr int bytes = bars + (2 * kStagesQ + 1) * 8;
};

// Coordinate slots (1..3) of the row, head and batch dims in the maps of
// q and dO (one layout) and of k and v (another).
struct Slots {   // the batch dim takes the remaining slot
  int q_row, q_head, k_row, k_head;
};

__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map,
                                          uint32_t bar, int boxes,
                                          int box_bytes, int box_d,
                                          int sr, int sh, int row, int head,
                                          int b) {
  for (int bx = 0; bx < boxes; ++bx)
    tma_load(static_cast<unsigned char*>(dst) + bx * box_bytes, map, bar,
             bx * box_d, coord(1, sr, sh, row, head, b),
             coord(2, sr, sh, row, head, b), coord(3, sr, sh, row, head, b));
}

// The descriptor of k-step kk (16 columns of hd) of a 64-row tile read
// K-major: hd is the product's depth.
template <int HD>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile,
                                           int kk) {
  using TL = HopTile<HD>;
  const int bx = kk * 16 / TL::kBoxD;
  return make_desc(tile + bx * TL::kBoxBytes + (kk * 16 % TL::kBoxD) * 2, 16,
                   TL::kSbo, TL::kLayout);
}

// d += A (registers, 64 x 16 tokens) * (rows 16 kk.. of the 64-row tile
// `tile`, read MN-major: tokens are the product's depth), over all hd
template <int HD>
__device__ __forceinline__ void mma_tokens(float* d, const uint32_t (&a)[4],
                                           const unsigned char* tile, int kk) {
  using TL = HopTile<HD>;
#pragma unroll
  for (int bx = 0; bx < TL::kBoxes; ++bx) {
    const uint64_t db =
        make_desc(tile + bx * TL::kBoxBytes + kk * 16 * TL::kRowBytes,
                  TL::kSbo, TL::kSbo, TL::kLayout);
    float* dd = d + bx * (TL::kBoxD / 2);
    if constexpr (TL::kBoxD == 64) wgmma_rs_n64(dd, a, db);
    else if constexpr (TL::kBoxD == 32) wgmma_rs_n32(dd, a, db);
    else wgmma_rs_n16(dd, a, db);
  }
}

// s = A B^T over hd for two 64-row tiles, both K-major, issued
template <int HD>
__device__ __forceinline__ void issue_scores(float (&s)[32],
                                             const unsigned char* a,
                                             const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_n64_k(s, desc_k<HD>(a, kk), desc_k<HD>(b, kk), kk > 0);
}

// the accumulator of 64 x 64 (32 floats a thread) as four bf16 A
// fragments of 16 columns each
__device__ __forceinline__ void to_a_frags(const float (&s)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ void keep(uint32_t (&a)[4][4]) {  // live until here
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[kk][r])::"memory");
}

// A dK/dV block: keys [t0, t0 + 128) of kv head kvh of batch b.
template <int HD>
__device__ __forceinline__ void dkdv_block(
    unsigned char* smem, const CUtensorMap* mq, const CUtensorMap* mdo,
    const CUtensorMap* mk, const CUtensorMap* mv, const Params& p,
    const Slots& sl, int kvh, int b, int t0) {
  using TL = HopTile<HD>;
  using SM = DkdvSmem<HD>;
  const uint32_t bars = smem_u32(smem + SM::bars);
  const uint32_t kvbar = bars + 16 * kStagesKV;
  const int G = p.H / p.KV;
  const int n_wg = min(kConsumers, (p.T - t0 + kRowsWG - 1) / kRowsWG);
  const QueryTiles tiles(p, t0, min(kBlockRows, p.T - t0));

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesKV; ++s) {
      mbar_init(bars + 8 * s, 1);                             // full: bytes
      mbar_init(bars + 8 * (kStagesKV + s), 4 * kConsumers);  // empty: warps
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kvbar, 2 * n_wg * TL::kTileBytes);
      for (int w = 0; w < n_wg; ++w) {
        load_rows(smem + SM::k + w * TL::kTileBytes, mk, kvbar, TL::kBoxes,
                  TL::kBoxBytes, TL::kBoxD, sl.k_row, sl.k_head,
                  t0 + w * kRowsWG, kvh, b);
        load_rows(smem + SM::v + w * TL::kTileBytes, mv, kvbar, TL::kBoxes,
                  TL::kBoxBytes, TL::kBoxD, sl.k_row, sl.k_head,
                  t0 + w * kRowsWG, kvh, b);
      }
      int it = 0;
      for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const long long rows = ((long long)b * p.H + h) * p.Sp;
        for (int qt = tiles.first; qt < tiles.n; qt = tiles.next(qt), ++it) {
          const int st = it % kStagesKV;
          const uint32_t full = bars + 8 * st;
          mbar_wait(bars + 8 * (kStagesKV + st), ((it / kStagesKV) & 1) ^ 1);
          mbar_expect_tx(full, 2 * TL::kTileBytes + 2 * kRowBytesF32);
          const int i0 = qt * kTile;
          load_rows(smem + SM::q + st * TL::kTileBytes, mq, full, TL::kBoxes,
                    TL::kBoxBytes, TL::kBoxD, sl.q_row, sl.q_head, i0, h, b);
          load_rows(smem + SM::dout + st * TL::kTileBytes, mdo, full,
                    TL::kBoxes, TL::kBoxBytes, TL::kBoxD, sl.q_row, sl.q_head,
                    i0, h, b);
          bulk_load(smem + SM::lse + st * kRowBytesF32, p.lse + rows + i0,
                    kRowBytesF32, full);
          bulk_load(smem + SM::delta + st * kRowBytesF32, p.delta + rows + i0,
                    kRowBytesF32, full);
        }
      }
    }
    return;
  }

  // consumer warpgroups: 64 keys each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;
  const int ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32, g8 = lane / 4, tq = lane % 4;
  const int tw = t0 + cw * kRowsWG;             // this warpgroup's first key
  const bool has_keys = cw < n_wg;
  const int key0 = tw + warp * 16 + g8, key1 = key0 + 8;  // this thread's
  const unsigned char* Ks = smem + SM::k + cw * TL::kTileBytes;
  const unsigned char* Vs = smem + SM::v + cw * TL::kTileBytes;
  const int keyless_from =
      p.window > 0 ? max(0, p.T + p.window - 1 - p.q_offset) : p.S;
  const float sc = p.scale_log2, inv_t = 1.f / p.T;

  // dK, dV accumulators in the wgmma layout: [4j + e] is key key0 (e < 2)
  // or key1, dim 8j + 2tq + (e & 1)
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  if (has_keys) mbar_wait(kvbar, 0);

  int it = 0;
  for (int g = 0; g < G; ++g) {
    for (int qt = tiles.first; qt < tiles.n; qt = tiles.next(qt), ++it) {
      const int st = it % kStagesKV;
      mbar_wait(bars + 8 * st, (it / kStagesKV) & 1);
      const int i0 = qt * kTile;
      int lo, hi;
      key_range(p, i0, min(i0 + kTile, p.S) - 1, &lo, &hi);
      const bool need =
          has_keys && ((lo <= hi && lo <= min(tw + kRowsWG, p.T) - 1 &&
                        hi >= tw) ||
                       keyless_from < min(i0 + kTile, p.S));
      if (need) {
        const unsigned char* Qs = smem + SM::q + st * TL::kTileBytes;
        const unsigned char* dOs = smem + SM::dout + st * TL::kTileBytes;
        const float* Ls =
            reinterpret_cast<const float*>(smem + SM::lse + st * kRowBytesF32);
        const float* Ds = reinterpret_cast<const float*>(
            smem + SM::delta + st * kRowBytesF32);
        float s[32], dp[32];
        wgmma_fence();
        issue_scores<HD>(s, Ks, Qs);     // S^T = K Q^T
        issue_scores<HD>(dp, Vs, dOs);   // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(s);
        fence_regs<32>(dp);
        // P^T and dS^T: rows are keys (key0 for e < 2, key1), columns are
        // query rows i0 + 8j + 2tq + (e & 1)
        const bool masked =
            i0 + kTile > p.S || tw + kRowsWG > p.T ||
            (p.causal && tw + kRowsWG - 1 > p.q_offset + i0) ||
            (p.window > 0 && tw <= p.q_offset + i0 + kTile - 1 - p.window);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * tq;
          const float2 lse = *reinterpret_cast<const float2*>(Ls + c);
          const float2 dd = *reinterpret_cast<const float2*>(Ds + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + 8 * j + 2 * tq + (e & 1);
            const int key = e < 2 ? key0 : key1;
            const float l = (e & 1) ? lse.y : lse.x;
            const float d = (e & 1) ? dd.y : dd.x;
            float pv, ds;
            if (!masked || visible(p, i, key)) {
              pv = fast_exp2(fmaf(s[4 * j + e], sc, -l));
              ds = pv * (dp[4 * j + e] - d);
            } else {
              pv = keyless(p, i) && key < p.T ? inv_t : 0.f;
              ds = 0.f;
            }
            s[4 * j + e] = pv;
            dp[4 * j + e] = ds;
          }
        }
        uint32_t pa[4][4], da[4][4];
        to_a_frags(s, pa);
        to_a_frags(dp, da);
        fence_regs<HD / 2>(dv);
        fence_regs<HD / 2>(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_tokens<HD>(dv, pa[kk], dOs, kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_tokens<HD>(dk, da[kk], Qs, kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<HD / 2>(dv);
        fence_regs<HD / 2>(dk);
        keep(pa);
        keep(da);
      }
      __syncwarp();   // release the stage: one arrival per consumer warp
      if (lane == 0) mbar_arrive(bars + 8 * (kStagesKV + st));
    }
  }

  if (!has_keys) return;
  bf16* dk_out = static_cast<bf16*>(p.dk) + (long long)kvh * HD + 2 * tq;
  bf16* dv_out = static_cast<bf16*>(p.dv) + (long long)kvh * HD + 2 * tq;
  const long long row_stride = (long long)p.KV * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (key0 < p.T) {
      const long long at = ((long long)b * p.T + key0) * row_stride + 8 * j;
      *reinterpret_cast<__nv_bfloat162*>(dk_out + at) = __floats2bfloat162_rn(
          dk[4 * j] * p.scale, dk[4 * j + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + at) =
          __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
    }
    if (key1 < p.T) {
      const long long at = ((long long)b * p.T + key1) * row_stride + 8 * j;
      *reinterpret_cast<__nv_bfloat162*>(dk_out + at) = __floats2bfloat162_rn(
          dk[4 * j + 2] * p.scale, dk[4 * j + 3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + at) =
          __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

// A dQ block: query rows [row0, row0 + 128) of head h of batch b.
template <int HD>
__device__ __forceinline__ void dq_block(
    unsigned char* smem, const CUtensorMap* mq, const CUtensorMap* mdo,
    const CUtensorMap* mk, const CUtensorMap* mv, const Params& p,
    const Slots& sl, int h, int b, int row0) {
  using TL = HopTile<HD>;
  using SM = DqSmem<HD>;
  const uint32_t bars = smem_u32(smem + SM::bars);
  const uint32_t qbar = bars + 16 * kStagesQ;
  const int kvh = h / (p.H / p.KV);
  const int n_wg = min(kConsumers, (p.S - row0 + kRowsWG - 1) / kRowsWG);
  int lo, hi;   // the keys this block's rows see, in whole tiles
  key_range(p, row0, min(row0 + kBlockRows, p.S) - 1, &lo, &hi);
  const int k_begin = lo - lo % kTile;
  const int n_kv = lo <= hi ? (hi - k_begin) / kTile + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesQ; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStagesQ + s), 4 * kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, 2 * n_wg * TL::kTileBytes);
      for (int w = 0; w < n_wg; ++w) {
        load_rows(smem + SM::q + w * TL::kTileBytes, mq, qbar, TL::kBoxes,
                  TL::kBoxBytes, TL::kBoxD, sl.q_row, sl.q_head,
                  row0 + w * kRowsWG, h, b);
        load_rows(smem + SM::dout + w * TL::kTileBytes, mdo, qbar,
                  TL::kBoxes, TL::kBoxBytes, TL::kBoxD, sl.q_row, sl.q_head,
                  row0 + w * kRowsWG, h, b);
      }
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStagesQ;
        const uint32_t full = bars + 8 * st;
        mbar_wait(bars + 8 * (kStagesQ + st), ((it / kStagesQ) & 1) ^ 1);
        mbar_expect_tx(full, 2 * TL::kTileBytes);
        const int k0 = k_begin + it * kTile;
        load_rows(smem + SM::k + st * TL::kTileBytes, mk, full, TL::kBoxes,
                  TL::kBoxBytes, TL::kBoxD, sl.k_row, sl.k_head, k0, kvh, b);
        load_rows(smem + SM::v + st * TL::kTileBytes, mv, full, TL::kBoxes,
                  TL::kBoxBytes, TL::kBoxD, sl.k_row, sl.k_head, k0, kvh, b);
      }
    }
    return;
  }

  // consumer warpgroups: 64 query rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;
  const int ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32, g8 = lane / 4, tq = lane % 4;
  const bool has_rows = cw < n_wg;
  const int wrow0 = row0 + cw * kRowsWG;
  const int r0 = wrow0 + warp * 16 + g8, r1 = r0 + 8;   // this thread's rows
  // the ring's tiles [it_lo, it_hi) hold keys these rows see
  int it_lo = 0, it_hi = 0;
  if (has_rows) {
    int wlo, whi;
    key_range(p, wrow0, min(wrow0 + kRowsWG, p.S) - 1, &wlo, &whi);
    if (wlo <= whi) {
      it_lo = min(n_kv, (wlo - k_begin) / kTile);
      it_hi = min(n_kv, (whi - k_begin) / kTile + 1);
    }
  }
  const unsigned char* Qs = smem + SM::q + cw * TL::kTileBytes;
  const unsigned char* dOs = smem + SM::dout + cw * TL::kTileBytes;
  const long long rows = ((long long)b * p.H + h) * p.Sp;
  const float lse0 = r0 < p.S ? p.lse[rows + r0] : 0.f;
  const float lse1 = r1 < p.S ? p.lse[rows + r1] : 0.f;
  const float d0 = r0 < p.S ? p.delta[rows + r0] : 0.f;
  const float d1 = r1 < p.S ? p.delta[rows + r1] : 0.f;
  const float sc = p.scale_log2;
  const int wq_first = p.q_offset + wrow0;
  const int wq_last = p.q_offset + min(wrow0 + kRowsWG, p.S) - 1;

  float dq[HD / 2];   // [4j + e]: row r0 (e < 2) or r1, dim 8j + 2tq + (e & 1)
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  if (has_rows) mbar_wait(qbar, 0);

  for (int it = 0; it < n_kv; ++it) {
    const int st = it % kStagesQ;
    mbar_wait(bars + 8 * st, (it / kStagesQ) & 1);
    if (it >= it_lo && it < it_hi) {
      const unsigned char* Ks = smem + SM::k + st * TL::kTileBytes;
      const unsigned char* Vs = smem + SM::v + st * TL::kTileBytes;
      float s[32], dp[32];
      wgmma_fence();
      issue_scores<HD>(s, Qs, Ks);     // S = Q K^T
      issue_scores<HD>(dp, dOs, Vs);   // dP = dO V^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(s);
      fence_regs<32>(dp);
      const int k0 = k_begin + it * kTile;
      const bool masked = k0 + kTile > p.T ||
                          (p.causal && k0 + kTile - 1 > wq_first) ||
                          (p.window > 0 && k0 <= wq_last - p.window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          const int i = e < 2 ? r0 : r1;
          float ds = 0.f;
          if (!masked || visible(p, i, key)) {
            const float pv =
                fast_exp2(fmaf(s[4 * j + e], sc, e < 2 ? -lse0 : -lse1));
            ds = pv * (dp[4 * j + e] - (e < 2 ? d0 : d1));
          }
          dp[4 * j + e] = ds;
        }
      uint32_t da[4][4];
      to_a_frags(dp, da);
      fence_regs<HD / 2>(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_tokens<HD>(dq, da[kk], Ks, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<HD / 2>(dq);
      keep(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStagesQ + st));
  }

  if (!has_rows) return;
  bf16* out = static_cast<bf16*>(p.dq) + (long long)h * HD + 2 * tq;
  const long long row_stride = (long long)p.H * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (r0 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((long long)b * p.S + r0) * row_stride + 8 * j) =
          __floats2bfloat162_rn(dq[4 * j] * p.scale, dq[4 * j + 1] * p.scale);
    if (r1 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((long long)b * p.S + r1) * row_stride + 8 * j) =
          __floats2bfloat162_rn(dq[4 * j + 2] * p.scale,
                                dq[4 * j + 3] * p.scale);
  }
}

// One launch of both kinds of block, dK/dV first (each runs longer), then
// dQ, each kind heaviest first under causal masking, so that dQ blocks
// fill the SMs that the short dK/dV blocks free.
template <int HD>
__global__ void __launch_bounds__(kHopThreads, 1)
    bwd_hopper(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mdo,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, const Params p,
               const Slots sl) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n_dkdv =
      p.KV * p.B * ((p.T + kBlockRows - 1) / kBlockRows);
  int idx = blockIdx.x;
  if (idx < n_dkdv) {   // key tile 0, the heaviest, first
    const int kb = idx / (p.KV * p.B);
    idx %= p.KV * p.B;
    dkdv_block<HD>(smem, &mq, &mdo, &mk, &mv, p, sl, idx % p.KV,
                   idx / p.KV, kb * kBlockRows);
    return;
  }
  idx -= n_dkdv;
  const int n_rows = (p.S + kBlockRows - 1) / kBlockRows;
  int rb = idx / (p.H * p.B);
  if (p.causal) rb = n_rows - 1 - rb;   // the last rows see the most keys
  idx %= p.H * p.B;
  dq_block<HD>(smem, &mq, &mdo, &mk, &mv, p, sl, idx % p.H, idx / p.H,
               rb * kBlockRows);
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int HD>
int launch_delta(const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.H * p.Sp;
  const int per_block = kThreads / 32;
  bwd_delta<T, HD><<<(unsigned)((rows + per_block - 1) / per_block),
                      kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// f32: the CUDA-core kernels
template <int HD>
int launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int tile_bytes = kTile * (HD + 1) * sizeof(float);
  constexpr int score_bytes = kTile * kPad * sizeof(float);
  constexpr int row_bytes = 2 * kTile * sizeof(float);
  constexpr int dkdv_smem = 4 * tile_bytes + 2 * score_bytes + row_bytes;
  constexpr int dq_smem = 4 * tile_bytes + score_bytes + row_bytes;
  static bool attr_set = false;   // once per process and head dim
  if (!attr_set) {
    int err = allow_smem(bwd_dkdv<HD>, dkdv_smem);
    if (!err) err = allow_smem(bwd_dq<HD>, dq_smem);
    if (err) return err;
    attr_set = true;
  }
  int err = launch_delta<float, HD>(p, stream);
  if (err) return err;
  const int q_tiles = (p.S + kTile - 1) / kTile;
  const int k_tiles = (p.T + kTile - 1) / kTile;
  bwd_dkdv<HD><<<dim3(k_tiles, p.KV, p.B), kThreads, dkdv_smem,
                        stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dq<HD><<<dim3(q_tiles, p.H, p.B), kThreads, dq_smem, stream>>>(
      p);
  return (int)cudaGetLastError();
}

// bf16: the wgmma kernels
template <int HD>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using TL = HopTile<HD>;
  constexpr int smem =   // + alignment slack
      (DkdvSmem<HD>::bytes > DqSmem<HD>::bytes ? DkdvSmem<HD>::bytes
                                               : DqSmem<HD>::bytes) + 1024;
  static bool attr_set = false;
  if (!attr_set) {
    const int err = allow_smem(bwd_hopper<HD>, smem);
    if (err) return err;
    attr_set = true;
  }
  const CUtensorMapSwizzle swizzle = tile_swizzle<HD>();
  const long long qs = (long long)p.H * HD, ks = (long long)p.KV * HD;
  CUtensorMap mq, mdo, mk, mv;
  Slots sl;
  int slot[3];
  int err = encode_map(&mq, slot, p.q, HD, p.S, p.H, p.B, qs, HD, qs * p.S,
                       TL::kBoxD, swizzle);
  if (!err) err = encode_map(&mdo, slot, p.dout, HD, p.S, p.H, p.B, qs, HD,
                             qs * p.S, TL::kBoxD, swizzle);
  if (err) return err;
  sl.q_row = slot[0]; sl.q_head = slot[1];
  err = encode_map(&mk, slot, p.k, HD, p.T, p.KV, p.B, ks, HD, ks * p.T,
                   TL::kBoxD, swizzle);
  if (!err) err = encode_map(&mv, slot, p.v, HD, p.T, p.KV, p.B, ks, HD,
                             ks * p.T, TL::kBoxD, swizzle);
  if (err) return err;
  sl.k_row = slot[0]; sl.k_head = slot[1];
  err = launch_delta<bf16, HD>(p, stream);
  if (err) return err;
  const int blocks =
      p.B * (p.KV * ((p.T + kBlockRows - 1) / kBlockRows) +
             p.H * ((p.S + kBlockRows - 1) / kBlockRows));
  bwd_hopper<HD><<<blocks, kHopThreads, smem, stream>>>(mq, mdo, mk, mv, p,
                                                        sl);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every tensor is contiguous: q, o,
// dout, dq [B, S, H, hd]; k, v, dk, dv [B, T, KV, hd]; lse is the
// forward's (flash_prefill_fwd_lse) and delta f32 scratch, both
// [B, H, Sp] with Sp = S rounded up to 64. S, T >= 1. Returns the first
// launch error.
extern "C" int flash_attention_bwd(int dtype, int hd, const void* q,
                                   const void* k, const void* v,
                                   const void* o, const void* dout, void* dq,
                                   void* dk, void* dv, const void* lse,
                                   void* delta, int B, int S, int T, int H,
                                   int KV, int causal, int window,
                                   int q_offset, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.B = B; p.S = S; p.T = T; p.H = H; p.KV = KV;
  p.Sp = (S + kTile - 1) / kTile * kTile;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale = 1.f / sqrtf((float)hd);
  p.scale_log2 = kLog2e * p.scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 || dtype == 1) {
    switch (hd) {
      case 32: return dtype ? launch_bf16<32>(p, s) : launch_f32<32>(p, s);
      case 64: return dtype ? launch_bf16<64>(p, s) : launch_f32<64>(p, s);
      case 80: return dtype ? launch_bf16<80>(p, s) : launch_f32<80>(p, s);
      case 128: return dtype ? launch_bf16<128>(p, s) : launch_f32<128>(p, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
