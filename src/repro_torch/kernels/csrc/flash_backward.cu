// Flash attention's backward: dQ, dK and dV of the function that
// kernels/ref.py::flash_attention_ref computes (causal or not, sliding
// window, q_offset, ragged S != T, GQA with H % KV == 0), for q, o, dO
// [B,S,H,hd] and k/v [B,T,KV,hd], all contiguous, f32 or bf16 in and out,
// f32 accumulation, head dims 32, 64, 80 and 128. A query row that the
// masks leave without a key follows the plain version: its scores are all
// -1e30, so its softmax is uniform, 1/T over the T keys; dV gets dO/T at
// every key, and its scores get no gradient (dQ = 0, nothing into dK).
//
// There is no Pallas backward to replace: the reference trains through
// jax.value_and_grad over src/repro/kernels/ref.py::flash_attention_ref.
// The forward kernel (flash_prefill.cu) writes only O, so this recomputes
// what it needs.
//
// What bounds it on the H100: per (query, key) pair the backward does five
// products of length hd (S = Q K^T, dP = dO V^T, dV += P^T dO,
// dK += dS^T Q, dQ += dS K), 10 hd operations, against O((S+T) hd) bytes:
// far above the card's ~295 operations per byte, so arithmetic bounds it
// (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 on the CUDA
// cores). This first version is right and simple: it runs every product
// on the CUDA cores in f32, recomputes S and dP in two kernels, and
// reaches a fraction of that bound; wgmma and TMA are later work.
//
// Design. Three kernels, 256 threads each, tiles of 64 query rows by 64
// keys staged in shared memory as f32 (rows padded by one float, so the
// strided reads of the products hit distinct banks). A thread owns a 4x4
// block of a score tile, rows ty + 16a and keys tx + 16b.
//   1. bwd_prep, grid (query tile, head, batch): per query row the
//      log-sum-exp of its scores (log2 domain; an online max and sum per
//      thread, combined over the row's 16 threads by shuffles) and
//      D = rowsum(dO * O).
//   2. bwd_dkdv, grid (key tile, kv head, batch): holds its K and V tile
//      and its dK and dV accumulators (registers, a thread owns keys
//      ty + 16a and dims tx + 16j) for the whole block, and loops over the
//      query tiles of all G query heads of its group: P = exp2(S - lse),
//      dS = P (dP - D) go through shared memory into dV += P^T dO and
//      dK += dS^T Q.
//   3. bwd_dq, grid (query tile, head, batch), heaviest causal tile first:
//      loops over the key tiles, dQ += dS K in registers.
// Each output element is written by exactly one thread, once, after a
// fixed loop order: no atomics, so the gradients are deterministic. Tiles
// the masks leave wholly empty are skipped: each loop runs over the rows
// or keys that some pair of the block can see, plus (dK/dV) the trailing
// rows that see no key at all.
#include "common.cuh"

namespace {

using namespace repro_torch;

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
  float* lse;    // [B, H, S], log2 domain
  float* delta;  // [B, H, S]
  int B, S, T, H, KV;
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

// dst[kTile][HD + 1] (f32) <- rows [0, rows) of src, rows row_stride
// elements apart; rows past ``rows`` are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int rows) {
  constexpr int N = 16 / sizeof(T);
  constexpr int kVecs = HD / N;
  for (int idx = threadIdx.x; idx < kTile * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * N;
    float x[N];
    if (r < rows) {
      load_widen<T, N>(src + r * row_stride + c, x);
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
// 1. per query row: log-sum-exp of the visible scores, D = rowsum(dO O)
// ----------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
bwd_prep(const Params p) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (HD + 1);
  const int i0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.KV);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int rows = min(kTile, p.S - i0);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  load_tile<T, HD>(sQ, q + q_row(p, b, i0, h, HD), (long long)p.H * HD, rows);

  float m[kSub], l[kSub];
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  int lo, hi;
  key_range(p, i0, i0 + rows - 1, &lo, &hi);
  for (int t0 = lo - lo % kTile; lo <= hi && t0 <= hi; t0 += kTile) {
    __syncthreads();
    load_tile<T, HD>(sK, k + k_row(p, b, t0, kh, HD), (long long)p.KV * HD,
                     min(kTile, p.T - t0));
    __syncthreads();
    float s[kSub][kSub];
    score_block<HD>(sQ, sK, s, ty, tx);
#pragma unroll
    for (int a = 0; a < kSub; ++a)
#pragma unroll
      for (int c = 0; c < kSub; ++c) {
        if (!visible(p, i0 + ty + 16 * a, t0 + tx + 16 * c)) continue;
        const float x = s[a][c] * p.scale_log2;
        if (x > m[a]) {
          l[a] = l[a] * exp2f(m[a] - x) + 1.f;
          m[a] = x;
        } else {
          l[a] += exp2f(x - m[a]);
        }
      }
  }

  const T* o = static_cast<const T*>(p.o);
  const T* dout = static_cast<const T*>(p.dout);
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int i = i0 + ty + 16 * a;
    float mm = m[a];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    float ll = m[a] == -INFINITY ? 0.f : l[a] * exp2f(m[a] - mm);
    float dd = 0.f;
    if (i < p.S) {
      const long long row = q_row(p, b, i, h, HD);
      for (int d = tx; d < HD; d += 16)
        dd += to_float(o[row + d]) * to_float(dout[row + d]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      ll += __shfl_xor_sync(0xffffffffu, ll, off);
      dd += __shfl_xor_sync(0xffffffffu, dd, off);
    }
    if (tx == 0 && i < p.S) {
      const long long at = ((long long)b * p.H + h) * p.S + i;
      p.lse[at] = mm == -INFINITY ? 0.f : mm + log2f(ll);
      p.delta[at] = dd;
    }
  }
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
// 2. dK, dV of one key tile over the query tiles of its group's G heads
// ----------------------------------------------------------------------
template <typename T, int HD>
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
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  load_tile<T, HD>(sK, static_cast<const T*>(p.k) + k_row(p, b, t0, kh, HD),
                   (long long)p.KV * HD, keys);
  load_tile<T, HD>(sV, static_cast<const T*>(p.v) + k_row(p, b, t0, kh, HD),
                   (long long)p.KV * HD, keys);

  // query rows that see some key of this tile, then the keyless rows
  const int t_last = t0 + keys - 1;
  const int qlo = p.causal ? max(0, t0 - p.q_offset) : 0;
  const int qhi = p.window > 0
                      ? min(p.S - 1, t_last + p.window - 1 - p.q_offset)
                      : p.S - 1;
  const int n_tiles = (p.S + kTile - 1) / kTile;
  const int seen_end = qlo <= qhi ? qhi / kTile + 1 : 0;  // tiles < this
  const int keyless_from =
      p.window > 0 ? max(0, p.T + p.window - 1 - p.q_offset) : p.S;
  const int tail_begin =
      keyless_from < p.S ? max(keyless_from / kTile, seen_end) : n_tiles;
  const int first = qlo <= qhi ? qlo / kTile : tail_begin;

  float dk[kSub][HD / 16], dv[kSub][HD / 16];
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) dk[a][j] = dv[a][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int qt = first; qt < n_tiles; ++qt) {
      if (qt >= seen_end && qt < tail_begin) qt = tail_begin;
      if (qt >= n_tiles) break;
      const int i0 = qt * kTile;
      const int rows = min(kTile, p.S - i0);
      __syncthreads();   // the last tile's readers are done
      load_tile<T, HD>(sQ, q + q_row(p, b, i0, h, HD), (long long)p.H * HD,
                       rows);
      load_tile<T, HD>(sdO, dout + q_row(p, b, i0, h, HD),
                       (long long)p.H * HD, rows);
      if (threadIdx.x < kTile) {
        const long long at = ((long long)b * p.H + h) * p.S + i0 + threadIdx.x;
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

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
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
// 3. dQ of one query tile over its visible key tiles
// ----------------------------------------------------------------------
template <typename T, int HD>
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
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  load_tile<T, HD>(sQ, static_cast<const T*>(p.q) + q_row(p, b, i0, h, HD),
                   (long long)p.H * HD, rows);
  load_tile<T, HD>(sdO,
                   static_cast<const T*>(p.dout) + q_row(p, b, i0, h, HD),
                   (long long)p.H * HD, rows);
  if (threadIdx.x < kTile) {
    const long long at = ((long long)b * p.H + h) * p.S + i0 + threadIdx.x;
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
    load_tile<T, HD>(sK, k + k_row(p, b, t0, kh, HD), (long long)p.KV * HD,
                     keys);
    load_tile<T, HD>(sV, v + k_row(p, b, t0, kh, HD), (long long)p.KV * HD,
                     keys);
    __syncthreads();
    float s[kSub][kSub], dp[kSub][kSub];
    score_block<HD>(sQ, sK, s, ty, tx);
    score_block<HD>(sdO, sV, dp, ty, tx);
    probs_and_dscores(p, i0, t0, s, dp, sL, sD, nullptr, sdS, ty, tx);
    __syncthreads();
    accumulate<HD, false>(sdS, sK, acc, ty, tx);
  }

  T* dq = static_cast<T*>(p.dq);
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

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int HD>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int tile_bytes = kTile * (HD + 1) * sizeof(float);
  constexpr int score_bytes = kTile * kPad * sizeof(float);
  constexpr int row_bytes = 2 * kTile * sizeof(float);
  constexpr int prep_smem = 2 * tile_bytes;
  constexpr int dkdv_smem = 4 * tile_bytes + 2 * score_bytes + row_bytes;
  constexpr int dq_smem = 4 * tile_bytes + score_bytes + row_bytes;
  static bool attr_set = false;   // once per process and instantiation
  if (!attr_set) {
    int err = allow_smem(bwd_prep<T, HD>, prep_smem);
    if (!err) err = allow_smem(bwd_dkdv<T, HD>, dkdv_smem);
    if (!err) err = allow_smem(bwd_dq<T, HD>, dq_smem);
    if (err) return err;
    attr_set = true;
  }
  const int q_tiles = (p.S + kTile - 1) / kTile;
  const int k_tiles = (p.T + kTile - 1) / kTile;
  bwd_prep<T, HD><<<dim3(q_tiles, p.H, p.B), kThreads, prep_smem, stream>>>(
      p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dkdv<T, HD><<<dim3(k_tiles, p.KV, p.B), kThreads, dkdv_smem,
                    stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dq<T, HD><<<dim3(q_tiles, p.H, p.B), kThreads, dq_smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const Params& p, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every tensor is contiguous: q, o,
// dout, dq [B, S, H, hd]; k, v, dk, dv [B, T, KV, hd]; lse and delta are
// f32 scratch of B * H * S. S, T >= 1. Returns the first launch error.
extern "C" int flash_attention_bwd(int dtype, int hd, const void* q,
                                   const void* k, const void* v,
                                   const void* o, const void* dout, void* dq,
                                   void* dk, void* dv, void* lse,
                                   void* delta, int B, int S, int T, int H,
                                   int KV, int causal, int window,
                                   int q_offset, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.B = B; p.S = S; p.T = T; p.H = H; p.KV = KV;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale = 1.f / sqrtf((float)hd);
  p.scale_log2 = kLog2e * p.scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(hd, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(hd, p, s);
  return (int)cudaErrorInvalidValue;
}
