// Helpers of the RWKV6 scan's chunked kernels on the tensor cores, the
// forward's (rwkv6_scan.cu) and the backward's (rwkv6_backward.cu): bf16
// unpacking, the three-term split, the sub-chunk pair index, the log2 of
// a decay with a small relative error near 1, the tiles' geometry, and
// the A tiles (factored, or exact where a diagonal block is too wide).
#pragma once

#include "tensor_core.cuh"

namespace repro_torch {

// 8 bf16 in one 16-byte word -> f32
__device__ __forceinline__ void unpack8(const uint4 raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 t = unpack(w[q]);
    f[2 * q] = t.x;
    f[2 * q + 1] = t.y;
  }
}

// (a, b) as three bf16 pairs hi + mid + lo: all 24 bits of an f32 value.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  split2(a - hf.x, b - hf.y, mid, lo);
  hi = as_u32(h);
}

// out[0..8) = p[0..8) as two 16-byte shared-memory loads (p 16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// pairs (i <= j) of sub-chunks: s in sub-chunk i, t in sub-chunk j
__host__ __device__ constexpr int pair(int i, int j) { return j * (j + 1) / 2 + i; }

// x[idx] of a register array without local memory
template <int N>
__device__ __forceinline__ float pick(const float (&x)[N], int idx) {
  float v = x[0];
#pragma unroll
  for (int m = 1; m < N; ++m) v = idx == m ? x[m] : v;
  return v;
}

// log2(max(w, 1e-38)), the TPU kernel's clamp, for w <= 1, with a small
// relative error also where w is close to 1 (a decay's log is then tiny,
// and lg2.approx's absolute error of 2^-22 would be a large relative
// one): w = 2^e m with m in [sqrt(1/2), sqrt(2)), log2 m = (2 / ln 2)
// atanh(z), z = (m-1)/(m+1), |z| <= 0.172, summed to z^9 (truncation
// ~2e-9 relative). Denormals (1e-38 is one) are scaled by 2^24 first.
__device__ __forceinline__ float log2_decay(float w) {
  float x = fmaxf(w, 1e-38f);
  const bool tiny = x < 1.17549435e-38f;
  x = tiny ? x * 16777216.f : x;
  const int bits = __float_as_int(x);
  int e = ((bits >> 23) & 0xff) - 127 - (tiny ? 24 : 0);
  float m = __int_as_float((bits & 0x7fffff) | 0x3f800000);   // [1, 2)
  if (m > 1.41421356f) {
    m *= 0.5f;
    e += 1;
  }
  const float z = __fdividef(m - 1.f, m + 1.f);
  const float z2 = z * z;
  float q = fmaf(z2, 1.f / 9.f, 1.f / 7.f);
  q = fmaf(z2, q, 1.f / 5.f);
  q = fmaf(z2, q, 1.f / 3.f);
  q = fmaf(z2, q, 1.f);
  return fmaf(z * q, 2.f * kLog2e, (float)e);
}

// the bf16 pair (hi + lo) scaled by (f.x, f.y), split again into hi + lo
__device__ __forceinline__ void rescale(uint32_t& hi, uint32_t& lo, float2 f) {
  const float2 a = unpack(hi), b = unpack(lo);
  split2((a.x + b.x) * f.x, (a.y + b.y) * f.y, hi, lo);
}

// The chunked kernels' tiles: chunks of 64 steps in sub-chunks of 16 at
// head dim 64 (rwkv6-3b's), bf16 rows padded by 8 (ldmatrix without bank
// conflicts), A tiles [16][16] per sub-chunk pair i <= j.
namespace rwkv6 {

constexpr int kHD = 64;            // head dim
constexpr int kChunk = 64;         // steps per chunk
constexpr int kSub = 16;           // steps per sub-chunk (one mma row tile)
constexpr int kNSub = kChunk / kSub;
constexpr int kPairs = kNSub * (kNSub + 1) / 2;   // sub-chunk pairs i <= j
constexpr int kLd = kHD + 8;       // bf16 row of a [64][64] tile
constexpr int kLdD = kSub + 8;     // bf16 row of a [16][16] tile
constexpr int kLdL = kHD + 4;      // f32 row of Lc
constexpr int kOp = kChunk * kLd;  // elements of one term of an operand
constexpr int kDTile = kSub * kLdD;   // elements of one term of an A tile
constexpr float kSpanMax = 64.f;   // widest log2-decay a diagonal block factors

// cp.async moves 16-byte pieces: bases and strides (in elements of
// `elem` bytes) must be 16-byte multiples
inline bool aligned16(const void* ptr, int elem, long long s0, long long s1,
                      long long s2) {
  const long long per = 16 / elem;
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0 % per == 0 &&
         s1 % per == 0 && s2 % per == 0;
}

// the sub-chunk j of pair index pr (s in sub-chunk i <= j, t in j)
__device__ __forceinline__ int pair_j(int pr) {
  return pr >= pair(0, 3) ? 3 : pr >= pair(0, 2) ? 2 : pr >= pair(0, 1) ? 1 : 0;
}

// A's diagonal block of sub-chunk tid / 64 (threads 0..255) on the CUDA
// cores with exact pairwise exponents, for a block too wide to factor:
// A[t][s] = sum_c r_t k_s 2^{Lc[t] - Lc[s+1]} (s < t), A[t][t] = r_t .
// (u o k_t), 0 above, written as bf16 hi + lo into its tile of Ax. Rs,
// Ks [64][kLd] bf16, Lc [65][kLdL] f32, ub [64] u. Thread: rows ta = i8
// and tb = 15 - i8 of the sub-chunk (15 pairs together), channels 8 dq
// ..; the 8 dq lanes meet by shuffles.
__device__ __forceinline__ void exact_diag_a(int tid, const __nv_bfloat16* Rs,
                                             const __nv_bfloat16* Ks,
                                             const float* Lc, const float* ub,
                                             __nv_bfloat16* Ax) {
  const int jd = tid >> 6;
  const int i8 = (tid >> 3) & 7, dq = tid & 7;
  const int ta = jd * kSub + i8, tb = jd * kSub + kSub - 1 - i8;
  float ra[8], rb[8], la[8], lb[8], u8[8];
  unpack8(*reinterpret_cast<const uint4*>(Rs + ta * kLd + 8 * dq), ra);
  load8(Lc + ta * kLdL + 8 * dq, la);
  unpack8(*reinterpret_cast<const uint4*>(Rs + tb * kLd + 8 * dq), rb);
  load8(Lc + tb * kLdL + 8 * dq, lb);
  load8(ub + 8 * dq, u8);
  float aa[kSub], ab[kSub];
#pragma unroll
  for (int sl = 0; sl < kSub; ++sl) {
    const int s = jd * kSub + sl;
    float kk[8], ls[8];
    unpack8(*reinterpret_cast<const uint4*>(Ks + s * kLd + 8 * dq), kk);
    load8(Lc + (s + 1) * kLdL + 8 * dq, ls);
    float va = 0.f, vb = 0.f;
    if (sl < i8) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        va = fmaf(ra[e] * kk[e], fast_exp2(la[e] - ls[e]), va);
    } else if (sl == i8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) va = fmaf(ra[e] * kk[e], u8[e], va);
    }
    if (sl < kSub - 1 - i8) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        vb = fmaf(rb[e] * kk[e], fast_exp2(lb[e] - ls[e]), vb);
    } else if (sl == kSub - 1 - i8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) vb = fmaf(rb[e] * kk[e], u8[e], vb);
    }
    aa[sl] = va;
    ab[sl] = vb;
  }
#pragma unroll
  for (int sl = 0; sl < kSub; ++sl)
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      aa[sl] += __shfl_xor_sync(0xffffffffu, aa[sl], off);
      ab[sl] += __shfl_xor_sync(0xffffffffu, ab[sl], off);
    }
  // lane dq writes columns 2 dq, 2 dq + 1 of both rows
  __nv_bfloat16* DH = Ax + pair(jd, jd) * 2 * kDTile;
  __nv_bfloat16* DL = DH + kDTile;
  float2 va = make_float2(0.f, 0.f), vb = va;
#pragma unroll
  for (int sl = 0; sl < kSub; sl += 2)
    if (sl == 2 * dq) {
      va = make_float2(aa[sl], aa[sl + 1]);
      vb = make_float2(ab[sl], ab[sl + 1]);
    }
  uint32_t hi, lo;
  split2(va.x, va.y, hi, lo);
  *reinterpret_cast<uint32_t*>(DH + i8 * kLdD + 2 * dq) = hi;
  *reinterpret_cast<uint32_t*>(DL + i8 * kLdD + 2 * dq) = lo;
  split2(vb.x, vb.y, hi, lo);
  *reinterpret_cast<uint32_t*>(DH + (kSub - 1 - i8) * kLdD + 2 * dq) = hi;
  *reinterpret_cast<uint32_t*>(DL + (kSub - 1 - i8) * kLdD + 2 * dq) = lo;
}

// Unit u < 2 kPairs of the A tiles on mma.sync: columns 8 (u % 2).. of
// pair u / 2 = (i, j), A[t][s] = Rt[t] . (Kh[s] F), F = fac[pair] (Kh's
// fragments rescaled); both f32: hi hi + hi lo + lo hi, even and odd k
// steps in two accumulators. The diagonal tile is masked to s < t and
// takes the bonus on s = t. RtH, KhH: [hi, lo][64][kLd]; fac [pairs][64];
// bonus [64]; Ax [pairs][hi, lo][16][kLdD].
__device__ __forceinline__ void a_tile_unit(int u, int lane,
                                            const __nv_bfloat16* RtH,
                                            const __nv_bfloat16* KhH,
                                            const float* fac, const float* bonus,
                                            __nv_bfloat16* Ax) {
  const int g = lane >> 2, tq = lane & 3;
  const int pr = u >> 1, hu = u & 1;
  const int jj = pair_j(pr), ii = pr - pair(0, jj);
  float G[2][4] = {};
#pragma unroll
  for (int k2 = 0; k2 < kHD / 32; ++k2) {
    uint32_t bh[4], bl[4];
    const int boff = (ii * kSub + 8 * hu + (lane & 7)) * kLd +
                     (2 * k2 + (lane >> 4)) * 16 + ((lane >> 3) & 1) * 8;
    ldsm_x4(bh, KhH + boff);
    ldsm_x4(bl, KhH + kOp + boff);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int kk = 2 * k2 + h2;
      const float* f = fac + pr * kHD + kk * 16 + 2 * tq;
      rescale(bh[2 * h2], bl[2 * h2], *reinterpret_cast<const float2*>(f));
      rescale(bh[2 * h2 + 1], bl[2 * h2 + 1],
              *reinterpret_cast<const float2*>(f + 8));
      uint32_t ah[4], al[4];
      const int aoff =
          (jj * kSub + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(ah, RtH + aoff);
      ldsm_x4(al, RtH + kOp + aoff);
      mma16816(G[h2], ah, bh[2 * h2], bh[2 * h2 + 1]);
      mma16816(G[h2], ah, bl[2 * h2], bl[2 * h2 + 1]);
      mma16816(G[h2], al, bh[2 * h2], bh[2 * h2 + 1]);
    }
  }
  float a[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    a[e] = G[0][e] + G[1][e];
    if (ii == jj) {
      const int tl = g + 8 * (e >> 1), sl = 8 * hu + 2 * tq + (e & 1);
      a[e] = sl < tl ? a[e] : sl == tl ? bonus[jj * kSub + tl] : 0.f;
    }
  }
  __nv_bfloat16* AH = Ax + pr * 2 * kDTile;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    uint32_t vh, vl;
    split2(a[2 * rr], a[2 * rr + 1], vh, vl);
    const int off = (g + 8 * rr) * kLdD + 8 * hu + 2 * tq;
    *reinterpret_cast<uint32_t*>(AH + off) = vh;
    *reinterpret_cast<uint32_t*>(AH + kDTile + off) = vl;
  }
}

}  // namespace rwkv6

}  // namespace repro_torch
