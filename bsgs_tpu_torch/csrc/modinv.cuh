// Modular inversion mod the secp256k1 prime by division steps (sm_90a).
//
// The device arithmetic of bsgs_tpu_torch/ops/planar.py:inv_mod_divsteps,
// limb for limb. It computes what bsgs_tpu/ops/epoch_kernel.py's
// _fermat_kernel computes (the canonical x^(p-2) mod p, 0 -> 0), not by an
// exponentiation but by the Bernstein-Yang division steps ("safegcd") in
// batches, the method of libsecp256k1's modinv32/modinv64 and of the GPU
// key-search programs (JeanLucPons' VanitySearch and Kangaroo, _ModInv with
// a delayed right shift of 62 bits). Written from the definition.
//
// State per lane, all in registers: f = p and g = x as 9 signed limbs of 30
// bits, d = 0 and e = 1 likewise (d x = f and e x = g mod p, up to the
// powers of two that the batches divide out), and zeta = -(delta + 1/2),
// starting at -1 (the half-delta variant). One batch:
//   1. 30 division steps decided on the low limbs of f and g alone, with
//      masks and no branch on data, so a warp never diverges inside a
//      batch. They yield a matrix (u, v; q, r), |u| + |v| <= 2^30 and
//      |q| + |r| <= 2^30;
//   2. (f, g) <- (u f + v g, q f + r g) / 2^30, exactly;
//   3. (d, e) <- (u d + v e, q d + r e) / 2^30 mod p, kept in (-2p, p): p is
//      added once for each negative input, then the multiple of p that
//      clears the low 30 bits (from p^-1 mod 2^30). p = 2^256 - 2^32 - 977
//      has three nonzero signed limbs (-977, -4, 0, ..., 0, 2^16), so that
//      multiple costs three products.
// The loop over batches ends when g == 0 in every lane of the warp
// (__any_sync), so only the batch count varies between warps. Then
// f = +-1 and the inverse is +-d, brought into [0, p); x = 0 leaves
// f = p, d = 0 and gives 0.
//
// Why 30 bits and not 62: the card multiplies 32 bits (one IMAD.WIDE for a
// 32x32 -> 64 product with a 64-bit sum); on 62-bit limbs every step of the
// inner loop is a two-instruction 64-bit operation and every product four
// multiplies, for the same number of steps.
//
// Batches: 590 steps are proven enough for inputs below 2^256 in this
// variant (libsecp256k1 runs a fixed 20 x 30), so the loop runs at most
// kMaxBatches = 20, as the plain version does; random inputs need 17 or 18.
//
// Work per inversion (32-bit integer instructions): a step is 21 (3 masks,
// 2 each for g, q, r, zeta and f, 3 each for u and v, 1 shift; nvcc 12.8
// emits just these), the two matrix applications and the loop's test 290
// (72 IMAD.WIDE, the 64-bit shifts and masks of 4 x 9 limbs, the multiple
// of p): 920 a batch as compiled, about 16,800 for 18 batches with the
// limb conversions, against 60,600 for the 294 multiplies of a^(p-2). The
// steps are logic, adds and shifts, which the compiler spreads over the
// integer pipe and the multiplier pipe (IMAD.IADD, IMAD.SHL, IMAD.MOV), so
// the bound is what the four schedulers of an SM can start, not one pipe.
#pragma once

#include <cstdint>

#include "field.cuh"

namespace bsgs {

constexpr int kMaxBatches = 20;
constexpr int32_t kM30 = 0x3FFFFFFF;
constexpr uint32_t kPInv30 = 0x2DDACACFu;  // p^-1 mod 2^30
// p as signed 30-bit limbs: limbs 2..7 are 0
constexpr int32_t kP0 = -977, kP1 = -4, kP8 = 1 << 16;

struct S30 {
  int32_t v[9];
};

__device__ __forceinline__ S30 s30_p() {
  S30 r;
#pragma unroll
  for (int i = 0; i < 9; ++i) r.v[i] = 0;
  r.v[0] = kP0;
  r.v[1] = kP1;
  r.v[8] = kP8;
  return r;
}

// 8 x 32-bit words -> 9 limbs of 30 bits.
__device__ __forceinline__ S30 s30_from_fe(const Fe& a) {
  S30 r;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int j = (30 * k) / 32, s = (30 * k) % 32;
    uint32_t w = a.v[j] >> s;
    if (s != 0 && j + 1 < 8) w |= a.v[j + 1] << (32 - s);
    r.v[k] = (int32_t)(w & (uint32_t)kM30);
  }
  return r;
}

// 9 limbs in [0, 2^30) of a value below 2^256 -> 8 x 32-bit words.
__device__ __forceinline__ Fe fe_from_s30(const S30& a) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = (32 * i) / 30, s = (32 * i) % 30;
    r.v[i] = ((uint32_t)a.v[k] >> s) | ((uint32_t)a.v[k + 1] << (30 - s));
  }
  return r;
}

// 30 division steps on the low limbs; returns the new zeta.
__device__ __forceinline__ int32_t divsteps_30(int32_t zeta, uint32_t f,
                                               uint32_t g, int32_t& tu,
                                               int32_t& tv, int32_t& tq,
                                               int32_t& tr) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < 30; ++i) {
    const uint32_t c1 = (uint32_t)(zeta >> 31);  // all ones where delta > 0
    const uint32_t mask2 = 0u - (g & 1u);        // all ones where g is odd
    const uint32_t mask1 = c1 & mask2;           // both: f and g swap roles
    g = g + ((f ^ c1) & mask2) - mask1;          // g +- f where g is odd
    q = q + ((u ^ c1) & mask2) - mask1;
    r = r + ((v ^ c1) & mask2) - mask1;
    zeta = (int32_t)((uint32_t)zeta ^ mask1) - 1;  // -zeta - 2 on a swap
    f += g & mask1;
    u = (u + (q & mask1)) << 1;
    v = (v + (r & mask1)) << 1;
    g >>= 1;
  }
  tu = (int32_t)u;
  tv = (int32_t)v;
  tq = (int32_t)q;
  tr = (int32_t)r;
  return zeta;
}

// (f, g) <- (u f + v g, q f + r g) / 2^30, exactly.
__device__ __forceinline__ void update_fg_30(S30& f, S30& g, int32_t u,
                                             int32_t v, int32_t q,
                                             int32_t r) {
  int64_t cf = (int64_t)u * f.v[0] + (int64_t)v * g.v[0];
  int64_t cg = (int64_t)q * f.v[0] + (int64_t)r * g.v[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const int32_t fi = f.v[i], gi = g.v[i];
    cf = (cf >> 30) + (int64_t)u * fi + (int64_t)v * gi;
    cg = (cg >> 30) + (int64_t)q * fi + (int64_t)r * gi;
    f.v[i - 1] = (int32_t)cf & kM30;
    g.v[i - 1] = (int32_t)cg & kM30;
  }
  f.v[8] = (int32_t)(cf >> 30);
  g.v[8] = (int32_t)(cg >> 30);
}

// (d, e) <- (u d + v e, q d + r e) / 2^30 mod p, d and e kept in (-2p, p).
__device__ __forceinline__ void update_de_30(S30& d, S30& e, int32_t u,
                                             int32_t v, int32_t q,
                                             int32_t r) {
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (u & sd) + (v & se);
  int32_t me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d.v[0] + (int64_t)v * e.v[0];
  int64_t ce = (int64_t)q * d.v[0] + (int64_t)r * e.v[0];
  md -= (int32_t)((kPInv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)kM30);
  me -= (int32_t)((kPInv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)kM30);
  cd += (int64_t)kP0 * md;
  ce += (int64_t)kP0 * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const int32_t di = d.v[i], ei = e.v[i];
    cd += (int64_t)u * di + (int64_t)v * ei;
    ce += (int64_t)q * di + (int64_t)r * ei;
    if (i == 1) {
      cd += (int64_t)kP1 * md;
      ce += (int64_t)kP1 * me;
    }
    if (i == 8) {
      cd += (int64_t)kP8 * md;
      ce += (int64_t)kP8 * me;
    }
    d.v[i - 1] = (int32_t)cd & kM30;
    e.v[i - 1] = (int32_t)ce & kM30;
    cd >>= 30;
    ce >>= 30;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// r + (p where add is all ones), then the carries: limbs 0..7 end in
// [0, 2^30), limb 8 keeps the sign.
__device__ __forceinline__ void s30_add_p_carry(S30& r, int32_t add) {
  r.v[0] += kP0 & add;
  r.v[1] += kP1 & add;
  r.v[8] += kP8 & add;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.v[i + 1] += r.v[i] >> 30;
    r.v[i] &= kM30;
  }
}

// d in (-2p, p), negated where sign < 0 -> the 9 limbs of d mod p.
__device__ __forceinline__ void normalize_30(S30& d, int32_t sign) {
  const int32_t add = d.v[8] >> 31, neg = sign >> 31;
  d.v[0] += kP0 & add;
  d.v[1] += kP1 & add;
  d.v[8] += kP8 & add;
#pragma unroll
  for (int i = 0; i < 9; ++i) d.v[i] = (d.v[i] ^ neg) - neg;
  s30_add_p_carry(d, 0);
  s30_add_p_carry(d, d.v[8] >> 31);
}

// The canonical inverse of canonical a mod p; 0 -> 0. Every lane of the
// warp must call it (the loop's test is a warp vote).
__device__ __forceinline__ Fe inv_mod_divsteps(const Fe& a) {
  S30 f = s30_p(), g = s30_from_fe(a), d, e;
#pragma unroll
  for (int i = 0; i < 9; ++i) d.v[i] = e.v[i] = 0;
  e.v[0] = 1;
  int32_t zeta = -1;
  for (int it = 0; it < kMaxBatches; ++it) {
    int32_t nz = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) nz |= g.v[i];
    if (!__any_sync(0xFFFFFFFFu, nz != 0)) break;
    int32_t u, v, q, r;
    zeta = divsteps_30(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], u, v, q, r);
    update_de_30(d, e, u, v, q, r);
    update_fg_30(f, g, u, v, q, r);
  }
  normalize_30(d, f.v[8]);
  return fe_from_s30(d);
}

}  // namespace bsgs
