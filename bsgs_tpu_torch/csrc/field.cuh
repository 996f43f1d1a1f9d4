// secp256k1 field arithmetic for the epoch kernels (sm_90a).
//
// Device counterpart of bsgs_tpu/ops/planar.py (add_mod, sub_mod, mul_mod,
// sqr_mod, x_prefix64, bucket_disc; the inversion is in modinv.cuh). Where
// the TPU kernels kept 16 limbs of 16 bits (the TPU has no 32x32
// multiply-high), a thread here holds one element as 8 little-endian 32-bit
// limbs in registers and runs PTX carry chains (add.cc/addc, sub.cc/subc,
// mad.lo.cc/madc.hi). Every carry chain is one asm block, so no carry flag
// lives across blocks.
//
// The public layout stays the port's planar one: a (16, M) int32 plane of
// 16-bit limbs. fe_load packs limb pairs (2i, 2i+1) into one u32 and
// fe_store splits them again, so the conversion happens only at a kernel's
// boundary. Neighbouring threads take neighbouring columns: each limb row
// is read and written coalesced.
//
// Every result is canonical (< p): the probe keys are the low 64 bits of
// x, and a non-canonical x would change them.
#pragma once

#include <cstdint>

namespace bsgs {

struct Fe {
  uint32_t v[8];
};

#define FE_OUT(r)                                                          \
  "=&r"(r.v[0]), "=&r"(r.v[1]), "=&r"(r.v[2]), "=&r"(r.v[3]),              \
      "=&r"(r.v[4]), "=&r"(r.v[5]), "=&r"(r.v[6]), "=&r"(r.v[7])
#define FE_IN(a)                                                           \
  "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),         \
      "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7])

__device__ __forceinline__ Fe fe_load(const int32_t* __restrict__ plane,
                                      long long stride, long long col) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t lo = (uint32_t)plane[(2 * i) * stride + col];
    uint32_t hi = (uint32_t)plane[(2 * i + 1) * stride + col];
    r.v[i] = lo | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_store(int32_t* __restrict__ plane,
                                         long long stride, long long col,
                                         const Fe& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    plane[(2 * i) * stride + col] = (int32_t)(a.v[i] & 0xFFFFu);
    plane[(2 * i + 1) * stride + col] = (int32_t)(a.v[i] >> 16);
  }
}

__device__ __forceinline__ Fe fe_one() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = 0;
  r.v[0] = 1;
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3] | a.v[4] | a.v[5] | a.v[6] |
          a.v[7]) == 0;
}

__device__ __forceinline__ Fe fe_select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// r = a + b mod 2^256; returns the carry out (0 or 1).
__device__ __forceinline__ uint32_t fe_add_raw(Fe& r, const Fe& a,
                                               const Fe& b) {
  uint32_t c;
  asm("add.cc.u32  %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32    %8, 0, 0;"
      : FE_OUT(r), "=&r"(c)
      : FE_IN(a), FE_IN(b));
  return c;
}

// r = a - b mod 2^256; returns the borrow out (0 or 1).
__device__ __forceinline__ uint32_t fe_sub_raw(Fe& r, const Fe& a,
                                               const Fe& b) {
  uint32_t br;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, 0, 0;"
      : FE_OUT(r), "=&r"(br)
      : FE_IN(a), FE_IN(b));
  return br & 1u;
}

// r = a + (x1 * 2^32 + x0) mod 2^256; returns the carry out.
__device__ __forceinline__ uint32_t fe_add_small(Fe& r, const Fe& a,
                                                 uint32_t x0, uint32_t x1,
                                                 uint32_t x2) {
  uint32_t c;
  asm("add.cc.u32  %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, 0;\n\t"
      "addc.cc.u32 %4, %13, 0;\n\t"
      "addc.cc.u32 %5, %14, 0;\n\t"
      "addc.cc.u32 %6, %15, 0;\n\t"
      "addc.cc.u32 %7, %16, 0;\n\t"
      "addc.u32    %8, 0, 0;"
      : FE_OUT(r), "=&r"(c)
      : FE_IN(a), "r"(x0), "r"(x1), "r"(x2));
  return c;
}

// p = 2^256 - 2^32 - 977; 2^256 mod p = 2^32 + 977.
__device__ __forceinline__ Fe fe_p() {
  Fe r;
  r.v[0] = 0xFFFFFC2Fu;
  r.v[1] = 0xFFFFFFFEu;
#pragma unroll
  for (int i = 2; i < 8; ++i) r.v[i] = 0xFFFFFFFFu;
  return r;
}

// a + top * 2^256 (a value below 2p) -> the canonical value mod p:
// a + top*2^256 - p = a + (2^32 + 977) - (1 - top) * 2^256.
__device__ __forceinline__ Fe fe_canonical(const Fe& a, uint32_t top) {
  Fe t;
  uint32_t c = fe_add_small(t, a, 977u, 1u, 0u);
  return fe_select((top | c) != 0, t, a);
}

__device__ __forceinline__ Fe add_mod(const Fe& a, const Fe& b) {
  Fe s;
  uint32_t c = fe_add_raw(s, a, b);
  return fe_canonical(s, c);
}

__device__ __forceinline__ Fe sub_mod(const Fe& a, const Fe& b) {
  Fe d, t;
  uint32_t br = fe_sub_raw(d, a, b);
  fe_add_raw(t, d, fe_p());
  return fe_select(br != 0, t, d);
}

// One schoolbook row: t[0..8] += a * b[0..7] (t[8] enters as 0 or as the
// running top limb; the row sum never overflows 9 limbs).
__device__ __forceinline__ void mul_row(uint32_t* t, uint32_t a,
                                        const Fe& b) {
  asm("mad.lo.cc.u32  %0, %9, %10, %0;\n\t"
      "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
      "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
      "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
      "addc.u32       %8, %8, 0;\n\t"
      "mad.hi.cc.u32  %1, %9, %10, %1;\n\t"
      "madc.hi.cc.u32 %2, %9, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.hi.cc.u32 %4, %9, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %14, %5;\n\t"
      "madc.hi.cc.u32 %6, %9, %15, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %16, %7;\n\t"
      "madc.hi.u32    %8, %9, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a), FE_IN(b));
}

// 512-bit product t[0..15] -> canonical a*b mod p, folding twice by
// 2^256 = 2^32 + 977.
__device__ __forceinline__ Fe reduce_512(const uint32_t* t) {
  // s[0..8] = lo + hi * 977
  uint32_t s[10];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = t[i];
  s[8] = 0;
  s[9] = 0;
  const uint32_t k = 977u;
  asm("mad.lo.cc.u32  %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32       %8, %8, 0;\n\t"
      "mad.hi.cc.u32  %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32    %8, %16, %17, %8;"
      : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]),
        "+r"(s[5]), "+r"(s[6]), "+r"(s[7]), "+r"(s[8])
      : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]),
        "r"(t[13]), "r"(t[14]), "r"(t[15]), "r"(k));
  // s[1..9] += hi (the 2^32 part of the fold)
  asm("add.cc.u32  %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32    %8, 0, 0;"
      : "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]), "+r"(s[5]),
        "+r"(s[6]), "+r"(s[7]), "+r"(s[8]), "=r"(s[9])
      : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]),
        "r"(t[13]), "r"(t[14]), "r"(t[15]));
  // second fold: top = s8 + s9 * 2^32 (< 2^34) times 2^32 + 977
  uint64_t m = (uint64_t)s[8] * 977u;
  uint64_t v1 = (m >> 32) + (uint64_t)s[9] * 977u + s[8];
  uint32_t x0 = (uint32_t)m;
  uint32_t x1 = (uint32_t)v1;
  uint32_t x2 = (uint32_t)(v1 >> 32) + s[9];
  Fe lo, r;
#pragma unroll
  for (int i = 0; i < 8; ++i) lo.v[i] = s[i];
  uint32_t c = fe_add_small(r, lo, x0, x1, x2);
  // c == 1 leaves r below 2^67, so adding 2^256 mod p cannot carry again;
  // after that r < 2^256 < 2p and one conditional subtraction is exact
  fe_add_small(r, r, 977u * c, c, 0u);
  return fe_canonical(r, 0u);
}

__device__ __forceinline__ Fe mul_mod(const Fe& a, const Fe& b) {
  uint32_t t[17];
#pragma unroll
  for (int i = 0; i < 17; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) mul_row(t + i, a.v[i], b);
  return reduce_512(t);
}

__device__ __forceinline__ Fe sqr_mod(const Fe& a) { return mul_mod(a, a); }

// Probe key of x: the top htsz bits of its low 64 bits (bucket) and the
// 32 bits below them (disc), as bsgs_tpu planar.x_prefix64 + bucket_disc.
__device__ __forceinline__ void probe_key(const Fe& x, int htsz,
                                          uint32_t& bucket, uint32_t& disc) {
  uint32_t lo = x.v[0], hi = x.v[1];
  bucket = hi >> (32 - htsz);
  disc = (hi << htsz) | (lo >> (32 - htsz));
}

}  // namespace bsgs
