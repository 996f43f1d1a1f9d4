// secp256k1 field arithmetic for the epoch kernels (sm_90a).
//
// Device counterpart of bsgs_tpu/ops/planar.py (add_mod, sub_mod, mul_mod,
// sqr_mod, x_prefix64, bucket_disc; the inversion is in modinv.cuh). Where
// the TPU kernels kept 16 limbs of 16 bits (the TPU has no 32x32
// multiply-high), a thread here holds one element as 8 little-endian 32-bit
// limbs in registers and runs PTX carry chains (add.cc/addc, sub.cc/subc,
// mad.lo.cc/madc.hi). Every carry chain is one asm block, so no carry flag
// lives across blocks. mul_mod and sqr_mod form their products as pairs of
// words, which compile to half the instructions of schoolbook rows; the
// section above mad_pairs says why.
//
// Two layouts reach the kernels. The planar one, a (16, M) int32 plane of
// 16-bit limbs, is the JAX package's: the inversion's planes (fermat and
// the Montgomery plane entry, the chain totals) keep it, and fe_load joins
// limb pairs (2i, 2i+1) into one u32 while fe_store splits them again. The
// packed one, a (8, M) int32 plane whose row i holds word i of each element
// (limb 2i | limb 2i+1 << 16, the Fe register form), is what the planes
// that live only inside an epoch or a tile advance use: the offsets, the
// centers, the epoch's pre, the tile's points, its pre and its inverses
// (fe_load_packed, fe_store_packed). An element moves 32 bytes there, 64 in
// the planar layout, where half of the bytes are zero high halves.
// Neighbouring threads take neighbouring columns: each row is read and
// written coalesced, 128 bytes a warp.
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

// The element whose limb 0 is at p, the next limbs step bytes apart (4
// times the plane's width): the address walks by 64-bit adds on the second
// integer pipe, and each limb pair is joined by one byte permute (a shift
// by 16 would be an IMAD on the multiplier pipe). A kernel that is short
// of multiplier issues takes step from the host as it is: computed in the
// kernel as 4 * width, ptxas folds each add into an IMAD.WIDE.
__device__ __forceinline__ Fe fe_load(const int32_t* __restrict__ p,
                                      uint64_t step) {
  const char* a = (const char*)p;
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t lo = (uint32_t)__ldg((const int32_t*)a);
    a += step;
    const uint32_t hi = (uint32_t)__ldg((const int32_t*)a);
    a += step;
    r.v[i] = __byte_perm(lo, hi, 0x5410);
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

// The element whose word 0 is at p in a packed plane, the next words step
// bytes apart (4 times the plane's row stride).
__device__ __forceinline__ Fe fe_load_packed(const int32_t* __restrict__ p,
                                             uint64_t step) {
  const char* a = (const char*)p;
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.v[i] = (uint32_t)__ldg((const int32_t*)a);
    a += step;
  }
  return r;
}

__device__ __forceinline__ void fe_store_packed(int32_t* __restrict__ p,
                                                uint64_t step, const Fe& a) {
  char* q = (char*)p;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    *(int32_t*)q = (int32_t)a.v[i];
    q += step;
  }
}

// Column col of a plane of width M in either layout.
template <bool kPacked>
__device__ __forceinline__ Fe fe_load_at(const int32_t* __restrict__ plane,
                                         long long M, long long col) {
  if constexpr (kPacked)
    return fe_load_packed(plane + col, 4ull * M);
  else
    return fe_load(plane + col, 4ull * M);
}

template <bool kPacked>
__device__ __forceinline__ void fe_store_at(int32_t* __restrict__ plane,
                                            long long M, long long col,
                                            const Fe& a) {
  if constexpr (kPacked)
    fe_store_packed(plane + col, 4ull * M, a);
  else
    fe_store(plane, M, col, a);
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

// The pair products. Schoolbook rows (a * b_j added to one carry chain,
// each 32x32 product as two PTX multiply-adds, lo and hi, into neighbouring
// words) compile each multiply-add to an IMAD plus an IADD3.X that
// carries: 338 SASS instructions a multiply, half on each integer pipe
// (nvcc 12.9, sm_90a). A product whose lo and hi land on one aligned pair
// of words of a chain (mad.lo.cc then madc.hi.cc into w[2m], w[2m+1])
// compiles instead to one IMAD.WIDE.U32.X, which takes the carry in and
// out in a predicate. So the products are split by the parity of their
// position: the even-position ones chain over pairs (0,1), (2,3), ... of
// one accumulator and the odd-position ones over (1,2), (3,4), ... of a
// second, and one add chain joins the two at the end. An IMAD.WIDE
// occupies the multiplier pipe for two issues, so the 64 products cost
// that pipe 128 slots, but the IADD3.X of every product is gone.

// w[0..2n-1] += (a0 + a1 2^64 + a2 2^128 + a3 2^192) * b (the first n
// terms): one 64-bit multiply-add per term, each landing on a whole pair of
// words, so the chain compiles to IMAD.WIDE.U32.X with its carry in a
// predicate. With kCarry the carry out is added to w[2n]; without it the
// caller knows there is none.
template <int n, bool kCarry>
__device__ __forceinline__ void mad_pairs(uint32_t* w, uint32_t b,
                                          uint32_t a0, uint32_t a1 = 0,
                                          uint32_t a2 = 0, uint32_t a3 = 0) {
  if constexpr (n == 1 && kCarry) {
    asm("mad.lo.cc.u32  %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
        "addc.u32       %2, %2, 0;"
        : "+r"(w[0]), "+r"(w[1]), "+r"(w[2])
        : "r"(a0), "r"(b));
  } else if constexpr (n == 1 && !kCarry) {
    asm("mad.lo.cc.u32  %0, %2, %3, %0;\n\t"
        "madc.hi.u32    %1, %2, %3, %1;"
        : "+r"(w[0]), "+r"(w[1])
        : "r"(a0), "r"(b));
  } else if constexpr (n == 2 && kCarry) {
    asm("mad.lo.cc.u32  %0, %5, %7, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %6, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %6, %7, %3;\n\t"
        "addc.u32       %4, %4, 0;"
        : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4])
        : "r"(a0), "r"(a1), "r"(b));
  } else if constexpr (n == 2 && !kCarry) {
    asm("mad.lo.cc.u32  %0, %4, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %4, %6, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %6, %2;\n\t"
        "madc.hi.u32    %3, %5, %6, %3;"
        : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3])
        : "r"(a0), "r"(a1), "r"(b));
  } else if constexpr (n == 3 && kCarry) {
    asm("mad.lo.cc.u32  %0, %7, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %8, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %8, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %10, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %10, %5;\n\t"
        "addc.u32       %6, %6, 0;"
        : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]),
          "+r"(w[5]), "+r"(w[6])
        : "r"(a0), "r"(a1), "r"(a2), "r"(b));
  } else if constexpr (n == 3 && !kCarry) {
    asm("mad.lo.cc.u32  %0, %6, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %6, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %9, %3;\n\t"
        "madc.lo.cc.u32 %4, %8, %9, %4;\n\t"
        "madc.hi.u32    %5, %8, %9, %5;"
        : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]),
          "+r"(w[5])
        : "r"(a0), "r"(a1), "r"(a2), "r"(b));
  } else if constexpr (n == 4 && kCarry) {
    asm("mad.lo.cc.u32  %0, %9, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
        "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
        "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
        "addc.u32       %8, %8, 0;"
        : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]),
          "+r"(w[5]), "+r"(w[6]), "+r"(w[7]), "+r"(w[8])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b));
  } else if constexpr (n == 4 && !kCarry) {
    asm("mad.lo.cc.u32  %0, %8, %12, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
        "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
        "madc.hi.u32    %7, %11, %12, %7;"
        : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]),
          "+r"(w[5]), "+r"(w[6]), "+r"(w[7])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b));
  }
}

// 512-bit t[0..15] -> canonical t mod p: the fold by 2^256 = 2^32 + 977
// with the products t_hi * 977 as pairs, then the small second fold and the
// canonical step, each behind a branch that data almost never takes.
__device__ __forceinline__ Fe reduce_512(const uint32_t* t) {
  const uint32_t k = 977u;
  // s[0..8] = lo + (even limbs of hi) * 977
  uint32_t s[10];
  asm("mad.lo.cc.u32  %0, %9, %13, %14;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %15;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %16;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %17;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %18;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %19;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %20;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %21;\n\t"
      "addc.u32       %8, 0, 0;"
      : "=&r"(s[0]), "=&r"(s[1]), "=&r"(s[2]), "=&r"(s[3]), "=&r"(s[4]),
        "=&r"(s[5]), "=&r"(s[6]), "=&r"(s[7]), "=&r"(s[8])
      : "r"(t[8]), "r"(t[10]), "r"(t[12]), "r"(t[14]), "r"(k), "r"(t[0]),
        "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]),
        "r"(t[7]));
  // + (odd limbs of hi) * 977, then s[1..9] += hi (the 2^32 part)
  mad_pairs<4, false>(s + 1, k, t[9], t[11], t[13], t[15]);
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
  const uint64_t m = (uint64_t)s[8] * 977u;
  const uint64_t v1 = (m >> 32) + (uint64_t)s[9] * 977u + s[8];
  Fe lo, r;
#pragma unroll
  for (int i = 0; i < 8; ++i) lo.v[i] = s[i];
  const uint32_t c = fe_add_small(r, lo, (uint32_t)m, (uint32_t)v1,
                                  (uint32_t)(v1 >> 32) + s[9]);
  // c == 1 leaves r below 2^67, so adding 2^256 mod p cannot carry again
  if (c) fe_add_small(r, r, 977u, 1u, 0u);
  // r >= p only if its six top words are all ones
  if ((r.v[2] & r.v[3] & r.v[4] & r.v[5] & r.v[6] & r.v[7]) == 0xFFFFFFFFu)
    r = fe_canonical(r, 0u);
  return r;
}

// a * b mod p, canonical, by pair products: row j adds a * b_j as two
// chains, the even limbs of a at positions j, j + 2, ... (with a carry into
// the word above) and the odd limbs at j + 1, j + 3, ...; the parity of j
// decides which accumulator takes which. After row j each accumulator is
// below 2^(32 (j + 9)), so no chain carries past the word it names.
__device__ __forceinline__ Fe mul_mod(const Fe& a, const Fe& b) {
  uint32_t e[16], o[16];  // products at even / odd positions
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint64_t p = (uint64_t)a.v[2 * k] * b.v[0];
    e[2 * k] = (uint32_t)p;
    e[2 * k + 1] = (uint32_t)(p >> 32);
    p = (uint64_t)a.v[2 * k + 1] * b.v[0];
    o[2 * k + 1] = (uint32_t)p;
    o[2 * k + 2] = (uint32_t)(p >> 32);
  }
#pragma unroll
  for (int k = 8; k < 16; ++k) e[k] = 0;
#pragma unroll
  for (int k = 9; k < 16; ++k) o[k] = 0;
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    uint32_t* x = (j & 1) ? o : e;
    uint32_t* y = (j & 1) ? e : o;
    mad_pairs<4, true>(x + j, b.v[j], a.v[0], a.v[2], a.v[4], a.v[6]);
    if (j < 7)
      mad_pairs<4, true>(y + j + 1, b.v[j], a.v[1], a.v[3], a.v[5], a.v[7]);
    else
      mad_pairs<4, false>(y + j + 1, b.v[j], a.v[1], a.v[3], a.v[5], a.v[7]);
  }
  // e[1..15] += o[1..15], in two chains (an asm block takes 30 operands)
  uint32_t c;
  asm("add.cc.u32  %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32    %8, 0, 0;"
      : "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]),
        "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "=r"(c)
      : "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]),
        "r"(o[7]), "r"(o[8]));
  // the first add sets the carry flag to c (c + 2^32 - 1 carries iff c)
  asm("add.cc.u32  %7, %7, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.u32    %6, %6, %14;"
      : "+r"(e[9]), "+r"(e[10]), "+r"(e[11]), "+r"(e[12]), "+r"(e[13]),
        "+r"(e[14]), "+r"(e[15]), "+r"(c)
      : "r"(o[9]), "r"(o[10]), "r"(o[11]), "r"(o[12]), "r"(o[13]),
        "r"(o[14]), "r"(o[15]));
  return reduce_512(e);
}

// a^2 mod p, canonical: the 28 cross products a_i a_j (i < j) as pairs
// (even positions in e, odd in o), doubled, plus the 8 squares a_i^2 at
// 2i: 36 products where mul_mod makes 64.
__device__ __forceinline__ Fe sqr_mod(const Fe& a) {
  const uint32_t* v = a.v;
  uint32_t e[16], o[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t p = (uint64_t)v[0] * v[2 * k + 1];
    o[2 * k + 1] = (uint32_t)p;
    o[2 * k + 2] = (uint32_t)(p >> 32);
  }
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const uint64_t p = (uint64_t)v[0] * v[2 * k];
    e[2 * k] = (uint32_t)p;
    e[2 * k + 1] = (uint32_t)(p >> 32);
  }
#pragma unroll
  for (int k = 8; k < 16; ++k) e[k] = 0;
#pragma unroll
  for (int k = 9; k < 16; ++k) o[k] = 0;
  // row i: a_i times a_j for j > i, at positions i + j
  mad_pairs<3, true>(o + 3, v[1], v[2], v[4], v[6]);
  mad_pairs<3, true>(e + 4, v[1], v[3], v[5], v[7]);
  mad_pairs<3, true>(o + 5, v[2], v[3], v[5], v[7]);
  mad_pairs<2, true>(e + 6, v[2], v[4], v[6]);
  mad_pairs<2, true>(o + 7, v[3], v[4], v[6]);
  mad_pairs<2, true>(e + 8, v[3], v[5], v[7]);
  mad_pairs<2, true>(o + 9, v[4], v[5], v[7]);
  mad_pairs<1, true>(e + 10, v[4], v[6]);
  mad_pairs<1, true>(o + 11, v[5], v[6]);
  mad_pairs<1, true>(e + 12, v[5], v[7]);
  mad_pairs<1, true>(o + 13, v[6], v[7]);
  // z = e + o in e[1..15] (e[0], e[1] and o[0] are zero)
  asm("add.cc.u32  %0, %0, %14;\n\t"
      "addc.cc.u32 %1, %1, %15;\n\t"
      "addc.cc.u32 %2, %2, %16;\n\t"
      "addc.cc.u32 %3, %3, %17;\n\t"
      "addc.cc.u32 %4, %4, %18;\n\t"
      "addc.cc.u32 %5, %5, %19;\n\t"
      "addc.cc.u32 %6, %6, %20;\n\t"
      "addc.cc.u32 %7, %7, %21;\n\t"
      "addc.cc.u32 %8, %8, %22;\n\t"
      "addc.cc.u32 %9, %9, %23;\n\t"
      "addc.cc.u32 %10, %10, %24;\n\t"
      "addc.cc.u32 %11, %11, %25;\n\t"
      "addc.cc.u32 %12, %12, %26;\n\t"
      "addc.u32    %13, %27, 0;"
      : "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]), "+r"(e[6]),
        "+r"(e[7]), "+r"(e[8]), "+r"(e[9]), "+r"(e[10]), "+r"(e[11]),
        "+r"(e[12]), "+r"(e[13]), "+r"(e[14]), "=r"(e[15])
      : "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]),
        "r"(o[8]), "r"(o[9]), "r"(o[10]), "r"(o[11]), "r"(o[12]),
        "r"(o[13]), "r"(o[14]), "r"(o[15]));
  e[1] = o[1];
  // x = 2z + the squares
  uint32_t x[16];
  x[0] = 0;
  x[15] = __funnelshift_l(e[14], e[15], 1);
#pragma unroll
  for (int k = 14; k >= 2; --k) x[k] = __funnelshift_l(e[k - 1], e[k], 1);
  x[1] = e[1] << 1;
  asm("mad.lo.cc.u32  %0, %16, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
      "madc.hi.u32    %15, %23, %23, %15;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
        "+r"(x[5]), "+r"(x[6]), "+r"(x[7]), "+r"(x[8]), "+r"(x[9]),
        "+r"(x[10]), "+r"(x[11]), "+r"(x[12]), "+r"(x[13]), "+r"(x[14]),
        "+r"(x[15])
      : "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(v[4]), "r"(v[5]),
        "r"(v[6]), "r"(v[7]));
  return reduce_512(x);
}

// Probe key of x: the top htsz bits of its low 64 bits (bucket) and the
// 32 bits below them (disc), as bsgs_tpu planar.x_prefix64 + bucket_disc.
__device__ __forceinline__ void probe_key(const Fe& x, int htsz,
                                          uint32_t& bucket, uint32_t& disc) {
  uint32_t lo = x.v[0], hi = x.v[1];
  bucket = hi >> (32 - htsz);
  disc = (hi << htsz) | (lo >> (32 - htsz));
}

}  // namespace bsgs
