// The Montgomery passes of the planar batch inversion for Hopper (sm_90a):
// a chain's products spread over many threads.
//
// Replace bsgs_tpu/ops/epoch_kernel.py:_mont_fwd_kernel and
// _mont_bwd_kernel. The function is the TPU kernels': a chain is C
// elements spaced W apart inside a block of C*W columns; the forward pass
// writes each element's exclusive running product along its chain (pre)
// and the chain's product (tot), the backward pass each element's inverse
// from the inverted totals (itot). Field products are associative and
// every value is canonical, so evaluating a chain in another order gives
// the same bits as the serial walk (mont_fwd_plain / mont_bwd_plain).
//
// Layout: a thread block covers 32 neighbouring lanes (threadIdx.x) x S
// segments (threadIdx.y) of their chains, so each warp is one segment of 32
// chains and reads 32 neighbouring columns of each limb row: every load
// and store is coalesced. Thread (lane, s) owns positions s*L .. s*L+L-1
// of its chain (L = C / S, a template parameter, so the L elements stay in
// registers). It loads them all first (16 L independent loads in flight),
// then:
//   forward:  local exclusive prefixes and the segment's product (L - 1
//             multiplies); an inclusive scan of the S segment products in
//             shared memory (log2 S rounds, one multiply per round on the
//             segments that take part); each local prefix times the
//             segment's offset (the product of segments 0..s-1), L - 1
//             multiplies; the last segment's inclusive product is the
//             chain total.
//   backward: the segment's product; q_s = the next segment's product
//             (itot for the last), and an inclusive suffix scan of q, which
//             leaves each segment the running inverse at its end,
//             itot * prod_{s' > s} P_s'; then the serial walk backwards over
//             its L positions (out = run * pre, run = run * v), 2L - 1
//             multiplies.
// A chain of C positions thus runs on S threads and its dependent chain of
// multiplies is about 2L + log2 S long instead of C (2C backwards).
//
// Columns at or past M (the plane's width) count as the element 1 and are
// neither read nor written, so the points entry takes any width: the last
// block of chains is padded in registers, not in memory.
//
// The points entry (kPoints) forms each element in registers from the
// tile's points and the step column: den = Cx - x, or 2y on the doubling
// lanes x == Cx (generation meets P == +C, never P == -C), reading ys only
// on those lanes. So the table build's tile never writes a den plane. Its
// planes are packed (field.cuh): xs, ys, the step column, pre and the
// inverses, 32 B an element; the totals stay (16, T) planes, which the
// inversion takes as they are. The plane entry, the inversion tree's fold,
// keeps the (16, M) layout throughout.
//
// What bounds them: the function is bound by bytes (forward: one element
// read and one written, 64 B at 32 B an element, against one multiply;
// backward: two read and one written against two), but the
// split costs multiplies the serial walk does not make: at the table
// tile's layout (chains of 16 in 8 segments of 2 positions, blocks of
// 32 x 8 threads) the forward pass makes about 2.1 multiplies per element
// and the backward pass about 3.1, against 1 and 2, so the kernels sit
// between the two floors. What the split buys is threads: a 2^18-lane tile
// runs 131,072 of them (8 warps on each scheduler) in place of 16,384.
// Registers: 58-76 at two positions a thread (no spills; chip_smoke.py
// reads them from the build); the scan's shared memory is 1 KiB per segment
// (8 u32 limbs x 32 lanes), 16 KiB a block at most.
#pragma once

#include <cstdint>

#include "field.cuh"

namespace bsgs {

constexpr int kMontLanes = 32;
constexpr int kMontMaxSegments = 16;

typedef uint32_t MontScratch[kMontMaxSegments][8][kMontLanes];

__device__ __forceinline__ void sm_put(MontScratch& sm, int s, int lane,
                                       const Fe& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) sm[s][i][lane] = a.v[i];
}

__device__ __forceinline__ Fe sm_get(const MontScratch& sm, int s,
                                     int lane) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = sm[s][i][lane];
  return r;
}

// The element at column col: v's, or the points entry's denominator; 1
// past the plane's end.
template <bool kPoints>
__device__ __forceinline__ Fe mont_elem(const int32_t* __restrict__ v,
                                        const int32_t* __restrict__ ys,
                                        const Fe& cx, long long M,
                                        long long col) {
  if (col >= M) return fe_one();
  const Fe x = fe_load_at<kPoints>(v, M, col);
  if (!kPoints) return x;
  const Fe d = sub_mod(cx, x);
  if (!fe_is_zero(d)) return d;
  const Fe y = fe_load_at<kPoints>(ys, M, col);
  return add_mod(y, y);
}

struct MontPlace {
  long long base;   // column of the chain's first position
  long long chain;  // index of the chain's total
  int lane, s, S;
};

__device__ __forceinline__ MontPlace mont_place(int L, int W) {
  MontPlace p;
  const int groups = W / kMontLanes;
  const long long b = blockIdx.x / groups;
  const int lane = (int)(blockIdx.x % groups) * kMontLanes + threadIdx.x;
  p.S = blockDim.y;
  p.s = threadIdx.y;
  p.lane = threadIdx.x;
  p.base = b * (long long)(p.S * L) * W + lane;
  p.chain = b * W + lane;
  return p;
}

// Forward pass. v: the plane (or xs), ys and cx: the points entry's; pre
// (16, M), packed (8, M) in the points entry; tot (16, T) with T =
// blocks * W.
template <int L, bool kPoints>
__global__ void __launch_bounds__(kMontLanes * kMontMaxSegments)
    mont_fwd_kernel(const int32_t* __restrict__ v,
                    const int32_t* __restrict__ ys,
                    const int32_t* __restrict__ cxp,
                    int32_t* __restrict__ pre, int32_t* __restrict__ tot,
                    long long M, long long T, int W) {
  __shared__ MontScratch sm;
  const MontPlace p = mont_place(L, W);
  Fe cx;
  if (kPoints) cx = fe_load_packed(cxp, 4);
  Fe loc[L];
#pragma unroll
  for (int i = 0; i < L; ++i)
    loc[i] = mont_elem<kPoints>(v, ys, cx, M,
                                p.base + (long long)(p.s * L + i) * W);
  // loc[i] <- the product of elements 0..i-1 of the segment; acc <- all L
  Fe acc = loc[0];
  loc[0] = fe_one();
#pragma unroll
  for (int i = 1; i < L; ++i) {
    const Fe e = loc[i];
    loc[i] = acc;
    acc = mul_mod(acc, e);
  }
  // inclusive scan of the segment products over s
  sm_put(sm, p.s, p.lane, acc);
  __syncthreads();
  for (int d = 1; d < p.S; d <<= 1) {
    const bool take = p.s >= d;
    Fe other;
    if (take) other = sm_get(sm, p.s - d, p.lane);
    __syncthreads();
    if (take) {
      acc = mul_mod(other, acc);
      sm_put(sm, p.s, p.lane, acc);
    }
    __syncthreads();
  }
  if (p.s == p.S - 1) fe_store(tot, T, p.chain, acc);
  const bool first = p.s == 0;
  Fe off;
  if (!first) off = sm_get(sm, p.s - 1, p.lane);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const long long col = p.base + (long long)(p.s * L + i) * W;
    if (col >= M) break;
    const Fe r = first ? loc[i] : (i == 0 ? off : mul_mod(off, loc[i]));
    fe_store_at<kPoints>(pre, M, col, r);
  }
}

// Backward pass: out = 1/element at every column below M (pre and out
// packed in the points entry).
template <int L, bool kPoints>
__global__ void __launch_bounds__(kMontLanes * kMontMaxSegments)
    mont_bwd_kernel(const int32_t* __restrict__ v,
                    const int32_t* __restrict__ ys,
                    const int32_t* __restrict__ cxp,
                    const int32_t* __restrict__ pre,
                    const int32_t* __restrict__ itot,
                    int32_t* __restrict__ out, long long M, long long T,
                    int W) {
  __shared__ MontScratch sm;
  const MontPlace p = mont_place(L, W);
  Fe cx;
  if (kPoints) cx = fe_load_packed(cxp, 4);
  Fe e[L], pr[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const long long col = p.base + (long long)(p.s * L + i) * W;
    e[i] = mont_elem<kPoints>(v, ys, cx, M, col);
    pr[i] = col < M ? fe_load_at<kPoints>(pre, M, col) : fe_one();
  }
  Fe acc = e[0];
#pragma unroll
  for (int i = 1; i < L; ++i) acc = mul_mod(acc, e[i]);
  // q_s = the next segment's product, itot for the last segment
  sm_put(sm, p.s, p.lane, acc);
  __syncthreads();
  acc = p.s + 1 < p.S ? sm_get(sm, p.s + 1, p.lane)
                      : fe_load(itot + p.chain, 4ull * T);
  __syncthreads();
  sm_put(sm, p.s, p.lane, acc);
  __syncthreads();
  // inclusive suffix scan of q: acc <- itot * prod_{s' > s} P_s'
  for (int d = 1; d < p.S; d <<= 1) {
    const bool take = p.s + d < p.S;
    Fe other;
    if (take) other = sm_get(sm, p.s + d, p.lane);
    __syncthreads();
    if (take) {
      acc = mul_mod(acc, other);
      sm_put(sm, p.s, p.lane, acc);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = L - 1; i >= 0; --i) {
    const long long col = p.base + (long long)(p.s * L + i) * W;
    if (col < M) fe_store_at<kPoints>(out, M, col, mul_mod(acc, pr[i]));
    if (i > 0) acc = mul_mod(acc, e[i]);
  }
}

}  // namespace bsgs
