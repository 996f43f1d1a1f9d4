// The giant-step epoch and table-generation kernels for Hopper (sm_90a).
//
// Hand-written counterparts of the six Pallas kernels of
// bsgs_tpu/ops/epoch_kernel.py, over field.cuh. The epoch passes, the
// inversion and add_const are one thread per chain or per lane; the
// Montgomery passes spread a chain over many threads (mont.cuh). The
// Python wrappers (bsgs_tpu_torch/ops/epoch_kernel.py) check shapes,
// allocate every output and launch on PyTorch's current stream. Each C
// entry returns cudaGetLastError() so a refused launch raises in the
// wrapper.
//
// What bounds them: an SM has two 32-bit integer pipes of 64 lanes, the
// multiplier pipe (IMAD forms) and the other (adds, logic, shifts,
// selects), and its schedulers issue 128 lanes a clock over both; a field
// element is 32 bytes. The planes that live only inside an epoch or a tile
// advance are packed (field.cuh), so an element moves those 32 bytes; the
// (16, M) limb planes that the inversion keeps move 64, half of them zero.
// A kernel's floor is the largest of three: its products on the
// multiplier pipe (an IMAD.WIDE at two issues; the moves and adds that
// ptxas also places there could run on the other pipe), its integer
// instructions over both pipes, and its bytes. As nvcc 12.9 compiles
// field.cuh (chip_smoke.py reads the counts from the build): mul_mod is
// 159 integer instructions, 74 of them IMAD.WIDE products (148 issues);
// sqr_mod 140, 93 issues; add_mod and sub_mod 17-19 on the other pipe.
// So epoch_bwd (778 multiplier issues and 1,047 instructions a pair) is
// bound by the multiplier pipe, the inversion (modinv.cuh, about 16,800
// instructions an element) by integer issue, and epoch_fwd, mont_fwd,
// mont_bwd and add_const (1-4 multiplies against 2-5 elements moved) by
// bytes, at 32 B an element. Every value stays in registers; each input
// plane is read once and each output plane written once.
//
// Chains and lanes: a chain is C elements spaced W apart inside a block of
// C*W columns, as in the Pallas kernels (the TPU walked a block's C chunks
// of W lanes in order). In the epoch passes a thread owns one lane of one
// block, neighbouring threads neighbouring lanes, so a warp reads 32
// neighbouring columns of each row: every load and store is coalesced. The
// chain length C is the wrapper's choice: shorter chains mean more threads
// in flight per SM. The centers (8, T) may be a column slice of a wider
// packed plane: the kernels take its row stride (ldc).

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "modinv.cuh"
#include "mont.cuh"

using bsgs::Fe;

namespace {

constexpr int kBlock = 128;

inline unsigned grid_for(long long threads) {
  return (unsigned)((threads + kBlock - 1) / kBlock);
}

// Replaces bsgs_tpu/ops/epoch_kernel.py:_fwd_kernel. Thread g = (t, r)
// walks chain r of job t: d = Ox - Mx (0 -> 1), the exclusive running
// products into pre, the chain total into tot[g].
//
// Bound: bytes. A pair reads its offset and writes its prefix, 64 B at 32
// B an element, against one multiply (148 multiplier issues): at T=4,
// N=2^18 the function's floor is 44 MB, 0.0131 ms at 3.35 TB/s, and its
// multiplies 0.0093 ms of the multiplier pipe. Its 65,536 threads (one a
// chain of 16) fill the card in one wave at about 4 warps a scheduler, too
// few to hide a load behind other warps' multiplies. What the design does
// about it: ox, the centers and pre are packed planes, so a pair moves
// 64 B where the (16, M) planes moved 128; a thread walks its chain in
// batches of kFwdBatch offsets and loads the next batch before it walks
// the current one, so 2-4 offsets of each thread are in flight. The
// neighbouring blocks take neighbouring chains of one job (the jobs' reads
// of an offset meet in the L2 all the same: ox is 8 MB packed at N=2^18);
// chip_smoke.py --packed times this against loading one offset ahead, in
// place, or in batches of 2-8, and against grouping a chain's T jobs in
// neighbouring blocks. pre keeps the default store policy: epoch_bwd reads
// it after the inversion.
constexpr int kFwdBatch = 2;

__global__ void __launch_bounds__(kBlock)
    epoch_fwd_kernel(const int32_t* __restrict__ ox,
                     const int32_t* __restrict__ cx, int32_t* __restrict__ pre,
                     int32_t* __restrict__ tot, int T, int N, int C, int W,
                     long long chains, uint64_t step_n, uint64_t step_c,
                     uint64_t step_tn) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= T * chains) return;
  const int t = (int)(g / chains);
  const long long r = g - t * chains;
  const long long jb = r / W;
  const long long base = jb * C * W + (r - jb * W);
  const Fe mx = bsgs::fe_load_packed(cx + t, step_c);
  const Fe one = bsgs::fe_one();
  Fe run = one;
  int32_t* out = pre + (long long)t * N + base;
  const int32_t* in = ox + base;
  // o: the batch being walked; nx: the next one, in flight meanwhile
  Fe o[kFwdBatch], nx[kFwdBatch];
#pragma unroll
  for (int k = 0; k < kFwdBatch; ++k)
    if (k < C) nx[k] = bsgs::fe_load_packed(in + (long long)k * W, step_n);
  for (int c0 = 0; c0 < C; c0 += kFwdBatch) {
#pragma unroll
    for (int k = 0; k < kFwdBatch; ++k) {
      o[k] = nx[k];
      if (c0 + kFwdBatch + k < C)
        nx[k] = bsgs::fe_load_packed(in + (long long)(c0 + kFwdBatch + k) * W,
                                     step_n);
    }
#pragma unroll
    for (int k = 0; k < kFwdBatch; ++k) {
      if (c0 + k >= C) break;
      Fe d = bsgs::sub_mod(o[k], mx);
      d = bsgs::fe_select(bsgs::fe_is_zero(d), one, d);
      bsgs::fe_store_packed(out + (long long)(c0 + k) * W, step_tn, run);
      run = bsgs::mul_mod(run, d);
    }
  }
  bsgs::fe_store(tot, T * chains, g, run);
}

// p[i * step / 4] = row[i] for the 8 rows of a key plane, the address
// walked by adds as in fe_load.
__device__ __forceinline__ void store_rows(int32_t* p, uint64_t step,
                                           const uint32_t (&row)[8]) {
  char* a = (char*)p;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    *(int32_t*)a = (int32_t)row[i];
    a += step;
  }
}

// Replaces bsgs_tpu/ops/epoch_kernel.py:_bwd_kernel. Thread g walks the
// chain of epoch_fwd_kernel's thread g backwards from its inverted total:
// each pair's 1/d, both landing X's (M + O and M - O share it), their
// probe keys and the exact flag.
//
// Bound: the multiplier pipe. A pair needs 4 multiplies, 2 squarings and 7
// adds or subtracts: 778 multiplier-pipe issues and 1,047 integer
// instructions, so a phase of T=4 jobs x N=2^18 offsets takes at least
// 0.049 ms on an H100 (0.033 ms of issue over both pipes, 0.041 ms of
// bytes). With schoolbook rows for every product, squares included, the
// same walk needs 894 issues and 2,159 instructions a pair: each 32-bit
// product is an IMAD and an IADD3.X that carries it. What the design does
// about it: the products are pair products (mul_mod, sqr_mod in field.cuh:
// one IMAD.WIDE.U32.X a 64-bit product, its carry in a predicate), which
// halves the instructions, and a square takes 36 products in place of 64,
// which takes 13% off the multiplier pipe's issues; the loads walk their
// rows by adds, with byte steps from the host, so no address lands on the
// multiplier pipe (fe_load_packed, store_rows). One job a thread: 2 or 4
// jobs a thread, which share the offsets' loads, ran slower on an H100
// (more registers, fewer warps); chip_smoke.py --epoch-bwd times them
// beside this kernel. It reads ox, oy, the centers and pre packed, the
// inverted totals as (16, ·) planes.
__global__ void __launch_bounds__(kBlock)
    epoch_bwd_kernel(const int32_t* __restrict__ ox,
                     const int32_t* __restrict__ oy,
                     const int32_t* __restrict__ cx,
                     const int32_t* __restrict__ cy,
                     const int32_t* __restrict__ pre,
                     const int32_t* __restrict__ itot,
                     int32_t* __restrict__ out, int T, int N, int C, int W,
                     int htsz, uint64_t step_n, uint64_t step_c,
                     uint64_t step_tn) {
  const long long chains = (long long)(N / (C * W)) * W;  // of one job
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= T * chains) return;
  const int t = (int)(g / chains);
  const long long r = g - t * chains;
  const long long jb = r / W;
  const Fe mx = bsgs::fe_load_packed(cx + t, step_c);
  const Fe my = bsgs::fe_load_packed(cy + t, step_c);
  const Fe one = bsgs::fe_one();
  Fe run = bsgs::fe_load(itot + g, 4ull * T * chains);
  long long col = jb * C * W + (r - jb * W) + (long long)(C - 1) * W;
  for (int i = 0; i < C; ++i, col -= W) {
    const long long pc = (long long)t * N + col;
    const Fe oxv = bsgs::fe_load_packed(ox + col, step_n);
    const Fe oyv = bsgs::fe_load_packed(oy + col, step_n);
    Fe d = bsgs::sub_mod(oxv, mx);
    const bool exact = bsgs::fe_is_zero(d);
    d = bsgs::fe_select(exact, one, d);
    const Fe inv = bsgs::mul_mod(run, bsgs::fe_load_packed(pre + pc, step_tn));
    run = bsgs::mul_mod(run, d);
    // x(M + O): lambda = (Oy - My) / (Ox - Mx)
    const Fe lp = bsgs::mul_mod(bsgs::sub_mod(oyv, my), inv);
    const Fe xp = bsgs::sub_mod(bsgs::sub_mod(bsgs::sqr_mod(lp), mx), oxv);
    // x(M - O): only the square of -(Oy + My) / (Ox - Mx) enters
    const Fe lm = bsgs::mul_mod(bsgs::add_mod(oyv, my), inv);
    const Fe xm = bsgs::sub_mod(bsgs::sub_mod(bsgs::sqr_mod(lm), mx), oxv);
    uint32_t bp, dp, bm, dm;
    bsgs::probe_key(xp, htsz, bp, dp);
    bsgs::probe_key(xm, htsz, bm, dm);
    const uint32_t row[8] = {bp, dp, bm, dm, exact ? 1u : 0u, 0u, 0u, 0u};
    store_rows(out + pc, step_tn, row);
  }
}

// Replaces bsgs_tpu/ops/epoch_kernel.py:_fermat_kernel: one thread per
// element, the same function (the canonical inverse, 0 -> 0) by batched
// division steps in place of the 294 dependent multiplies of a^(p-2)
// (modinv.cuh says how). Bound: instructions. Below about 16,900 lanes (one
// warp on each of the card's 528 schedulers) its time is the latency of one
// inversion, above that the instruction rate. Threads past M stay in the
// warp with x = 0 (no batch to run) because the loop's test is a warp vote.
__global__ void __launch_bounds__(kBlock)
    modinv_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                  int M) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = g < M;
  Fe a = bsgs::fe_load(x + (live ? g : 0), 4ull * M);
  if (!live) {
#pragma unroll
    for (int i = 0; i < 8; ++i) a.v[i] = 0;
  }
  const Fe r = bsgs::inv_mod_divsteps(a);
  if (live) bsgs::fe_store(out, M, g, r);
}

// Replaces bsgs_tpu/ops/epoch_kernel.py:_addc_kernel: one thread per lane,
// (x, y) + C given inv = 1/den (den = Cx - x, or 2y on the doubling lanes
// x == Cx), and the 64-bit prefix of x3 as (hi, lo) rows.
//
// Bound: bytes. A lane reads x, y and inv and writes x3 and y3, 160 B at
// 32 B an element, and its 8-B prefix, against two multiplies and two
// squarings (482 multiplier issues): at m=2^18 the floor is 44 MB, 0.0131
// ms at 3.35 TB/s, against 0.0076 ms of the multiplier pipe; at the w=2^30
// tile (m=2^20) 0.0526 ms. What the design does about it: every plane is
// packed (field.cuh), the step column too, so a lane moves 168 B where the
// (16, M) planes moved 328; every load is issued before the arithmetic
// that needs it (inv's before the squaring of x), so a warp has all its
// bytes in flight at once.
__global__ void __launch_bounds__(kBlock)
    add_const_kernel(const int32_t* __restrict__ xs,
                     const int32_t* __restrict__ ys,
                     const int32_t* __restrict__ inv,
                     const int32_t* __restrict__ cx,
                     const int32_t* __restrict__ cy, int32_t* __restrict__ x3,
                     int32_t* __restrict__ y3, int32_t* __restrict__ prefix,
                     int M) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= M) return;
  const uint64_t step = 4ull * M;
  const Fe x = bsgs::fe_load_packed(xs + g, step);
  const Fe y = bsgs::fe_load_packed(ys + g, step);
  const Fe iv = bsgs::fe_load_packed(inv + g, step);
  const Fe cxv = bsgs::fe_load_packed(cx, 4);
  const Fe cyv = bsgs::fe_load_packed(cy, 4);
  const bool dbl = bsgs::fe_is_zero(bsgs::sub_mod(cxv, x));
  const Fe x2 = bsgs::sqr_mod(x);
  const Fe num = dbl ? bsgs::add_mod(bsgs::add_mod(x2, x2), x2)
                     : bsgs::sub_mod(cyv, y);
  const Fe lam = bsgs::mul_mod(num, iv);
  // on doubling lanes cx == x, so x + cx == 2x either way
  const Fe xr = bsgs::sub_mod(bsgs::sqr_mod(lam), bsgs::add_mod(x, cxv));
  const Fe yr = bsgs::sub_mod(bsgs::mul_mod(lam, bsgs::sub_mod(x, xr)), y);
  bsgs::fe_store_packed(x3 + g, step, xr);
  bsgs::fe_store_packed(y3 + g, step, yr);
  prefix[g] = (int32_t)xr.v[1];
  prefix[(long long)M + g] = (int32_t)xr.v[0];
}

// The Montgomery passes (mont.cuh), launched for the segment length L.
template <bool kPoints>
void mont_fwd_launch(int L, const int32_t* v, const int32_t* ys,
                     const int32_t* cx, int32_t* pre, int32_t* tot,
                     long long M, long long T, int W, dim3 grid, dim3 block,
                     cudaStream_t st) {
  switch (L) {
    case 1:
      bsgs::mont_fwd_kernel<1, kPoints>
          <<<grid, block, 0, st>>>(v, ys, cx, pre, tot, M, T, W);
      break;
    case 2:
      bsgs::mont_fwd_kernel<2, kPoints>
          <<<grid, block, 0, st>>>(v, ys, cx, pre, tot, M, T, W);
      break;
    default:
      bsgs::mont_fwd_kernel<4, kPoints>
          <<<grid, block, 0, st>>>(v, ys, cx, pre, tot, M, T, W);
  }
}

template <bool kPoints>
void mont_bwd_launch(int L, const int32_t* v, const int32_t* ys,
                     const int32_t* cx, const int32_t* pre,
                     const int32_t* itot, int32_t* out, long long M,
                     long long T, int W, dim3 grid, dim3 block,
                     cudaStream_t st) {
  switch (L) {
    case 1:
      bsgs::mont_bwd_kernel<1, kPoints>
          <<<grid, block, 0, st>>>(v, ys, cx, pre, itot, out, M, T, W);
      break;
    case 2:
      bsgs::mont_bwd_kernel<2, kPoints>
          <<<grid, block, 0, st>>>(v, ys, cx, pre, itot, out, M, T, W);
      break;
    default:
      bsgs::mont_bwd_kernel<4, kPoints>
          <<<grid, block, 0, st>>>(v, ys, cx, pre, itot, out, M, T, W);
  }
}

// Grid and block of a pass over M columns in chains of C spaced W apart, S
// segments a chain, and T, the totals' width (blocks * W); false for a
// layout the kernels do not take: W a multiple of 32, S <= 16 and
// C = S * L with L in {1, 2, 4}. M may be any width: the last block of
// chains is padded with ones.
bool mont_shape(int M, int C, int W, int S, dim3& grid, dim3& block,
                long long& T) {
  if (M <= 0 || W <= 0 || W % bsgs::kMontLanes || S < 1 ||
      S > bsgs::kMontMaxSegments || C % S)
    return false;
  const int L = C / S;
  if (L != 1 && L != 2 && L != 4) return false;
  const long long span = (long long)C * W;
  const long long blocks = (M + span - 1) / span;
  T = blocks * W;
  grid = dim3((unsigned)(blocks * (W / bsgs::kMontLanes)));
  block = dim3(bsgs::kMontLanes, S);
  return true;
}

}  // namespace

extern "C" {

// The planes of the epoch entries are packed but for tot and itot; ldc is
// the centers' row stride.
int bsgs_epoch_fwd(const void* ox, const void* cx, void* pre, void* tot,
                   int T, int N, int C, int W, int ldc, void* stream) {
  const long long chains = (long long)(N / (C * W)) * W;
  epoch_fwd_kernel<<<grid_for(T * chains), kBlock, 0,
                     (cudaStream_t)stream>>>(
      (const int32_t*)ox, (const int32_t*)cx, (int32_t*)pre, (int32_t*)tot,
      T, N, C, W, chains, 4ull * N, 4ull * ldc, 4ull * T * N);
  return (int)cudaGetLastError();
}

int bsgs_epoch_bwd(const void* ox, const void* oy, const void* cx,
                   const void* cy, const void* pre, const void* itot,
                   void* out, int T, int N, int C, int W, int htsz, int ldc,
                   void* stream) {
  const long long threads = (long long)T * (N / (C * W)) * W;
  epoch_bwd_kernel<<<grid_for(threads), kBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ox, (const int32_t*)oy, (const int32_t*)cx,
      (const int32_t*)cy, (const int32_t*)pre, (const int32_t*)itot,
      (int32_t*)out, T, N, C, W, htsz, 4ull * N, 4ull * ldc, 4ull * T * N);
  return (int)cudaGetLastError();
}

// v is the plane; or, with ys != nullptr (the points entry), v is the
// tile's packed xs, cx the step's packed x column, pre and out packed.
int bsgs_mont_fwd(const void* v, const void* ys, const void* cx, void* pre,
                  void* tot, int M, int C, int W, int S, void* stream) {
  dim3 grid, block;
  long long T;
  if (!mont_shape(M, C, W, S, grid, block, T))
    return (int)cudaErrorInvalidValue;
  if (ys)
    mont_fwd_launch<true>(C / S, (const int32_t*)v, (const int32_t*)ys,
                          (const int32_t*)cx, (int32_t*)pre, (int32_t*)tot,
                          M, T, W, grid, block, (cudaStream_t)stream);
  else
    mont_fwd_launch<false>(C / S, (const int32_t*)v, nullptr, nullptr,
                           (int32_t*)pre, (int32_t*)tot, M, T, W, grid,
                           block, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int bsgs_mont_bwd(const void* v, const void* ys, const void* cx,
                  const void* pre, const void* itot, void* out, int M, int C,
                  int W, int S, void* stream) {
  dim3 grid, block;
  long long T;
  if (!mont_shape(M, C, W, S, grid, block, T))
    return (int)cudaErrorInvalidValue;
  if (ys)
    mont_bwd_launch<true>(C / S, (const int32_t*)v, (const int32_t*)ys,
                          (const int32_t*)cx, (const int32_t*)pre,
                          (const int32_t*)itot, (int32_t*)out, M, T, W, grid,
                          block, (cudaStream_t)stream);
  else
    mont_bwd_launch<false>(C / S, (const int32_t*)v, nullptr, nullptr,
                           (const int32_t*)pre, (const int32_t*)itot,
                           (int32_t*)out, M, T, W, grid, block,
                           (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int bsgs_modinv(const void* x, void* out, int M, void* stream) {
  modinv_kernel<<<grid_for(M), kBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, M);
  return (int)cudaGetLastError();
}

// Every plane packed; prefix (2, M).
int bsgs_add_const(const void* xs, const void* ys, const void* inv,
                   const void* cx, const void* cy, void* x3, void* y3,
                   void* prefix, int M, void* stream) {
  add_const_kernel<<<grid_for(M), kBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)xs, (const int32_t*)ys, (const int32_t*)inv,
      (const int32_t*)cx, (const int32_t*)cy, (int32_t*)x3, (int32_t*)y3,
      (int32_t*)prefix, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
