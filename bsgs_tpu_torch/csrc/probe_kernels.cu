// The dense-table probe for Hopper (sm_90a), reading only a row's occupied
// slots.
//
// Hand-written counterpart of bsgs_tpu/ops/probe_kernel.py:_probe_dma_kernel.
// For m probes against the (2^htsz, window) u32 bucket matrix and its row
// lengths (the entries each row holds, from slot 0 on: row_len, one byte or
// two a row) it computes, with b = bucket[i], d = disc[i], n = row_len[b]:
//   found[i] = any(dense[b, :n] == d) | (d == FILL & n < window)
// On a table whose rows hold FILL past their length, which every build of
// the package makes, that is bit for bit the JAX package's
// any(dense[b, :] == d). The Python wrapper (bsgs_tpu_torch/ops/
// probe_kernel.py) checks types, shapes and alignment, allocates the output
// and launches on PyTorch's current stream. The C entry returns
// cudaGetLastError() so a refused launch raises there.
//
// What bounds it: bytes. A probe reads its key (8 bytes), its row's length
// (1 byte, 2 above 255 slots a row, from a plane that stays in the 50 MB
// L2) and its row's occupied 32-byte sectors, and writes one byte. Rows
// hold half their window on average (a mean load of window / 2), so
// reading only the occupied sectors halves the bytes of the whole-row read.
//
// Design.
// - A group of 8 lanes answers a probe, 4 probes to a warp. Each lane reads
//   16 bytes (a uint4, four slots), so a group takes 128 bytes of its row a
//   step; a lane issues the loads of 4 steps together (a 128-slot row in one
//   go) before any compare. Loads past the row's length are not issued, so
//   a warp's requests touch only occupied sectors; the slots of the last
//   uint4 past the length are masked out of the compare, so the kernel
//   computes the function above on any table.
// - The length is a load that depends on the bucket, and the row's loads
//   depend on the length: three dependent loads a probe. Covering 3.35
//   TB/s times about a microsecond of latency needs a few MB in flight,
//   which one probe a warp (about 280 bytes) at 64 warps an SM barely
//   reaches. With 4 probes a warp and 31 registers a thread, 64 warps an SM
//   keep up to about 9 MB of rows in flight. Groups of 16 or 32 lanes, and
//   a group walking 4 probes a grid apart with the next key and length
//   loaded ahead, were slower (chip_smoke.py --probe times them).
// - A disc of 0xFFFFFFFF is answered from n < window before any row is
//   read; on a full row its slots are still compared.
// - The group's lanes vote with one __ballot_sync over the warp and the
//   group's first lane writes the byte.
//
// Rejected: stopping at the first FILL slot, since a real entry's disc can
// be 0xFFFFFFFF (2^-32 an entry, about 0.25 entries of a w = 2^30 table),
// so the end of a row must come from the counts; a binary search over a
// row sorted by disc, the reference's FOUNDINSORTNEW (bsgs_tpu/ops/
// probe_kernel.py:11-13), since streamed rows are in baby order, not disc
// order, and the search is about 6 dependent loads; TMA or cp.async.bulk
// copies, since a gather of ~270-byte rows with no reuse gains nothing
// from staging them in shared memory. The Pallas kernel's structure
// (scalar-prefetched buckets, row copies double-buffered through VMEM,
// transposed disc and output tiles, whole groups of probes) answered the
// TPU's compiler and is not carried over: any m works.
//
// Buckets are trusted to be in range, row lengths to be at most the window.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr uint32_t kFill = 0xFFFFFFFFu;

constexpr int kLanes = 8;                // lanes a probe
constexpr int kUnroll = 32 / kLanes;     // steps a lane issues at once

template <typename L>
__global__ void __launch_bounds__(kBlock)
    probe_rows_kernel(const uint32_t* __restrict__ bucket,
                      const uint32_t* __restrict__ disc,
                      const uint4* __restrict__ dense,
                      const L* __restrict__ row_len,
                      uint8_t* __restrict__ found, int m, int vecs,
                      int window) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kLanes - 1);
  const unsigned group_mask = 0xFFu << (lane & ~(kLanes - 1));
  const long long p = ((long long)blockIdx.x * kBlock + threadIdx.x) / kLanes;

  bool hit = false;
  if (p < m) {
    const uint32_t b = __ldg(bucket + p);
    const uint32_t d = __ldg(disc + p);
    const int n = (int)__ldg(row_len + b);
    hit = d == kFill && n < window;
    const int nv = hit ? 0 : (n + 3) >> 2;  // uint4s holding entries
    const uint4* row = dense + (long long)b * vecs;
    for (int v0 = sub; v0 < nv; v0 += kLanes * kUnroll) {
      uint4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (v0 + u * kLanes < nv) q[u] = __ldg(row + v0 + u * kLanes);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * kLanes;
        if (v < nv) {
          const int rem = n - 4 * v;  // entries in this uint4, >= 1
          hit |= (q[u].x == d) | ((q[u].y == d) & (rem > 1)) |
                 ((q[u].z == d) & (rem > 2)) | ((q[u].w == d) & (rem > 3));
        }
      }
    }
  }
  const unsigned votes = __ballot_sync(0xFFFFFFFFu, hit);
  if (sub == 0 && p < m) found[p] = (votes & group_mask) ? 1 : 0;
}

template <typename L>
void launch(const void* bucket, const void* disc, const void* dense,
            const void* row_len, void* found, int m, int vecs,
            cudaStream_t stream) {
  constexpr int per_block = kBlock / kLanes;
  const unsigned grid = (unsigned)(((long long)m + per_block - 1) / per_block);
  probe_rows_kernel<L><<<grid, kBlock, 0, stream>>>(
      (const uint32_t*)bucket, (const uint32_t*)disc, (const uint4*)dense,
      (const L*)row_len, (uint8_t*)found, m, vecs, 4 * vecs);
}

}  // namespace

// bucket, disc: (m,) u32; dense: (rows, 4 * vecs) u32, rows 16-byte
// aligned; row_len: (rows,) lengths of len_bytes bytes each (1: uint8,
// 2: int16), each at most 4 * vecs; found: (m,) bytes, 0 or 1.
extern "C" int bsgs_probe_rows(const void* bucket, const void* disc,
                               const void* dense, const void* row_len,
                               void* found, int m, int vecs, int len_bytes,
                               void* stream) {
  if (m <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (len_bytes == 1)
    launch<uint8_t>(bucket, disc, dense, row_len, found, m, vecs, s);
  else if (len_bytes == 2)
    launch<int16_t>(bucket, disc, dense, row_len, found, m, vecs, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
