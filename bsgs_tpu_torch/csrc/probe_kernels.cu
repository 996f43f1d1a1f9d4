// The dense-table probe for Hopper (sm_90a).
//
// Hand-written counterpart of bsgs_tpu/ops/probe_kernel.py:_probe_dma_kernel:
//   found[i] = any(dense[bucket[i], :] == disc[i])
// for m probes against the (2^htsz, window) u32 bucket matrix. The Python
// wrapper (bsgs_tpu_torch/ops/probe_kernel.py) checks types, shapes and
// alignment, allocates the output and launches on PyTorch's current stream.
// The C entry returns cudaGetLastError() so a refused launch raises there.
//
// What bounds it: bytes. A probe reads one row (4 * window bytes, at an
// address that depends on the data) plus its 8-byte key and writes one
// byte; the window compares per probe are nothing beside that. Nothing is
// materialised: the rows go from memory to registers and are compared
// there, where a gather would write them out and two more passes read
// them back.
//
// Design: one warp per probe. Each lane reads 16 bytes (one uint4, four
// slots), so 32 lanes take a 128-slot row in one coalesced 512-byte
// request; wider rows loop, narrower rows leave the upper lanes idle. The
// lanes' verdicts meet in one __any_sync and lane 0 writes the bool. The
// Pallas kernel's structure (scalar-prefetched buckets, groups of row
// copies double-buffered through VMEM, transposed disc and output tiles,
// stream lengths in whole groups) answered the TPU's compiler and is not
// carried over: any m works, and the many warps in flight per SM hide
// the row latency that the TPU kernel hid with its copy ring.
//
// An empty slot holds 0xFFFFFFFF and a probe whose disc equals that
// matches it, as in the JAX package; buckets are trusted to be in range.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / 32;

__global__ void __launch_bounds__(kBlock)
    probe_rows_kernel(const uint32_t* __restrict__ bucket,
                      const uint32_t* __restrict__ disc,
                      const uint4* __restrict__ dense,
                      uint8_t* __restrict__ found, int m, int vecs) {
  const long long probe =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (probe >= m) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const uint32_t d = __ldg(disc + probe);
  const uint4* row = dense + (long long)__ldg(bucket + probe) * vecs;
  bool hit = false;
  for (int v = lane; v < vecs; v += 32) {
    const uint4 q = __ldg(row + v);
    hit |= (q.x == d) | (q.y == d) | (q.z == d) | (q.w == d);
  }
  hit = __any_sync(0xFFFFFFFFu, hit);
  if (lane == 0) found[probe] = hit ? 1 : 0;
}

}  // namespace

// bucket, disc: (m,) u32; dense: (rows, 4 * vecs) u32, rows 16-byte
// aligned; found: (m,) bytes, 0 or 1.
extern "C" int bsgs_probe_rows(const void* bucket, const void* disc,
                               const void* dense, void* found, int m,
                               int vecs, void* stream) {
  if (m <= 0) return 0;
  const unsigned grid =
      (unsigned)(((long long)m + kWarpsPerBlock - 1) / kWarpsPerBlock);
  probe_rows_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bucket, (const uint32_t*)disc, (const uint4*)dense,
      (uint8_t*)found, m, vecs);
  return (int)cudaGetLastError();
}
