// Native host-side baby-table packing: radix sort of 64-bit X prefixes and
// CSR bucket construction.
//
// Role-equivalent of the reference's host table pipeline — the chained hash
// table + per-bucket insertion sorts + CSR pack written in PureBasic/x86 asm
// (1_9_7File.pb:2555-3444) — redesigned as a single LSD radix sort: sorting
// the 64-bit prefix both groups buckets (top htsz bits) contiguously and
// orders entries within each bucket, so the CSR arrays fall out of one pass.
//
// A copy of the JAX package's csrc/host_pack.cpp. Exposed via ctypes
// (bsgs_tpu_torch/utils/native.py), which builds it with g++ at first use;
// the numpy versions there are what the tests hold it against.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// One stable LSD pass over chunked data, multi-threaded: per-thread
// histograms, a stable global prefix layout (digit-major, thread-minor),
// then per-thread scatters into disjoint destination cursors. The
// reference multi-threads its per-bucket sorts the same way — threads
// over disjoint ranges with a rest-job tail (sortWholeHashTableThreaded,
// 1_9_7File.pb:2843-2895).
void radix_pass_mt(const uint64_t* src_k, const uint32_t* src_v,
                   uint64_t* dst_k, uint32_t* dst_v, int64_t n, int shift,
                   int nthreads) {
  const int64_t chunk = (n + nthreads - 1) / nthreads;
  std::vector<std::vector<size_t>> hist(
      static_cast<size_t>(nthreads), std::vector<size_t>(256, 0));
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; ++t) {
      ts.emplace_back([&, t] {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min<int64_t>(n, lo + chunk);
        auto& h = hist[static_cast<size_t>(t)];
        for (int64_t i = lo; i < hi; ++i)
          ++h[(src_k[i] >> shift) & 0xFF];
      });
    }
    for (auto& th : ts) th.join();
  }
  // exclusive prefix: digit-major, thread-minor keeps the pass stable
  size_t sum = 0;
  for (int b = 0; b < 256; ++b) {
    for (int t = 0; t < nthreads; ++t) {
      const size_t c = hist[static_cast<size_t>(t)][b];
      hist[static_cast<size_t>(t)][b] = sum;
      sum += c;
    }
  }
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; ++t) {
      ts.emplace_back([&, t] {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min<int64_t>(n, lo + chunk);
        auto& cur = hist[static_cast<size_t>(t)];
        for (int64_t i = lo; i < hi; ++i) {
          const size_t d = cur[(src_k[i] >> shift) & 0xFF]++;
          dst_k[d] = src_k[i];
          dst_v[d] = src_v[i];
        }
      });
    }
    for (auto& th : ts) th.join();
  }
}

}  // namespace

extern "C" {

// Sorts pre[n] ascending, applying the same permutation to pos[n].
// pos should be initialized by the caller (typically 1..n baby indices).
// Returns 0 on success.
int bsgs_sort_prefixes(uint64_t* pre, uint32_t* pos, int64_t n) {
  if (n <= 1) return 0;
  std::vector<uint64_t> pre_tmp(static_cast<size_t>(n));
  std::vector<uint32_t> pos_tmp(static_cast<size_t>(n));
  uint64_t* src_k = pre;
  uint32_t* src_v = pos;
  uint64_t* dst_k = pre_tmp.data();
  uint32_t* dst_v = pos_tmp.data();

  int nthreads = static_cast<int>(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 16) nthreads = 16;
  if (n < (int64_t(1) << 20)) nthreads = 1;  // thread spawn not worth it

  // LSD radix, 8 passes of 8 bits.
  for (int pass = 0; pass < 8; ++pass) {
    const int shift = pass * 8;
    if (nthreads > 1) {
      radix_pass_mt(src_k, src_v, dst_k, dst_v, n, shift, nthreads);
    } else {
      size_t count[256] = {0};
      for (int64_t i = 0; i < n; ++i)
        ++count[(src_k[i] >> shift) & 0xFF];
      size_t sum = 0;
      for (int b = 0; b < 256; ++b) {
        size_t c = count[b];
        count[b] = sum;
        sum += c;
      }
      for (int64_t i = 0; i < n; ++i) {
        const size_t d = count[(src_k[i] >> shift) & 0xFF]++;
        dst_k[d] = src_k[i];
        dst_v[d] = src_v[i];
      }
    }
    std::swap(src_k, dst_k);
    std::swap(src_v, dst_v);
  }
  // 8 passes (even) => result is back in the caller's buffers.
  if (src_k != pre) {  // defensive; cannot happen with 8 passes
    std::memcpy(pre, src_k, sizeof(uint64_t) * static_cast<size_t>(n));
    std::memcpy(pos, src_v, sizeof(uint32_t) * static_cast<size_t>(n));
  }
  return 0;
}

// From sorted prefixes, fill CSR bucket offsets (size 2^htsz + 1) and
// 32-bit discriminants (size n). Returns the max bucket size (for the
// probe-window invariant) or -1 on bad arguments.
int64_t bsgs_csr_pack(const uint64_t* sorted_pre, int64_t n, int htsz,
                      uint32_t* offsets, uint32_t* disc) {
  if (htsz < 1 || htsz > 31) return -1;
  const int64_t nb = int64_t(1) << htsz;
  std::memset(offsets, 0, sizeof(uint32_t) * static_cast<size_t>(nb + 1));
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t b = sorted_pre[i] >> (64 - htsz);
    ++offsets[b + 1];
    disc[i] = static_cast<uint32_t>((sorted_pre[i] << htsz) >> 32);
  }
  int64_t maxb = 0;
  uint32_t sum = 0;
  for (int64_t b = 1; b <= nb; ++b) {
    if (offsets[b] > maxb) maxb = offsets[b];
    sum += offsets[b];
    offsets[b] = sum;
  }
  return maxb;
}

}  // extern "C"
