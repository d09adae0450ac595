// LZ77 match walk for Hopper (sm_90a): the encoder's sequential parse in
// match space.
//
// Replaces the Pallas kernel jdeflate_tpu/ops/lz77.py::_walk_body (built by
// _make_walk_kernel, reached by token_marks_batch). Contract:
// ops/lz77.py::match_walk_ref in this package.
//
// For block b: p = cnext[0]; while p < block_len: len = lenp[p]; emit
// p | len << 17; p = cnext[p + len]. cnext[q] is the next accepted match
// candidate at or after q (bl when none), so literal runs cost nothing and
// the loop runs once per emitted match. plist[b, 0] = count + 1, slots
// 1..count hold the matches in walk order; the caller zeroes the rest.
//
// What bounds it: latency, not bytes. Each step is two dependent loads
// (lenp[p], then cnext[p + len]), so a block costs about 2 x (emitted
// matches) L2 round trips. The design keeps it simple: one block of one
// thread per DEFLATE block, reads through the read-only cache (__ldg), and
// a batch's cnext/len (about 8.8 MB at 16 x 64 KiB) stay in the 50 MB L2
// after the host-side code wrote them. Only B of 132 SMs are busy; splitting
// a block's walk at known resync points is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(1)
match_walk_kernel(const int* __restrict__ cnext, const int* __restrict__ lenp,
                  const int* __restrict__ block_len, int* __restrict__ plist,
                  int n, int cap) {
  const int b = blockIdx.x;
  const int* cn = cnext + (int64_t)b * n;
  const int* ln = lenp + (int64_t)b * n;
  int* out = plist + (int64_t)b * cap;
  const int blen = min(block_len[b], n - 1);
  int p = __ldg(cn);
  int k = 1;
  // well-formed inputs stop at p >= blen within cap steps; the other two
  // conditions only keep malformed ones from reading out of bounds or
  // looping forever
  while (p >= 0 && p < blen && k <= cap) {
    const int len = __ldg(ln + p);
    if (k < cap) out[k] = p | (len << 17);
    ++k;
    p = __ldg(cn + min(p + len, n - 1));
  }
  out[0] = k;  // count + 1
}

}  // namespace

extern "C" int jd_match_walk(const void* cnext, const void* lenp,
                             const void* block_len, void* plist, int nblocks,
                             int n, int cap, void* stream) {
  if (nblocks <= 0) return 0;
  match_walk_kernel<<<nblocks, 1, 0, (cudaStream_t)stream>>>(
      (const int*)cnext, (const int*)lenp, (const int*)block_len,
      (int*)plist, n, cap);
  return (int)cudaGetLastError();
}
