// LZ77 exact extension, stage 1, for Hopper (sm_90a): one bounded byte
// compare per selected position, one thread per position.
//
// Replaces no TPU kernel: the JAX package's match finder
// (jdeflate_tpu/ops/lz77.py find_matches_batch) is XLA. Added because the
// port's plain version of this stage (ops/lz77.py::extend_top_ref: for
// each of the T top distances d, about fifteen full-width int64 operations
// over the batch's (B, row) rows, among them a reversed torch.cummin whose
// innermost-dimension scan puts a batch's 16 rows in one thread block) took
// about 0.45 ms a pass, T = 8 passes a batch at levels 1-7 and 16 at 8-9.
// Contract: extend_top_ref.
//
// The plain loop replaces plen at position j of row b, for the one pass
// whose distance d is pdist[b, j], when plen[b, j] > 0, by the run length
// of ext[b, k] == ext[b, k - d] from k = j (the first k >= j where it
// fails, or the row's end, minus j; 0 when j < d), capped at 258. The
// distances in topd are distinct, so at most one pass selects a position
// and the passes commute: a single pass over the positions, each testing
// its own distance against topd, returns the loop's result bit for bit.
// d = 0 (a zero-count distance in topd) compares each byte with itself and
// runs to the cap or the row's end, as in the loop.
//
// A run is compared 4 bytes at a time: a word at any byte offset comes
// from two aligned loads and a funnel shift, and the first differing byte
// is the lowest set byte of the XOR (__ffs). Words are compared while both
// aligned loads of the position's word stay inside the row (the
// candidate's lie d bytes before them); the last bytes before the row's end
// go one at a time, so nothing past the row is read.
//
// What bounds it: the bytes it must move are plen and pdist in and the
// result out (24 B a position) and the rows: about 39 MB for a batch of 16
// blocks of 64 KiB with their 32 KiB halo, 12 us at 3.35 TB/s. The runs
// read rows (1.6 MB a batch) that stay in L1 and L2; adjacent threads
// mostly share a distance and their runs end near one another, so a warp's
// loads coalesce and its threads stop together. The worst case, every
// position of zero bytes running 258 bytes at d = 1, reads about 0.4 GB
// through L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTop = 64;
constexpr int kMaxMatch = 258;

__device__ __forceinline__ const uint32_t* word_base(const uint8_t* q,
                                                     unsigned* shift) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(q);
  *shift = (unsigned)(a & 3) * 8;
  return reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
}

__global__ void __launch_bounds__(kThreads)
extend_kernel(const uint8_t* __restrict__ ext,
              const long long* __restrict__ plen,
              const long long* __restrict__ pdist,
              const long long* __restrict__ topd,
              long long* __restrict__ out, int row, int nh, int ntop) {
  __shared__ long long top[kMaxTop];
  for (int i = threadIdx.x; i < ntop; i += kThreads) top[i] = __ldg(topd + i);
  __syncthreads();
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (j >= nh) return;
  const int64_t at = (int64_t)b * nh + j;
  const long long l = __ldg(plen + at);
  const long long d = __ldg(pdist + at);
  bool sel = false;
  if (l > 0)
    for (int i = 0; i < ntop; ++i) sel |= top[i] == d;
  if (!sel) {
    out[at] = l;
    return;
  }
  if (d > j) {                         // the loop's col_row >= d fails at j
    out[at] = 0;
    return;
  }
  const uint8_t* p = ext + (int64_t)b * row + j;
  const uint8_t* q = p - d;
  const int lim = min(kMaxMatch, row - j);
  const int wlim = min(lim, row - j - 4);
  int off = 0;
  if (wlim >= 4) {
    unsigned sp, sq;
    const uint32_t* wp = word_base(p, &sp);
    const uint32_t* wq = word_base(q, &sq);
    uint32_t lp = __ldg(wp), lq = __ldg(wq);
    for (; off + 4 <= wlim; off += 4) {
      const uint32_t hp = __ldg(++wp), hq = __ldg(++wq);
      const uint32_t x = __funnelshift_r(lp, hp, sp) ^
                         __funnelshift_r(lq, hq, sq);
      if (x) {
        out[at] = off + ((__ffs(x) - 1) >> 3);
        return;
      }
      lp = hp;
      lq = hq;
    }
  }
  while (off < lim && __ldg(p + off) == __ldg(q + off)) ++off;
  out[at] = off;
}

}  // namespace

// ext: (nblocks, row) u8; plen, pdist, out: (nblocks, nh) int64, nh <= row;
// topd: (ntop,) int64 distinct distances, ntop <= 64. out is written at
// every position.
extern "C" int jd_match_extend(const void* ext, const void* plen,
                               const void* pdist, const void* topd,
                               void* out, int nblocks, int row, int nh,
                               int ntop, void* stream) {
  if (nblocks <= 0 || nh <= 0) return 0;
  if (nblocks > 65535 || nh > row || ntop < 0 || ntop > kMaxTop)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nh + kThreads - 1) / kThreads),
                  (unsigned)nblocks);
  extend_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)ext, (const long long*)plen, (const long long*)pdist,
      (const long long*)topd, (long long*)out, row, nh, ntop);
  return (int)cudaGetLastError();
}
