// LZ77 bucket probe for Hopper (sm_90a): the match finder's hash-chain
// walk, one thread per sorted position.
//
// Replaces no TPU kernel: the JAX package's match finder
// (jdeflate_tpu/ops/lz77.py find_matches_batch) is XLA. Added because the
// port's plain version of this loop (ops/lz77.py::match_probe_ref: k
// probes, each about ten full-width int64 operations per prefix word) was
// about 5,500 launches per 1 MiB batch at level 6 and 99,000 at level 9,
// nearly all of the encoder's device time. Contract: match_probe_ref.
//
// Within row b, skey[b, j] = hash << 17 | pos is sorted ascending, so the
// same-hash predecessors of sorted index j are j-1, j-2, ... with strictly
// falling positions. The plain loop tests the k of them at kk = 1..k under
// conditions that are each monotone in kk (j - kk >= 0, same hash, dist <=
// window, candidate pos >= valid_from): once one fails it fails for every
// larger kk. A candidate replaces the best only when its prefix length is
// strictly larger (the earlier probe wins a tie), so nothing replaces a
// best at the cap 4 * PW. The walk stops at the first of these events and
// returns the plain loop's (length, dist) bit for bit, visiting only the
// live candidates.
//
// A prefix length is the number of equal leading bytes of ext[b, p:] and
// ext[b, c:], capped at 4 * PW: the plain loop's count of equal 4-byte
// words plus the equal low-order bytes of the first unequal word. A
// candidate whose byte at offset `best` differs from the position's cannot
// be longer than the best, so one byte load rejects it; the others are
// compared a word at a time, the position's own PW words held in registers.
// Words at any byte offset come from two aligned loads and a funnel shift:
// a word load may touch up to 3 bytes before a row's first byte and 4
// after the last compared one, all inside the (B, row) buffer, which the
// wrapper checks is at least 4 * PW + 4 bytes longer than nh.
//
// What bounds it: the bytes it must move are the rows (B * row), the
// sorted keys (8 B a position) and the two int64 outputs: about 40 MB for
// a batch of 16 blocks of 64 KiB with their 32 KiB halo, 12 us at
// 3.35 TB/s. The rest is compare work on rows (1.6 MB a batch) and keys
// that stay in L1 and L2: adjacent threads walk adjacent keys, mostly of
// one bucket, so a warp's key loads coalesce and its walks end near one
// another.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ const uint32_t* word_base(const uint8_t* q,
                                                     unsigned* shift) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(q);
  *shift = (unsigned)(a & 3) * 8;
  return reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
}

template <int PW>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint8_t* __restrict__ ext,
             const long long* __restrict__ skey,
             const long long* __restrict__ valid_from,
             long long* __restrict__ plen, long long* __restrict__ pdist,
             int row, int nh, int k, int window) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (j >= nh) return;
  const long long* keys = skey + (int64_t)b * nh;
  const uint8_t* r = ext + (int64_t)b * row;
  const long long key = __ldg(keys + j);
  const int p = (int)(key & 0x1FFFF);
  if (p >= nh) return;                 // not a key of this row
  const long long h = key >> 17;
  const long long vf = __ldg(valid_from + b);

  uint32_t own[PW];
  {
    unsigned s;
    const uint32_t* w = word_base(r + p, &s);
    uint32_t lo = __ldg(w);
#pragma unroll
    for (int t = 0; t < PW; ++t) {
      const uint32_t hi = __ldg(w + t + 1);
      own[t] = __funnelshift_r(lo, hi, s);
      lo = hi;
    }
  }

  int best = 0, bdist = 0;
  uint8_t want = __ldg(r + p);         // the position's byte at `best`
  const int stop = max(j - k, 0);
  for (int i = j - 1; i >= stop; --i) {
    const long long c = __ldg(keys + i);
    const int cp = (int)(c & 0x1FFFF);
    const int dist = p - cp;
    if ((c >> 17) != h || dist <= 0 || dist > window || cp < vf) break;
    if (__ldg(r + cp + best) != want) continue;
    unsigned s;
    const uint32_t* w = word_base(r + cp, &s);
    uint32_t lo = __ldg(w);
    int len = 4 * PW;
#pragma unroll
    for (int t = 0; t < PW; ++t) {
      const uint32_t hi = __ldg(w + t + 1);
      const uint32_t x = __funnelshift_r(lo, hi, s) ^ own[t];
      if (x) {
        len = 4 * t + ((__ffs(x) - 1) >> 3);
        break;
      }
      lo = hi;
    }
    if (len > best) {
      best = len;
      bdist = dist;
      if (best == 4 * PW) break;
      want = __ldg(r + p + best);
    }
  }
  plen[(int64_t)b * nh + p] = best;
  pdist[(int64_t)b * nh + p] = bdist;
}

}  // namespace

// ext: (nblocks, row) u8; skey: (nblocks, nh) int64, each row sorted and
// its positions (key & 0x1FFFF) a permutation of [0, nh); valid_from:
// (nblocks,) int64; plen, pdist: (nblocks, nh) int64, written at every
// position. pw is 8 or 16.
extern "C" int jd_match_probe(const void* ext, const void* skey,
                              const void* valid_from, void* plen,
                              void* pdist, int nblocks, int row, int nh,
                              int k, int pw, int window, void* stream) {
  if (nblocks <= 0 || nh <= 0) return 0;
  if (nblocks > 65535 || nh > (1 << 17) || row < nh + 4 * pw + 4 || k < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nh + kThreads - 1) / kThreads),
                  (unsigned)nblocks);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* e = (const uint8_t*)ext;
  const long long* sk = (const long long*)skey;
  const long long* vf = (const long long*)valid_from;
  long long* pl = (long long*)plen;
  long long* pd = (long long*)pdist;
  if (pw == 8)
    probe_kernel<8><<<grid, kThreads, 0, s>>>(e, sk, vf, pl, pd, row, nh, k,
                                              window);
  else if (pw == 16)
    probe_kernel<16><<<grid, kThreads, 0, s>>>(e, sk, vf, pl, pd, row, nh, k,
                                               window);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
