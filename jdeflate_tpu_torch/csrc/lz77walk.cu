// LZ77 match walk for Hopper (sm_90a): the encoder's sequential parse in
// match space.
//
// Replaces the Pallas kernel jdeflate_tpu/ops/lz77.py::_walk_body (built by
// _make_walk_kernel, reached by token_marks_batch). Contract:
// ops/lz77.py::match_walk_ref in this package.
//
// For block b the parse is the orbit p_0 = cnext[0], p_{m+1} = J(p_m) with
// J(q) = cnext[q + lenp[q]]: cnext[q] is the next accepted match candidate
// at or after q (bl when none), so literal runs cost nothing and the orbit
// visits exactly the emitted matches. plist[b, 0] = count + 1, slots
// 1..count hold p | len << 17 in walk order, the rest are zeros.
//
// What bounds it: the orbit is a dependency chain. Walked by one thread,
// each step is two dependent L2 round trips (the first kernel: about 285 ns
// a step, 16 threads on the card). The redesign computes the orbit by
// doubling, one block of 1,024 threads per DEFLATE block:
//   J_0(q) = cnext[min(q + lenp[q], n - 1)] for q < block_len, and every
//   other q absorbs at bl;  P[0] = cnext[0];
//   round r: P[2^r + i] = J_r(P[i]) for i < 2^r, then J_{r+1} = J_r o J_r.
// It stops when P holds WALK_CAP - 1 entries or, checked on the device,
// when P's last entry is absorbed: about log2(longest orbit) rounds, each a
// block-wide pass over the jump table. P lives in shared memory (88 KiB);
// the ping-pong J tables (2 x (bl + 1) int32 per block, about 8 MB for a
// batch of 16) live in caller-allocated device memory, which stays in the
// 50 MB L2. J_r(q) >= q, so the gathers J_r(J_r(q)) of neighbouring threads
// land near each other. Then the count is the number of unabsorbed entries
// and every thread writes its share of plist.
//
// Malformed input (a length that is not positive, a block_len out of
// range, a cnext outside the block) never reads out of bounds: indexes are
// clamped and every value outside [0, block_len) absorbs; at most
// WALK_CAP - 1 entries are listed.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxDevices = 64;        // device ordinals cached
constexpr int kBatch = 16;             // table entries per thread per pass

__global__ void __launch_bounds__(kThreads)
match_walk_kernel(const int* __restrict__ cnext, const int* __restrict__ lenp,
                  const int* __restrict__ block_len, int* __restrict__ plist,
                  int* jumps, int n, int bl, int cap) {
  extern __shared__ int P[];          // cap - 1 orbit entries
  __shared__ int count;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int* cn = cnext + (int64_t)b * n;
  const int* ln = lenp + (int64_t)b * n;
  int* out = plist + (int64_t)b * cap;
  int* J = jumps + (int64_t)b * 2 * (bl + 1);
  int* Jn = J + (bl + 1);
  const int blen = min(max(__ldg(block_len + b), 0), bl);
  const int M = cap - 1;

  for (int q0 = tid; q0 <= bl; q0 += kThreads * kBatch) {
    int v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + u * kThreads;
      const int64_t k = q < blen ? (int64_t)q + __ldg(ln + q) : 0;
      v[u] = __ldg(cn + (k < 0 ? 0 : (k >= n ? n - 1 : k)));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + u * kThreads;
      if (q <= bl) J[q] = (q < blen && v[u] >= 0 && v[u] < blen) ? v[u] : bl;
    }
  }
  if (tid == 0) {
    const int c = __ldg(cn);
    P[0] = (c >= 0 && c < blen) ? c : bl;
    count = 0;
  }
  __syncthreads();

  int len = 1;                        // entries of P filled
  for (;;) {
    const int grow = min(len, M - len);
    for (int i = tid; i < grow; i += kThreads) P[len + i] = J[P[i]];
    len += grow;
    __syncthreads();
    if (len >= M || P[len - 1] == bl) break;
    // kBatch independent gathers in flight per thread: the loads of a
    // batch are issued before any of its stores
    for (int q0 = tid; q0 <= bl; q0 += kThreads * kBatch) {
      int a[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int q = q0 + u * kThreads;
        a[u] = q <= bl ? J[q] : bl;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) a[u] = J[a[u]];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int q = q0 + u * kThreads;
        if (q <= bl) Jn[q] = a[u];
      }
    }
    int* t = J;
    J = Jn;
    Jn = t;
    __syncthreads();
  }

  // absorbed entries stay absorbed, so the count is the unabsorbed ones
  int mine = 0;
  for (int m = tid; m < len; m += kThreads) mine += P[m] != bl;
  if (mine) atomicAdd(&count, mine);
  __syncthreads();
  const int cnt = count;
  if (tid == 0) out[0] = cnt + 1;
  for (int m = tid; m < M; m += kThreads)
    out[1 + m] = m < cnt ? (int)((unsigned)P[m]
                                 | ((unsigned)__ldg(ln + P[m]) << 17))
                         : 0;
}

}  // namespace

// jumps: int32, at least nblocks * 2 * (bl + 1) entries. The
// shared-memory attribute is a property of the kernel on one device: the
// first launch on each device (or the first with a larger cap) sets it, so
// the launches that a captured program replays make no attribute call.
extern "C" int jd_match_walk(const void* cnext, const void* lenp,
                             const void* block_len, void* plist,
                             void* jumps, int nblocks, int n, int bl,
                             int cap, void* stream) {
  static std::atomic<int> smem_set[kMaxDevices];
  if (nblocks <= 0) return 0;
  if (bl <= 0 || n <= bl || cap < 2) return (int)cudaErrorInvalidValue;
  const int smem = (cap - 1) * (int)sizeof(int);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem_set[dev].load(std::memory_order_acquire) < smem) {
    e = cudaFuncSetAttribute(match_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev].store(smem, std::memory_order_release);
  }
  match_walk_kernel<<<nblocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)cnext, (const int*)lenp, (const int*)block_len,
      (int*)plist, (int*)jumps, n, bl, cap);
  return (int)cudaGetLastError();
}
