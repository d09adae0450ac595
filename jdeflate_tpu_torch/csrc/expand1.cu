// v1 match expansion for Hopper (sm_90a): matches expanded in place over a
// byte buffer whose literals are already placed.
//
// Replaces the Pallas kernel jdeflate_tpu/ops/expand.py::_expand_kernel
// (reached by expand_matches from the anchored decode's _assemble_pallas).
// Contract: ops/expand.py::expand_matches_ref in this package. For each
// block b in order, for each match t in [ranges[b].t0, ranges[b].t1) in
// order: buf[off + i] = buf[off - d + i % d] for i in [0, len). A byte is
// copied only when both its destination and its source lie in [0, n);
// tokens with d <= 0 or len <= 0 copy nothing.
//
// Byte i of a match reads off - d + (i mod d), which lies before the match,
// so one match is one parallel copy (overlapping copies, d < len, included)
// and only the order between matches matters: a match may read what the
// match before it wrote, and a block's window reaches into the previous
// block's output. So ONE thread block runs the whole call, blocks and
// matches in order; one warp copies each match, with a warp barrier
// between matches.
//
// Each block's working set (its matches' sources and destinations: the
// 32 KiB window and at most 64 KiB of output on the anchored path) is
// staged in shared memory by all 256 threads, expanded there, and written
// back, so the serial chain of matches reads shared memory, not device
// memory. A block whose span does not fit (malformed input only) is
// expanded in device memory directly, with the same bounds.
//
// What bounds it: latency of the serial match chain (one warp barrier and a
// shared-memory round trip per match), not bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCap = 196608;      // staged bytes per block (192 KiB)
// span bounds travel as unsigned words offset by kBias (unsigned 64-bit
// atomicMin/Max exist on every target; offsets are > -2^31)
constexpr int64_t kBias = (int64_t)1 << 40;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// Warp 0: expand tokens [t0, t1) over p[0, size), whose byte 0 is buffer
// position base.
__device__ void expand_tokens(uint8_t* p, int64_t base, int64_t size,
                              const int* __restrict__ m_off,
                              const int* __restrict__ m_d,
                              const int* __restrict__ m_len, int64_t t0,
                              int64_t t1, int lane) {
  for (int64_t c = t0; c < t1; c += 32) {
    const int64_t me = c + lane;
    int o = 0, d = 0, l = 0;
    if (me < t1) {
      o = __ldg(m_off + me);
      d = __ldg(m_d + me);
      l = __ldg(m_len + me);
    }
    const int nk = (int)imin(32, t1 - c);
    for (int k = 0; k < nk; ++k) {
      const int64_t off = (int64_t)__shfl_sync(kFull, o, k) - base;
      const int dist = __shfl_sync(kFull, d, k);
      const int len = __shfl_sync(kFull, l, k);
      if (dist > 0 && len > 0) {
        for (int i = lane; i < len; i += 32) {
          const int64_t dst = off + i;
          const int64_t src = off - dist + (i % dist);
          if (dst >= 0 && dst < size && src >= 0 && src < size)
            p[dst] = p[src];
        }
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
expand1_kernel(uint8_t* buf, int64_t n, const int* __restrict__ m_off,
               const int* __restrict__ m_d, const int* __restrict__ m_len,
               int64_t T, const int* __restrict__ ranges, int nblocks) {
  extern __shared__ uint8_t stage[];
  __shared__ unsigned long long span_lo, span_hi;   // offset by kBias
  const int t = threadIdx.x;
  for (int b = 0; b < nblocks; ++b) {
    const int64_t t0 = imin(imax(ranges[4 * b], 0), T);
    const int64_t t1 = imin(imax(ranges[4 * b + 1], t0), T);
    if (t1 == t0) continue;
    if (t == 0) {
      span_lo = (unsigned long long)(n + kBias);
      span_hi = (unsigned long long)kBias;
    }
    __syncthreads();
    int64_t lo = n, hi = 0;
    for (int64_t i = t0 + t; i < t1; i += kThreads) {
      const int d = m_d[i], l = m_len[i];
      if (d > 0 && l > 0) {
        lo = imin(lo, (int64_t)m_off[i] - d);
        hi = imax(hi, (int64_t)m_off[i] + l);
      }
    }
    atomicMin(&span_lo, (unsigned long long)(lo + kBias));
    atomicMax(&span_hi, (unsigned long long)(hi + kBias));
    __syncthreads();
    const int64_t slo = imax((int64_t)span_lo - kBias, 0);
    const int64_t shi = imin((int64_t)span_hi - kBias, n);
    if (shi <= slo) {
      __syncthreads();
      continue;
    }
    if (shi - slo <= kCap) {
      for (int64_t i = t; i < shi - slo; i += kThreads)
        stage[i] = buf[slo + i];
      __syncthreads();
      // a byte whose source or destination leaves [0, n) lies outside the
      // staged span too, so both paths drop the same bytes
      if (t < 32) expand_tokens(stage, slo, shi - slo, m_off, m_d, m_len, t0,
                                t1, t);
      __syncthreads();
      for (int64_t i = t; i < shi - slo; i += kThreads)
        buf[slo + i] = stage[i];
    } else if (t < 32) {
      expand_tokens(buf, 0, n, m_off, m_d, m_len, t0, t1, t);
    }
    // this block's bytes are visible to the next block's reads
    __syncthreads();
  }
}

}  // namespace

extern "C" int jd_expand1(void* buf, int64_t n, const void* m_off,
                          const void* m_d, const void* m_len, int64_t T,
                          const void* ranges, int nblocks, void* stream) {
  if (nblocks <= 0 || T <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      expand1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCap);
  if (e != cudaSuccess) return (int)e;
  expand1_kernel<<<1, kThreads, kCap, (cudaStream_t)stream>>>(
      (uint8_t*)buf, n, (const int*)m_off, (const int*)m_d,
      (const int*)m_len, T, (const int*)ranges, nblocks);
  return (int)cudaGetLastError();
}
