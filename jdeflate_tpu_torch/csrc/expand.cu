// Token expansion for Hopper (sm_90a): lane-major walk tokens -> bytes.
//
// Replaces the Pallas kernel jdeflate_tpu/ops/expand2.py::_expand_kernel
// (reached by expand_tokens). Contract: ops/expand2.py::expand_tokens_ref
// in this package gives the same out[:produced].
//
// Serial by design. Every match may copy bytes that the token just before it
// wrote, so the output of one batch is one dependency chain. The TPU kernel
// ran its regions in grid order for that reason; Hopper blocks run in no
// order, so ONE warp walks all lanes of the batch in order and no two blocks
// ever share a batch's output. A parallel resolve is later work.
//
// What bounds it: latency of the serial token chain, not bytes. The design
// keeps every read of history on chip: the last 64 KiB of output live in a
// shared-memory ring (the window is 32 KiB, a match at most 258 bytes), so a
// match reads shared memory and only writes to device memory. Each match
// is copied in one step: byte i of a match (len, dist) is history byte
// cursor - dist + (i mod dist), which lies before the match, so the 32
// threads copy all of it at once, overlapping copies (dist < len) included.
// A literal run (its length in bits 8:14 of its first slot, see
// walk.annotate_lit_runs) is written by the threads that hold its slots.
// Token rows are prefetched eight lanes ahead to hide load latency.
//
// buf: [halo (32 KiB) | output]; the caller fills the halo. Writes past
// buf_len are dropped, so produced > out_cap can never write out of bounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHalo = 32768;
constexpr int kRing = 65536;
constexpr int kRingMask = kRing - 1;
constexpr int kSlots = 32;
constexpr int kAhead = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t load_lane(const uint32_t* tok, int64_t L,
                                              int64_t l, int t) {
  return l < L ? __ldg(tok + l * kSlots + t) : 0u;
}

// Expand one lane whose 32 slots are spread over the warp (thread t holds
// slot t in `mine`). Returns the new cursor.
__device__ __forceinline__ int64_t expand_lane(uint32_t mine, int64_t cursor,
                                               uint8_t* ring, uint8_t* buf,
                                               int64_t buf_len, int t) {
  int s = 0;
  while (s < kSlots) {
    uint32_t tk = __shfl_sync(kFull, mine, s);
    uint32_t kind = tk >> 30;
    if (kind == 0) break;                      // an empty slot ends the lane
    if (kind == 1) {
      int cnt = max((int)((tk >> 8) & 63), 1);
      if (t >= s && t < s + cnt) {
        int64_t p = cursor + (t - s);
        uint8_t b = (uint8_t)(mine & 0xFF);
        ring[p & kRingMask] = b;
        if (p < buf_len) buf[p] = b;
      }
      cursor += cnt;
      s += cnt;
    } else {
      int len = (int)(tk & 0x1FF);
      int d = (int)((tk >> 9) & 0x7FFF) + 1;
      for (int i = t; i < len; i += 32) {
        int64_t p = cursor + i;
        uint8_t b = ring[(cursor - d + (i % d)) & kRingMask];
        ring[p & kRingMask] = b;
        if (p < buf_len) buf[p] = b;
      }
      cursor += len;
      s += 1;
    }
    __syncwarp();
  }
  return cursor;
}

__global__ void __launch_bounds__(32)
expand_kernel(const uint32_t* __restrict__ tok, int64_t L,
              uint8_t* __restrict__ buf, int64_t buf_len) {
  extern __shared__ uint8_t ring[];
  const int t = threadIdx.x;
  for (int i = t; i < kHalo; i += 32) ring[i] = buf[i];
  __syncwarp();

  uint32_t pf[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) pf[k] = load_lane(tok, L, k, t);
  int64_t cursor = kHalo;
  for (int64_t l = 0; l < L; l += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      uint32_t mine = pf[k];
      pf[k] = load_lane(tok, L, l + kAhead + k, t);
      cursor = expand_lane(mine, cursor, ring, buf, buf_len, t);
    }
  }
}

}  // namespace

extern "C" int jd_expand(const void* tok, int64_t L, void* buf,
                         int64_t buf_len, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRing);
  if (e != cudaSuccess) return (int)e;
  expand_kernel<<<1, 32, kRing, (cudaStream_t)stream>>>(
      (const uint32_t*)tok, L, (uint8_t*)buf, buf_len);
  return (int)cudaGetLastError();
}
