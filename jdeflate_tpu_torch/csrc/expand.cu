// Token expansion for Hopper (sm_90a): lane-major walk tokens -> bytes.
//
// Replaces the Pallas kernel jdeflate_tpu/ops/expand2.py::_expand_kernel
// (reached by expand_tokens). Contract: ops/expand2.py::expand_tokens_ref
// in this package gives the same out[:produced].
//
// What bounds it: the dependency chains of the output, not bytes. A match
// may copy bytes that the token just before it wrote, so the first kernel
// walked each batch in order on one warp of one SM (about 19 ns per output
// byte). The redesign resolves a batch over the whole card in two kernels:
//
// expand_place_kernel: one warp per lane, one thread per slot. A warp scan
//   of the slot lengths gives each token its offset (the lane's offset comes
//   from the caller). Every output position gets one int32 in a source map:
//   ~byte for a literal (negative), and for byte i of a match (len, d) at
//   off its collapsed source off - d + (i mod d), which lies strictly before
//   it (at most 32 KiB + 510 bytes back), so overlapping copies need no
//   order. A warp writes one match's entries at a time, coalesced.
//
// the ordered-tile resolve (tile_resolve.cuh) over the map, with TokenFront
//   as its front end: 16 KiB tiles spread over every SM ground their chains
//   by pointer doubling, publish, and follow sources into earlier tiles
//   through the published states, so no tile waits for another to finish.
//
// buf: [halo (32 KiB) | output (out_cap)]; the caller fills the halo.
// Nothing is written at or past HALO + out_cap, so produced > out_cap can
// never write out of bounds, and a map entry that does not point strictly
// backwards within the window (malformed input) reads as byte 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_resolve.cuh"

namespace {

constexpr int kHalo = 32768;
constexpr int kSlots = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxBack = kHalo + 511;        // farthest well-formed source

__global__ void __launch_bounds__(256)
expand_place_kernel(const uint32_t* __restrict__ tok,
                    const int64_t* __restrict__ laneoff, int64_t L,
                    int* __restrict__ map, int64_t out_cap) {
  const int t = threadIdx.x & 31;
  const int64_t nwarps = (int64_t)gridDim.x * (blockDim.x >> 5);
  const int64_t lim = kHalo + out_cap;
  for (int64_t l = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       l < L; l += nwarps) {
    const uint32_t tk = __ldg(tok + l * kSlots + t);
    const uint32_t kind = tk >> 30;
    const int len = kind == 1 ? 1 : (kind == 2 ? (int)(tk & 0x1FF) : 0);
    int incl = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (t >= o) incl += y;
    }
    const int64_t off = kHalo + __ldg(laneoff + l) + (incl - len);
    if (kind == 1 && off >= kHalo && off < lim)
      map[off - kHalo] = ~(int)(tk & 0xFF);
    const int d = (int)((tk >> 9) & 0x7FFF) + 1;
    unsigned mm = __ballot_sync(kFull, kind == 2 && len > 0);
    while (mm) {
      const int s = __ffs(mm) - 1;
      mm &= mm - 1;
      const int64_t o_s = __shfl_sync(kFull, off, s);
      const int d_s = __shfl_sync(kFull, d, s);
      const int len_s = __shfl_sync(kFull, len, s);
      for (int i = t; i < len_s; i += 32) {
        const int64_t p = o_s + i;
        if (p < kHalo || p >= lim) continue;
        const int64_t src = o_s - d_s + i % d_s;
        map[p - kHalo] = (int)(src < 0 ? 0 : src);
      }
    }
  }
}

// The resolve's front end: a position's entry is its map entry (~byte for
// a literal, else a buf position). A source in the halo is final and read
// here; a source that does not point strictly backwards within the window
// (malformed input) reads as byte 0.
struct TokenFront {
  const int* map;
  const uint8_t* buf;
  const int64_t* produced;
  int64_t out_cap;

  __device__ __forceinline__ int64_t count() const {
    const int64_t p = *produced;
    return p < 0 ? 0 : (p < out_cap ? p : out_cap);
  }

  __device__ __forceinline__ void entries(int64_t j0, int64_t,
                                          int e[4]) const {
    const int4 m4 = __ldcg(reinterpret_cast<const int4*>(map + j0));
    const int mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t p = kHalo + j0 + i;
      const int m = mv[i];
      if (m < 0)
        e[i] = m;                                // literal: ~byte already
      else if (m >= p || p - m > kMaxBack)
        e[i] = ~0;                               // malformed: byte 0
      else if (m < kHalo)
        e[i] = ~(int)buf[m];                     // the halo is final
      else
        e[i] = m - kHalo;
    }
  }
};

}  // namespace

// map: int32, at least tiles * kTile entries; sync: int32, zeroed, at least
// 1 + tiles entries, where tiles = ceil(out_cap / kTile) (tile_resolve.cuh).
extern "C" int jd_expand(const void* tok, const void* laneoff, int64_t L,
                         void* map, int64_t map_len, void* buf,
                         const void* produced, int64_t out_cap, void* sync,
                         int64_t sync_len, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!tile_resolve::scratch_ok(out_cap, map_len, sync_len) ||
      kHalo + out_cap >= tile_resolve::kExt)
    return (int)cudaErrorInvalidValue;
  if (out_cap == 0) return 0;
  if (L > 0) {
    const int64_t blocks = (L + 7) / 8;    // 8 warps, one lane each
    expand_place_kernel<<<(unsigned)(blocks < (1 << 30) ? blocks : (1 << 30)),
                          256, 0, s>>>((const uint32_t*)tok,
                                       (const int64_t*)laneoff, L, (int*)map,
                                       out_cap);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)tile_resolve::launch_resolve(
      TokenFront{(const int*)map, (const uint8_t*)buf,
                 (const int64_t*)produced, out_cap},
      (int*)map, (uint8_t*)buf + kHalo, (int*)sync, out_cap, s);
}
