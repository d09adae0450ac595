// v1 match expansion for Hopper (sm_90a): matches expanded in place over a
// byte buffer whose literals are already placed.
//
// Replaces the Pallas kernel jdeflate_tpu/ops/expand.py::_expand_kernel
// (reached by expand_matches from the anchored decode's _assemble_pallas).
// Contract: ops/expand.py::expand_matches_ref in this package. A match t
// (off, d, len) is expanded if it lies in some block's [t0, t1) and d > 0,
// len > 0, 0 <= off < n: byte q = off + i < n takes the byte at its
// collapsed source off - d + (i mod d) if that is >= 0. Every other byte
// keeps the value buf held (a placed literal, the halo, zero slack). The
// reference resolves q by its covering match (the highest-index expanded
// match starting at or before q); this kernel gives q the source of the
// expanded match whose bytes contain it. The two agree on every list whose
// expanded matches have disjoint byte ranges at increasing offsets, which
// is every list the anchored decode builds (codec/inflate.py::
// _expand1_inputs: matches in stream order at cumsum offsets); that is the
// contract here.
//
// What bounds it: the dependency chains, not bytes. The first kernel copied
// matches in stream order on one warp of one SM, about 276 ns a match. This
// one is three steps over the card:
//   1. the map (one int32 per buf position) is filled with kKeep;
//   2. expand1_place_kernel, one warp per expanded match: its positions get
//      their collapsed sources, coalesced, and the furthest byte any match
//      writes goes to *end (atomicMax);
//   3. the ordered-tile resolve (tile_resolve.cuh) over positions [0, *end)
//      with MatchFront as its front end: a kKeep position is the byte buf
//      holds, any other points at its source.
// In place: tiles write their own positions of buf only, and read other
// tiles' values from the states published in the map, never from buf (the
// resolve's invariant). Nothing at or past *end is rewritten. Expanding an
// expanded buffer gives it back: the kept bytes ground every chain, and
// expansion changes none of them.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_resolve.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kKeep = 0x7FFFFFFF;    // map entry: keep buf's byte

__global__ void __launch_bounds__(256)
expand1_fill_kernel(int4* __restrict__ map, int64_t n4) {
  const int4 k = make_int4(kKeep, kKeep, kKeep, kKeep);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x)
    map[i] = k;
}

__global__ void __launch_bounds__(256)
expand1_place_kernel(int64_t n, const int* __restrict__ m_off,
                     const int* __restrict__ m_d,
                     const int* __restrict__ m_len, int64_t T,
                     const int* __restrict__ ranges, int nblocks,
                     int* __restrict__ map, int* __restrict__ end) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = (int64_t)gridDim.x * (blockDim.x >> 5);
  int hi = 0;
  for (int b = 0; b < nblocks; ++b) {
    int64_t t0 = __ldg(ranges + 4 * b), t1 = __ldg(ranges + 4 * b + 1);
    t0 = t0 < 0 ? 0 : (t0 > T ? T : t0);
    t1 = t1 < t0 ? t0 : (t1 > T ? T : t1);
    for (int64_t t = t0 + warp; t < t1; t += nwarps) {
      const int64_t off = __ldg(m_off + t);
      const int d = __ldg(m_d + t);
      const int64_t len = __ldg(m_len + t);
      if (d <= 0 || len <= 0 || off < 0 || off >= n) continue;
      const int64_t stop = off + len < n ? off + len : n;
      hi = stop > hi ? (int)stop : hi;
      for (int64_t q = off + lane; q < stop; q += 32) {
        const int64_t src = off - d + (int)(q - off) % d;
        if (src >= 0) map[q] = (int)src;
      }
    }
  }
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0 && hi > 0) atomicMax(end, hi);
}

// The resolve's front end: a kKeep entry is the byte buf holds (this
// tile's own position, read before the tile writes it), any other entry
// the source the place step wrote.
struct MatchFront {
  const int* map;
  const uint8_t* buf;
  const int* end;

  __device__ __forceinline__ int64_t count() const { return *end; }

  __device__ __forceinline__ void entries(int64_t j0, int64_t n,
                                          int e[4]) const {
    const int4 m4 = __ldcg(reinterpret_cast<const int4*>(map + j0));
    const int mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      e[i] = mv[i] != kKeep ? mv[i] : (j0 + i < n ? ~(int)buf[j0 + i] : ~0);
  }
};

}  // namespace

// buf: (n,) u8, 4-byte aligned; map: int32, at least tiles * kTile entries;
// sync: int32, zeroed, at least 2 + tiles entries (the furthest byte
// written, then the resolve's ticket and flags), where tiles =
// ceil(n / kTile) (tile_resolve.cuh).
extern "C" int jd_expand1(void* buf, int64_t n, const void* m_off,
                          const void* m_d, const void* m_len, int64_t T,
                          const void* ranges, int nblocks, void* map,
                          int64_t map_len, void* sync, int64_t sync_len,
                          void* stream) {
  if (!tile_resolve::scratch_ok(n, map_len, sync_len - 1) ||
      ((uintptr_t)buf & 3))
    return (int)cudaErrorInvalidValue;
  if (nblocks <= 0 || T <= 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n4 = (n + 3) / 4;
  expand1_fill_kernel<<<(unsigned)((n4 + 255) / 256 < 1024
                                       ? (n4 + 255) / 256 : 1024),
                        256, 0, s>>>((int4*)map, n4);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (T + 7) / 8;    // 8 warps, a match each
  expand1_place_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), 256, 0,
                         s>>>(n, (const int*)m_off, (const int*)m_d,
                              (const int*)m_len, T, (const int*)ranges,
                              nblocks, (int*)map, (int*)sync);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)tile_resolve::launch_resolve(
      MatchFront{(const int*)map, (const uint8_t*)buf, (const int*)sync},
      (int*)map, (uint8_t*)buf, (int*)sync + 1, n, s);
}
