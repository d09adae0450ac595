// expand5 resolve for Hopper (sm_90a): per-position plan -> output bytes.
//
// Replaces the Pallas kernel jdeflate_tpu/ops/expand5.py::_resolve_kernel
// (reached by resolve_tpu). Contract: ops/expand5.py::resolve_ref in this
// package. P[p] is position p's plan pack (bit 25 valid, bit 24 literal;
// literal byte in 0:8; match dist-1 in 0:15 and phase in 15:24). A literal
// position takes its byte, a match position the byte at its collapsed
// source src = p - phase - d + phase % d (always before the match; negative
// reads the 32 KiB halo), an invalid position 0. All out_cap positions are
// written, the invalid tail past the bytes produced included.
//
// What bounds it: the dependency chains, not bytes (read P once, write the
// output once is about a microsecond). The first kernel walked the output
// in 2 KiB steps on one SM, about 11 barrier-separated doubling rounds a
// step. This one is a front end on the ordered-tile resolve
// (tile_resolve.cuh), which spreads 16 KiB tiles over every SM: PlanFront
// computes each position's entry straight from its plan (~byte for a
// literal, an invalid position or a halo byte; else the source), so there
// is no place kernel, and the map only holds the states tiles publish.
//
// A source before the halo (src < -32768, only from a malformed plan) reads
// 0, as in the first kernel and the TPU kernel's zeroed stage rows.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_resolve.cuh"

namespace {

constexpr int kHalo = 32768;
constexpr int kValid = 1 << 25;
constexpr int kLit = 1 << 24;

struct PlanFront {
  const int* P;
  const uint8_t* halo;
  int64_t n;

  __device__ __forceinline__ int64_t count() const { return n; }

  __device__ __forceinline__ void entries(int64_t j0, int64_t,
                                          int e[4]) const {
    int pv[4];
    if (j0 + 4 <= n) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(P + j0));
      pv[0] = v.x;
      pv[1] = v.y;
      pv[2] = v.z;
      pv[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = j0 + i < n ? __ldg(P + j0 + i) : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = pv[i];
      if (!(v & kValid)) {
        e[i] = ~0;
      } else if (v & kLit) {
        e[i] = ~(v & 0xFF);
      } else {
        const int d = (v & 0x7FFF) + 1;
        const int phase = (v >> 15) & 0x1FF;
        const int src = (int)(j0 + i) - phase - d + phase % d;
        e[i] = src >= 0 ? src
                        : (src >= -kHalo ? ~(int)halo[src + kHalo] : ~0);
      }
    }
  }
};

}  // namespace

// P: int32 (out_cap,), 16-byte aligned; map: int32, at least tiles * kTile
// entries; sync: int32, zeroed, at least 1 + tiles entries, where tiles =
// ceil(out_cap / kTile) (tile_resolve.cuh).
extern "C" int jd_expand5_resolve(const void* P, const void* halo, void* out,
                                  int64_t out_cap, void* map, int64_t map_len,
                                  void* sync, int64_t sync_len,
                                  void* stream) {
  if (!tile_resolve::scratch_ok(out_cap, map_len, sync_len) ||
      ((uintptr_t)P & 15) || ((uintptr_t)out & 3))
    return (int)cudaErrorInvalidValue;
  return (int)tile_resolve::launch_resolve(
      PlanFront{(const int*)P, (const uint8_t*)halo, out_cap}, (int*)map,
      (uint8_t*)out, (int*)sync, out_cap, (cudaStream_t)stream);
}
