// Ordered-tile resolve for Hopper (sm_90a), shared by the expansion kernels
// csrc/expand.cu (token expansion), csrc/expand5resolve.cu (v5 resolve) and
// csrc/expand1.cu (v1 match expansion).
//
// The problem all three share: every output position j in [0, n) is either
// a known byte or a pointer to a source position strictly before it (a
// match's collapsed source, at most one match length plus its distance
// back), and its byte is its source's byte. The chains cross the whole
// output, so walking it in order runs on one SM. This resolve spreads it
// over the card instead.
//
// A front end (the Front type, one per kernel) says how step 1 gets each
// position's entry, and how many positions there are:
//   int64_t count() const;        n, read on the device once per block
//   void entries(int64_t j0, int64_t n, int e[4]) const;
//                                 entries of positions j0..j0+3 (j0 < n)
// An entry is ~byte (negative) for a known byte, or a source position. An
// entry that does not point strictly backwards resolves to byte 0, so no
// tile ever waits on a later one, whatever the input.
//
// tile_resolve_kernel: a persistent grid (sized by occupancy) takes kTile
// positions at a time from an atomic ticket. A tile
//   1. gets its positions' entries from the front into shared memory;
//   2. grounds every chain that stays inside the tile by pointer doubling
//      (at most 15 rounds, ended early with __syncthreads_or): each
//      position ends on a byte or on a source in an earlier tile;
//   3. publishes these states into `map` (~byte, or the source in an
//      earlier tile) and sets its flag with a release store. No step so
//      far waits on another tile;
//   4. waits (acquire loads, one thread per flag) until every earlier tile
//      has published: they hold lower tickets, so their blocks are running
//      and publish without waiting, and the grid cannot deadlock;
//   5. follows each source into an earlier tile through the published
//      states, each of which is a byte or points to a strictly earlier
//      tile, to a byte (__ldcg: through L2, never a stale L1 line); a
//      thread's chains advance together, their loads in flight at once;
//   6. writes its bytes to out[j].
//
// In place: a front may read its own tile's bytes of `out` in step 1 (the
// v1 expansion keeps every byte no match writes), and the tile writes them
// in step 6. No tile reads another tile's bytes from `out`: every value
// from another tile comes from the states it published in `map`. So `out`
// may be the buffer the front reads. Nothing is written at or past n.
//
// The caller provides `map` (int32, at least tiles * kTile entries; a front
// may read its own entries there in step 1) and `sync` (int32, zeroed, at
// least 1 + tiles: the ticket, then one flag per tile); `out` is 4-byte
// aligned. What bounds the resolve: the flag chain and the dependent L2
// reads of step 5, a few per position, not bytes.

#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace tile_resolve {

constexpr int kTile = 16384;                     // positions per tile
constexpr int kThreads = 1024;
constexpr int kGroups = kTile / (4 * kThreads);  // 4-position groups
constexpr int kExt = 1 << 30;                    // state: kExt + source
constexpr int kRounds = 16;                      // > log2(kTile)
constexpr int kMaxDevices = 64;                  // device ordinals cached

static_assert(kTile % (4 * kThreads) == 0, "tile of whole 4-byte groups");

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Tile state in shared memory, one int per position:
//   < 0              grounded: byte ~s
//   [0, kTile)       points at that position of this tile
//   >= kExt          points at position s - kExt, in an earlier tile
template <class Front>
__global__ void __launch_bounds__(kThreads)
tile_resolve_kernel(const Front f, int* map, uint8_t* out, int* sync) {
  extern __shared__ int st[];
  __shared__ int ticket;
  int* next = sync;             // sync[0]: the ticket counter
  int* published = sync + 1;    // sync[1 + t]: tile t's states are in map
  const int tid = threadIdx.x;
  const int64_t n = f.count();
  const int ntiles = (int)((n + kTile - 1) / kTile);
  for (;;) {
    if (tid == 0) ticket = atomicAdd(next, 1);
    __syncthreads();
    const int tile = ticket;
    if (tile >= ntiles) break;
    const int base = tile * kTile;
    int* tmap = map + base;

    // 1. each position's state from its entry
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j0 = 4 * (g * kThreads + tid);
      int e[4] = {~0, ~0, ~0, ~0};
      if (base + j0 < n) f.entries(base + j0, n, e);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = base + j0 + i;
        const int m = e[i];
        int s;
        if (j >= n) {
          s = ~0;
        } else if (m < 0) {
          s = m;                                 // a known byte
        } else if (m >= j) {
          s = ~0;                                // not backwards: byte 0
        } else if (m >= base) {
          s = m - base;
        } else {
          s = kExt + m;
        }
        st[j0 + i] = s;
      }
    }
    __syncthreads();

    // 2. pointer doubling inside the tile; every pointer points strictly
    // backwards, so chains end within log2(kTile) rounds. Updating in place
    // only moves a position further along its own chain.
    for (int r = 0; r < kRounds; ++r) {
      int still = 0;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * (g * kThreads + tid) + i;
          const int s = st[j];
          if (s >= 0 && s < kTile) {
            const int nx = st[s];
            st[j] = nx;
            still |= nx >= 0 && nx < kTile;
          }
        }
      }
      if (!__syncthreads_or(still)) break;
    }

    // 3. publish the states in place of the tile's map entries: ~byte, or
    // the source in an earlier tile. This waits on no other tile.
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j0 = 4 * (g * kThreads + tid);
      int e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = st[j0 + i];
        e[i] = s >= kExt ? s - kExt : (s < 0 ? s : ~0);
      }
      if (base + j0 + 4 <= n) {
        *reinterpret_cast<int4*>(tmap + j0) = make_int4(e[0], e[1], e[2],
                                                        e[3]);
      } else {
        for (int i = 0; i < 4; ++i)
          if (base + j0 + i < n) tmap[j0 + i] = e[i];
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(published + tile, 1);

    // 4. wait until every earlier tile has published; they were all handed
    // out before this one and publish without waiting, so this ends
    for (int i = tid; i < tile; i += kThreads) {
      while (ld_acquire(published + i) == 0) {
      }
    }
    __syncthreads();

    // 5. follow each pointer into an earlier tile through the published
    // states, which always point to a strictly earlier tile, to a byte. A
    // thread's chains advance together, their loads in flight at once.
    int cur[4 * kGroups];
#pragma unroll
    for (int k = 0; k < 4 * kGroups; ++k) {
      const int s = st[4 * ((k >> 2) * kThreads + tid) + (k & 3)];
      cur[k] = s >= kExt ? s - kExt : -1;
    }
    for (;;) {
      int m[4 * kGroups];
#pragma unroll
      for (int k = 0; k < 4 * kGroups; ++k)
        m[k] = cur[k] >= 0 ? __ldcg(map + cur[k]) : -1;
      int pending = 0;
#pragma unroll
      for (int k = 0; k < 4 * kGroups; ++k) {
        if (cur[k] < 0) continue;
        if (m[k] < 0) {
          st[4 * ((k >> 2) * kThreads + tid) + (k & 3)] = m[k];
          cur[k] = -1;
        } else {
          cur[k] = m[k];
          pending = 1;
        }
      }
      if (!pending) break;
    }

    // 6. write the tile's bytes; no other tile reads them
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j0 = 4 * (g * kThreads + tid);
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = st[j0 + i];
        word |= (s < 0 ? (uint32_t)(~s) & 0xFF : 0u) << (8 * i);
      }
      const int64_t j = base + j0;
      if (j + 4 <= n) {
        *reinterpret_cast<uint32_t*>(out + j) = word;
      } else {
        for (int i = 0; i < 4; ++i)
          if (j + i < n) out[j + i] = (uint8_t)(word >> (8 * i));
      }
    }
  }
}

// Whether map (map_len entries) and sync (sync_len) are large enough to
// resolve up to max_n positions, and every position fits a state.
inline bool scratch_ok(int64_t max_n, int64_t map_len, int64_t sync_len) {
  const int64_t tiles = (max_n + kTile - 1) / kTile;
  return max_n >= 0 && map_len >= tiles * kTile && sync_len >= 1 + tiles &&
         tiles * kTile < kExt;
}

// Launch the resolve of at most max_n positions on stream s, on the current
// device: a grid of one block per tile, at most as many as fit on the card
// at once. The shared-memory attribute is a property of the kernel on one
// device, so it is set, and the grid cap computed, once per device and
// front: the first launch on each device does both.
template <class Front>
cudaError_t launch_resolve(const Front& f, int* map, uint8_t* out, int* sync,
                           int64_t max_n, cudaStream_t s) {
  static std::atomic<int> grid_cap[kMaxDevices];
  const int smem = kTile * (int)sizeof(int);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int cap = grid_cap[dev].load(std::memory_order_acquire);
  if (cap == 0) {
    if ((e = cudaFuncSetAttribute(
             tile_resolve_kernel<Front>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return e;
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, tile_resolve_kernel<Front>, kThreads, smem)) !=
        cudaSuccess)
      return e;
    cap = sms * (per_sm > 0 ? per_sm : 1);
    grid_cap[dev].store(cap, std::memory_order_release);
  }
  const int64_t tiles = (max_n + kTile - 1) / kTile;
  if (tiles == 0) return cudaSuccess;
  const int grid = (int)(tiles < cap ? tiles : cap);
  tile_resolve_kernel<Front><<<grid, kThreads, smem, s>>>(f, map, out, sync);
  return cudaGetLastError();
}

}  // namespace tile_resolve
