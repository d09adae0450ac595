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
// expand_resolve_kernel: a persistent grid takes 16 KiB output tiles from an
//   atomic ticket. A tile
//   1. loads its map entries into shared memory;
//   2. grounds every chain that stays inside the tile by pointer doubling
//      (at most 15 rounds, ended early with __syncthreads_or): each position
//      ends on a byte (literal or halo) or on a source in an earlier tile;
//   3. publishes these states in place of its map entries and sets its flag
//      with a release store. No step so far waits on another tile;
//   4. waits (acquire loads, one thread per flag) until every earlier tile
//      has published: they hold lower tickets, so their blocks are running
//      and publish without waiting, and the grid cannot deadlock;
//   5. follows each source into an earlier tile through the published
//      states, each of which is a byte or points to a strictly earlier
//      tile, to a byte; a thread's chains advance together;
//   6. writes its bytes. No tile reads another tile's bytes.
//   So no tile waits for another to finish: the first kernel's serial chain
//   becomes a few dependent L2 reads per position.
//
// buf: [halo (32 KiB) | output (out_cap)]; the caller fills the halo.
// Nothing is written at or past HALO + out_cap, so produced > out_cap can
// never write out of bounds, and a map entry that does not point strictly
// backwards within the window (malformed input) reads as byte 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHalo = 32768;
constexpr int kSlots = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kTile = 16384;                 // output bytes per tile
constexpr int kThreads = 1024;
constexpr int kGroups = kTile / (4 * kThreads);  // 4-byte groups per thread
constexpr int kMaxBack = kHalo + 511;        // farthest well-formed source
constexpr int kExt = 1 << 30;                // state: kExt + earlier source
constexpr int kRounds = 16;                  // > log2(kTile)

static_assert(kTile % (4 * kThreads) == 0, "tile of whole 4-byte groups");

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
//   >= kExt          points at buf position s - kExt, in an earlier tile
// Published in the map: ~byte, or the buf position in an earlier tile.
__global__ void __launch_bounds__(kThreads)
expand_resolve_kernel(int* map, uint8_t* buf,
                      const int64_t* __restrict__ produced, int64_t out_cap,
                      int* sync) {
  extern __shared__ int st[];
  __shared__ int ticket;
  int* next = sync;             // sync[0]: the ticket counter
  int* published = sync + 1;    // sync[1 + t]: tile t's states are in map
  const int tid = threadIdx.x;
  const int64_t prod = *produced;
  const int64_t n_out = prod < 0 ? 0 : (prod < out_cap ? prod : out_cap);
  const int ntiles = (int)((n_out + kTile - 1) / kTile);
  for (;;) {
    if (tid == 0) ticket = atomicAdd(next, 1);
    __syncthreads();
    const int tile = ticket;
    if (tile >= ntiles) break;
    const int64_t base = kHalo + (int64_t)tile * kTile;
    const int64_t end = kHalo + n_out;
    int* tmap = map + (int64_t)tile * kTile;

    // 1. each position's state from its map entry
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j0 = 4 * (g * kThreads + tid);
      const int4 m4 = __ldcg(reinterpret_cast<const int4*>(tmap + j0));
      const int mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t p = base + j0 + i;
        const int m = mv[i];
        int s;
        if (p >= end || m < 0) {
          s = p >= end ? ~0 : m;                 // literal: ~byte already
        } else if (m >= p || p - m > kMaxBack) {
          s = ~0;                                // malformed: byte 0
        } else if (m < kHalo) {
          s = ~(int)buf[m];                      // the halo is final
        } else if (m >= base) {
          s = (int)(m - base);
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
      if (base + j0 + 4 <= end) {
        *reinterpret_cast<int4*>(tmap + j0) = make_int4(e[0], e[1], e[2],
                                                        e[3]);
      } else {
        for (int i = 0; i < 4; ++i)
          if (base + j0 + i < end) tmap[j0 + i] = e[i];
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
        m[k] = cur[k] >= 0 ? __ldcg(map + (cur[k] - kHalo)) : -1;
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
      const int64_t p = base + j0;
      if (p + 4 <= end) {
        *reinterpret_cast<uint32_t*>(buf + p) = word;
      } else {
        for (int i = 0; i < 4; ++i)
          if (p + i < end) buf[p + i] = (uint8_t)(word >> (8 * i));
      }
    }
  }
}

int g_resolve_grid = 0;

}  // namespace

// map: int32, at least tiles * kTile entries; sync: int32, zeroed, at least
// 1 + tiles entries, where tiles = ceil(out_cap / kTile).
extern "C" int jd_expand(const void* tok, const void* laneoff, int64_t L,
                         void* map, int64_t map_len, void* buf,
                         const void* produced, int64_t out_cap, void* sync,
                         int64_t sync_len, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t tiles = (out_cap + kTile - 1) / kTile;
  if (out_cap < 0 || map_len < tiles * kTile || sync_len < 1 + tiles ||
      kHalo + tiles * kTile >= kExt)
    return (int)cudaErrorInvalidValue;
  if (tiles == 0) return 0;
  if (L > 0) {
    const int64_t blocks = (L + 7) / 8;    // 8 warps, one lane each
    expand_place_kernel<<<(unsigned)(blocks < (1 << 30) ? blocks : (1 << 30)),
                          256, 0, s>>>((const uint32_t*)tok,
                                       (const int64_t*)laneoff, L, (int*)map,
                                       out_cap);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int smem = kTile * (int)sizeof(int);
  if (g_resolve_grid == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        expand_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, expand_resolve_kernel, kThreads, smem)) != cudaSuccess)
      return (int)e;
    g_resolve_grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = (int)(tiles < g_resolve_grid ? tiles : g_resolve_grid);
  expand_resolve_kernel<<<grid, kThreads, smem, s>>>(
      (int*)map, (uint8_t*)buf, (const int64_t*)produced, out_cap,
      (int*)sync);
  return (int)cudaGetLastError();
}
