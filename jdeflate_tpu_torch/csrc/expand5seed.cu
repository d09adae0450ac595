// expand5 seed plane for Hopper (sm_90a): walk tokens -> the 16-bit seed of
// every fast-slice token at its first output byte.
//
// Replaces the Pallas kernel jdeflate_tpu/ops/expand5.py::_seed_mm_kernel
// (reached by seed_scatter_mm) and the slot attributes computed before it.
// Contract: ops/expand5.py::seed_plane_ref in this package. From tok (L, 32)
// lane-major walk tokens and laneoff (L,) i64, the exclusive scan of the
// lanes' output bytes (the walk's epilogue gives it):
//   off[l*8 + s]    = laneoff[l] + bytes of lane l's slots before s;
//   seed16[l*8 + s] = 0 empty, 0x8000|byte literal, d match (d = 32768:
//                     0xFFFF), for the fast slice s < 8;
//   plane[p]        = seed16 of the fast-slice slot whose off is p, 0 at
//                     every other p in [0, out_cap).
//
// The TPU kernel placed seeds by one-hot matrix products on the MXU over a
// window of two candidate blocks per 4 KiB region (it had no scatter), into
// a plane the caller had zeroed. Here no one zeroes the plane: the kernel
// writes each of its positions exactly once. A block of 256 lanes covers
// one contiguous output range, [laneoff[first], laneoff[first + 256]) (the
// last block ends at the bytes produced). It stages the range in shared
// memory 4,096 positions at a time (a lane produces up to 32 * 258 bytes,
// so a range can be long: it loops rather than sizing for the worst case):
// zero the stage, place the block's seeds that fall in it (atomicMax, so a
// repeated offset still gives the plain version's max), store it
// coalesced. The rest of each token's span, the bytes of slots past the
// fast slice (the spill pass max-scatters those afterwards) and the tail
// [produced, out_cap), which every block zeroes a grid-stride share of, are
// 0. Nothing is written at or past out_cap. The block ranges cover each
// position once only when laneoff is the scan of the tokens' lengths.
//
// What bounds it: bytes. The fast slice of the tokens (32 of each lane's
// 128 bytes) and laneoff are read once; the plane and the slot arrays are
// written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 256;       // lanes (threads) per block
constexpr int kSlots = 32;
constexpr int kSlice = 8;         // S_SLICE
constexpr int kChunk = 4096;      // plane positions staged per pass
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int tok_len(uint32_t t) {
  const uint32_t kind = t >> 30;
  return kind == 1u ? 1 : (kind == 2u ? (int)(t & 0x1FF) : 0);
}

__device__ __forceinline__ int tok_seed(uint32_t t) {
  const uint32_t kind = t >> 30;
  if (kind == 1u) return 0x8000 | (int)(t & 0xFF);
  if (kind != 2u) return 0;
  const int d = (int)((t >> 9) & 0x7FFF) + 1;
  return d == 32768 ? 0xFFFF : d;
}

__global__ void __launch_bounds__(kLanes)
seed_plane_kernel(const uint32_t* __restrict__ tok,
                  const int64_t* __restrict__ laneoff, int64_t L,
                  int* __restrict__ plane, int64_t out_cap,
                  int* __restrict__ off_out, int* __restrict__ seed_out) {
  __shared__ int stage[kChunk];
  __shared__ long long s_range[2];
  __shared__ long long s_produced;

  const int tid = threadIdx.x;
  const int64_t first = (int64_t)blockIdx.x * kLanes;
  const int64_t lane = first + tid;

  // the bytes produced: the last lane's offset plus its tokens' lengths
  if (tid < 32) {
    int n = L > 0 ? tok_len(__ldg(tok + (L - 1) * kSlots + tid)) : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) n += __shfl_xor_sync(kFull, n, d);
    if (tid == 0) s_produced = L > 0 ? __ldg(laneoff + L - 1) + n : 0;
  }
  __syncthreads();
  const long long produced = s_produced;
  if (tid == 0 && first < L) {
    s_range[0] = __ldg(laneoff + first);
    s_range[1] = first + kLanes < L ? __ldg(laneoff + first + kLanes)
                                    : produced;
  }

  // this lane's fast slice: offsets and seeds, written out as slot arrays
  long long o[kSlice];
  int sd[kSlice];
  if (lane < L) {
    const uint4* row = reinterpret_cast<const uint4*>(tok + lane * kSlots);
    const uint4 a = __ldg(row), b = __ldg(row + 1);
    const uint32_t t[kSlice] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    long long run = __ldg(laneoff + lane);
#pragma unroll
    for (int s = 0; s < kSlice; ++s) {
      o[s] = run;
      sd[s] = tok_seed(t[s]);
      run += tok_len(t[s]);
    }
    int4* oo = reinterpret_cast<int4*>(off_out + lane * kSlice);
    int4* so = reinterpret_cast<int4*>(seed_out + lane * kSlice);
    oo[0] = make_int4((int)o[0], (int)o[1], (int)o[2], (int)o[3]);
    oo[1] = make_int4((int)o[4], (int)o[5], (int)o[6], (int)o[7]);
    so[0] = make_int4(sd[0], sd[1], sd[2], sd[3]);
    so[1] = make_int4(sd[4], sd[5], sd[6], sd[7]);
  } else {
#pragma unroll
    for (int s = 0; s < kSlice; ++s) {
      o[s] = -1;
      sd[s] = 0;
    }
  }
  __syncthreads();

  // the block's output range, a chunk at a time
  if (first < L) {
    const long long lo = s_range[0] < 0 ? 0 : s_range[0];
    const long long hi = s_range[1] < out_cap ? s_range[1] : out_cap;
    for (long long c0 = lo; c0 < hi; c0 += kChunk) {
      const int n = (int)(hi - c0 < kChunk ? hi - c0 : kChunk);
      for (int i = tid; i < n; i += kLanes) stage[i] = 0;
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSlice; ++s)
        if (sd[s] != 0 && o[s] >= c0 && o[s] < c0 + n)
          atomicMax(stage + (o[s] - c0), sd[s]);
      __syncthreads();
      for (int i = tid; i < n; i += kLanes) plane[c0 + i] = stage[i];
      __syncthreads();
    }
  }

  // the tail past the bytes produced, shared by every block
  const long long step = (long long)gridDim.x * kLanes;
  for (long long p = (produced < 0 ? 0 : produced) + first + tid;
       p < out_cap; p += step)
    plane[p] = 0;
}

}  // namespace

// tok: (L, 32) int32, 16-byte aligned rows; laneoff: (L,) int64; plane:
// (out_cap,) int32; off, seed16: (L * 8,) int32, 16-byte aligned.
extern "C" int jd_expand5_seed(const void* tok, const void* laneoff,
                               int64_t L, void* plane, int64_t out_cap,
                               void* off, void* seed16, void* stream) {
  if (L < 0 || out_cap < 0) return (int)cudaErrorInvalidValue;
  if (L == 0 && out_cap == 0) return 0;
  int64_t blocks = (L + kLanes - 1) / kLanes;
  if (blocks < 1) blocks = 1;
  if (blocks > (1 << 30)) return (int)cudaErrorInvalidValue;
  seed_plane_kernel<<<(unsigned)blocks, kLanes, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tok, (const int64_t*)laneoff, L, (int*)plane, out_cap,
      (int*)off, (int*)seed16);
  return (int)cudaGetLastError();
}
