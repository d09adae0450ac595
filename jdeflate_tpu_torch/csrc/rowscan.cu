// Running max or min along the last dimension of int64 rows, forward or
// reversed, for Hopper (sm_90a): a segmented inclusive scan over the flat
// array in tiles of 2,048 elements, so every SM works whatever the count
// and the length of the rows.
//
// Replaces no TPU kernel: the JAX package's running max and min
// (lax.cummax, lax.cummin in jdeflate_tpu/codec/deflate.py and
// jdeflate_tpu/ops/{lz77,bitpack}.py) are XLA. Added because the port's
// plain version, torch.cummax / torch.cummin, is PyTorch's
// innermost-dimension scan with indices: one thread block a row, walked
// serially, and indices that no caller reads. The coding stages' scans
// have few long rows (16 of 65,536-76,481 a batch, one of 381,348-431,748),
// so a few SMs did all the work: 1.2-1.4 ms a 1 MiB batch.
// Contract: ops/scan.py::running_ref, bit for bit (max and min of int64 are
// exact).
//
// Layout. The R rows of n elements are one flat array of N = R * n in
// logical order. Forward, logical index i is physical element i; reversed,
// it is physical element N - 1 - i, which turns the whole array round:
// row R - 1 - r becomes row r reversed, and rows still start at the
// multiples of n. A segmented scan in logical order, segments starting at
// the multiples of n, written back to the physical element each value was
// read from, is every row's running value in either direction.
//
// The segment rule. Element i at offset off = i mod n in its row may take
// the value of element i - d only when off >= d. Every partial result
// below covers a range that ends at its own element and never leaves that
// element's row (by induction over the steps), so the rule alone keeps
// rows apart: no flags travel.
//
// A tile is one block of 256 threads. Warp w takes the tile's elements
// [256 w, 256 w + 256); lane l holds 32 k + l of them (k < 8), so each
// load and store of a warp is 256 contiguous bytes, all eight loads in
// flight before the arithmetic. Each 32-element chunk is scanned by
// shuffles (Hillis-Steele, 5 steps), chunks chain through lane 31's value,
// warps through a shuffle scan of the 8 warps' last values in shared
// memory, tiles through a carry: the first kernel (only where a row
// crosses a tile's start) writes each tile's reduction of its last
// segment, from its last row start, or its own start, to its end; in the
// second, a tile whose first element is not a row's first reduces the
// aggregates of the earlier tiles of that row (at most n / 2048 + 1, a
// warp's loop) and adds them to its elements of that row.
//
// What bounds it: memory, 8 bytes in and 8 out an element and a few
// integer operations: (16, 68,273) moves 17.5 MB, 5.2 us at 3.35 TB/s.
// The aggregate kernel reads the input once more; at the coding stages'
// shapes (at most 9.8 MB) the input stays in the 50 MB L2 for the second
// kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;      // ops/scan.py TILE
constexpr unsigned kFull = 0xffffffffu;

struct MaxOp {
  static constexpr long long kId = (long long)(-9223372036854775807LL - 1);
  __device__ __forceinline__ static long long op(long long a, long long b) {
    return a > b ? a : b;
  }
};

struct MinOp {
  static constexpr long long kId = 9223372036854775807LL;
  __device__ __forceinline__ static long long op(long long a, long long b) {
    return a < b ? a : b;
  }
};

__device__ __forceinline__ long long phys(long long i, long long N,
                                          bool rev) {
  return rev ? N - 1 - i : i;
}

// The reduction of tile t's last segment, for every tile: from
// max(tile start, the row start of its last element) to its last element.
template <class Op, bool Rev>
__global__ void __launch_bounds__(kThreads)
rowscan_agg_kernel(const long long* __restrict__ x,
                   long long* __restrict__ agg, long long N, int n) {
  __shared__ long long part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t0 = (long long)blockIdx.x * kTile;
  const long long tend = min(t0 + kTile, N) - 1;
  const long long lo = max(t0, tend - tend % n);
  const long long base = t0 + warp * 256 + lane;
  long long acc = Op::kId;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * 32;
    if (i >= lo && i <= tend) acc = Op::op(acc, __ldg(x + phys(i, N, Rev)));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    acc = Op::op(acc, __shfl_xor_sync(kFull, acc, d));
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? part[lane] : Op::kId;
#pragma unroll
    for (int d = kWarps / 2; d > 0; d >>= 1)
      acc = Op::op(acc, __shfl_xor_sync(kFull, acc, d));
    if (lane == 0) agg[blockIdx.x] = acc;
  }
}

template <class Op, bool Rev>
__global__ void __launch_bounds__(kThreads)
rowscan_kernel(const long long* __restrict__ x, long long* __restrict__ out,
               const long long* __restrict__ agg, long long N, int n) {
  __shared__ long long wagg[kWarps];
  __shared__ long long wscan[kWarps];
  __shared__ long long tcarry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long t0 = (long long)blockIdx.x * kTile;
  const long long base = t0 + warp * 256 + lane;

  long long v[kItems];
  int off[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * 32;
    v[k] = i < N ? __ldg(x + phys(i, N, Rev)) : Op::kId;
  }
  // offsets in the row: one division, then steps of 32
  off[0] = (int)(base % n);
#pragma unroll
  for (int k = 1; k < kItems; ++k) {
    int o = off[k - 1] + 32;
    off[k] = o < n ? o : (n > 32 ? o - n : o % n);
  }

  // chunks of 32 within the warp, chained through lane 31
  long long chain = Op::kId;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    long long a = v[k];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long b = __shfl_up_sync(kFull, a, d);
      if (lane >= d && off[k] >= d) a = Op::op(a, b);
    }
    if (k > 0 && off[k] >= lane + 1) a = Op::op(a, chain);
    chain = __shfl_sync(kFull, a, 31);
    v[k] = a;
  }
  if (lane == 31) wagg[warp] = chain;

  // the carry into the tile (value at t0 - 1 over its row's part before
  // t0): the aggregates of the earlier tiles of that row
  if (warp == kWarps - 1) {
    const int off0 = (int)(t0 % n);
    long long c = Op::kId;
    if (agg != nullptr && off0 > 0) {
      const long long u0 = (t0 - off0) / kTile;
      for (long long u = u0 + lane; u < blockIdx.x; u += 32)
        c = Op::op(c, __ldg(agg + u));
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      c = Op::op(c, __shfl_xor_sync(kFull, c, d));
    if (lane == 0) tcarry = c;
  }
  __syncthreads();

  // the warps' last values, scanned by the same rule at a stride of 256
  if (warp == 0) {
    long long a = lane < kWarps ? wagg[lane] : Op::kId;
    const int offw = (int)((t0 + lane * 256 + 255) % n);
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const long long b = __shfl_up_sync(kFull, a, d);
      if (lane >= d && offw >= d * 256) a = Op::op(a, b);
    }
    if (lane < kWarps) wscan[lane] = a;
  }
  __syncthreads();

  const long long wc = warp > 0 ? wscan[warp - 1] : Op::kId;
  const long long tc = tcarry;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * 32;
    const int rel = k * 32 + lane + 1;           // i - (warp start - 1)
    long long a = v[k];
    if (warp > 0 && off[k] >= rel) a = Op::op(a, wc);
    if (off[k] >= warp * 256 + rel) a = Op::op(a, tc);
    if (i < N) out[phys(i, N, Rev)] = a;
  }
}

template <class Op, bool Rev>
int launch(const long long* x, long long* out, long long* agg, long long N,
           int n, cudaStream_t s) {
  const unsigned tiles = (unsigned)((N + kTile - 1) / kTile);
  if (agg != nullptr) {
    rowscan_agg_kernel<Op, Rev><<<tiles, kThreads, 0, s>>>(x, agg, N, n);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rowscan_kernel<Op, Rev><<<tiles, kThreads, 0, s>>>(x, out, agg, N, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: N int64 as rows of n (N a multiple of n, n >= 1, n < 2^30);
// agg: ceil(N / 2048) int64 of scratch, or null where every tile starts a
// row (one tile, or 2048 % n == 0): the aggregate kernel then does not run.
// is_min: running min, else max; reverse: from each row's end. out is
// written at every element.
extern "C" int jd_rowscan(const void* x, void* out, void* agg, long long N,
                          int n, int is_min, int reverse, void* stream) {
  if (N <= 0) return 0;
  if (n <= 0 || n >= (1 << 30) || N % n != 0 ||
      (N + kTile - 1) / kTile > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const auto* xi = (const long long*)x;
  auto* o = (long long*)out;
  auto* a = (long long*)agg;
  const auto s = (cudaStream_t)stream;
  if (is_min)
    return reverse ? launch<MinOp, true>(xi, o, a, N, n, s)
                   : launch<MinOp, false>(xi, o, a, N, n, s);
  return reverse ? launch<MaxOp, true>(xi, o, a, N, n, s)
                 : launch<MaxOp, false>(xi, o, a, N, n, s);
}
