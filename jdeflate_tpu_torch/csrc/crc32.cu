// CRC-32 (zlib's: reflected polynomial 0xEDB88320, init and result
// complemented) of a byte range on the card, in one launch.
//
// Replaces no Pallas kernel: jdeflate_tpu/ops/checksum.py computes crc32 in
// XLA. Added because the port's plain PyTorch version
// (ops/checksum.py::_crc32_program, a captured graph of about 850 small
// kernels per MiB) took about 23% of a 1 MiB gzip round trip and of a
// Silesia decode on an H100. Contract: zlib.crc32(bytes, init).
//
// What bounds it: the n bytes, read once: n / 3.35 TB/s, 0.3 us for 1 MiB
// and 15 us for 51 MB. Beside that, one launch and the fold of the block
// states by the last block.
//
// Design. The raw CRC (state 0, no complements) is GF(2)-linear:
// raw(A||B) = M_len(B) raw(A) ^ raw(B), where M_k advances a state over k
// zero bytes, and leading zero bytes leave a zero state at zero. So the
// bytes are cut at fixed offsets of a logical stream:
//   * base = data & ~15; the lead = data - base bytes before the data read
//     as zeros, so every load is an aligned 16-byte word and a view that
//     starts anywhere (a shard's d[HALO:HALO + n], dev[1:n]) is read where
//     it lies;
//   * the body: the whole 16-byte words from base, preceded by `front`
//     virtual zero bytes (never loaded) that make it whole spans of kSpan
//     bytes; then the tail, the last (lead + n) % 16 bytes;
//   * block b owns span b, thread t kSeg bytes of it: its kWords loads and
//     the 32 columns of its weight M_{(kThreads - 1 - t) kSeg} (the
//     advance over the bytes after its segment) are issued before any is
//     used, then slice-by-8 with the tables in shared memory, one product
//     with the weight in registers, and the block XORs the states (warp
//     shuffles, then shared memory). A matrix product is 32 selects and
//     XORs: one precomputed weight a thread in place of up to 8 products
//     (one per set bit of its offset) keeps a 1 MiB call short;
//   * each block writes its state and takes a ticket; the block with the
//     last ticket folds the states the same way: thread t takes states t,
//     t + kThreads, ... (padded at the front with zero states) in Horner
//     steps of M_{kThreads kSpan}, then its weight M_{(kThreads - 1 - t)
//     kSpan}; its last thread meanwhile computes M_n(~init), and thread 0
//     runs the tail bytes and writes crc = ~(raw ^ M_n(~init)).
//
// tabs: uint32, ops/checksum.py _kernel_tables: the slice-by-8 tables
// (8 x 256, _crc_tables), M_{2^k} for k < 64 as 32 columns each (column j
// = the image of bit j), then the two weights of every thread as
// (32, kThreads), column-major so that a warp's loads coalesce: of the
// segment (kSeg bytes) and of the span (kSpan). scratch: uint32, 2 + spans
// entries: the result, the ticket (zeroed here before the launch), one
// state per block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 64;                         // bytes per thread
constexpr int kWords = kSeg / 16;                // 16-byte loads per thread
constexpr int kLogSpan = 14;
constexpr int kLogThreads = 8;
constexpr int64_t kSpan = int64_t(1) << kLogSpan;   // kThreads * kSeg bytes
constexpr int kTab = 8 * 256;
constexpr int kPad = 33;       // shared stride of a matrix: no bank conflict
constexpr int kPow2 = kTab;                    // offsets into tabs
constexpr int kWSeg = kPow2 + 64 * 32;
constexpr int kWSpan = kWSeg + 32 * kThreads;
static_assert(kThreads * kSeg == kSpan, "a span is the block's segments");
static_assert(1 << kLogThreads == kThreads, "kLogThreads");

// M v for a GF(2) matrix of 32 columns (in registers or shared memory).
__device__ __forceinline__ uint32_t apply(const uint32_t* m, uint32_t v) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) acc ^= (0u - ((v >> j) & 1u)) & m[j];
  return acc;
}

// M_len v: one power-of-two shift matrix per set bit of len (pow2 in
// shared memory, kPad words apart).
__device__ uint32_t advance(const uint32_t* pow2, uint32_t v, uint64_t len) {
  while (len && v) {
    v = apply(pow2 + kPad * (__ffsll((long long)len) - 1), v);
    len &= len - 1;
  }
  return v;
}

// Eight bytes, lo then hi (little-endian words), into the raw state c.
__device__ __forceinline__ uint32_t slice8(const uint32_t* t, uint32_t c,
                                           uint32_t lo, uint32_t hi) {
  c ^= lo;
  return t[7 * 256 + (c & 255)] ^ t[6 * 256 + ((c >> 8) & 255)] ^
         t[5 * 256 + ((c >> 16) & 255)] ^ t[4 * 256 + (c >> 24)] ^
         t[3 * 256 + (hi & 255)] ^ t[2 * 256 + ((hi >> 8) & 255)] ^
         t[256 + ((hi >> 16) & 255)] ^ t[hi >> 24];
}

// x with its bytes below `from` (counted from this word's first) zeroed.
__device__ __forceinline__ uint32_t keep_from(uint32_t x, int from) {
  return from <= 0 ? x : from >= 4 ? 0u : x & (0xFFFFFFFFu << (8 * from));
}

// XOR of v over the block; every thread gets it.
__device__ __forceinline__ uint32_t block_xor(uint32_t v, uint32_t* s_w) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v ^= __shfl_xor_sync(0xFFFFFFFFu, v, o);
  if ((threadIdx.x & 31) == 0) s_w[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t r = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) r ^= s_w[w];
  return r;
}

__global__ void __launch_bounds__(kThreads)
crc32_kernel(const uint4* __restrict__ base, int64_t body_words,
             int64_t front, int lead, int tail, uint32_t init, uint64_t n,
             const uint32_t* __restrict__ tabs, uint32_t* states,
             int* ticket, uint32_t* out) {
  __shared__ uint32_t t[kTab];
  __shared__ uint32_t pow2[64 * kPad];
  __shared__ uint32_t s_w[kThreads / 32];
  __shared__ uint32_t s_adv;
  __shared__ int s_last;
  const int tid = threadIdx.x;
  uint32_t wm[32];                // this thread's weight, in registers

  // this thread's first word of the body (negative: a virtual zero word)
  const int64_t w0 =
      ((int64_t)blockIdx.x * kSpan + (int64_t)tid * kSeg - front) >> 4;
  uint4 v[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int64_t w = w0 + i;
    v[i] = w >= 0 ? __ldg(base + w) : make_uint4(0u, 0u, 0u, 0u);
    if (w == 0) {                 // the bytes before the data read as zeros
      v[i].x = keep_from(v[i].x, lead);
      v[i].y = keep_from(v[i].y, lead - 4);
      v[i].z = keep_from(v[i].z, lead - 8);
      v[i].w = keep_from(v[i].w, lead - 12);
    }
  }
#pragma unroll
  for (int j = 0; j < 32; ++j)
    wm[j] = __ldg(tabs + kWSeg + j * kThreads + tid);
  for (int i = tid; i < kTab; i += kThreads) t[i] = __ldg(tabs + i);
  __syncthreads();

  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    c = slice8(t, c, v[i].x, v[i].y);
    c = slice8(t, c, v[i].z, v[i].w);
  }
  const uint32_t span = block_xor(apply(wm, c), s_w);
  if (tid == 0) {
    states[blockIdx.x] = span;
    __threadfence();
    s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block: fold the span states
#pragma unroll
  for (int j = 0; j < 32; ++j)
    wm[j] = __ldg(tabs + kWSpan + j * kThreads + tid);
  for (int i = tid; i < 64 * 32; i += kThreads)
    pow2[(i >> 5) * kPad + (i & 31)] = __ldg(tabs + kPow2 + i);
  const int spans = (int)gridDim.x;
  const int g = (spans + kThreads - 1) / kThreads;
  const int pad = g * kThreads - spans;       // leading zero states
  uint32_t acc = 0;
  if (g == 1) {
    if (tid >= pad) acc = __ldcg(states + tid - pad);
    __syncthreads();
  } else {
    __syncthreads();
    const uint32_t* step = pow2 + kPad * (kLogSpan + kLogThreads);
    for (int i = 0; i < g; ++i) {
      const int j = i * kThreads + tid - pad;
      if (acc) acc = apply(step, acc);
      if (j >= 0) acc ^= __ldcg(states + j);
    }
  }
  if (tid == kThreads - 1) s_adv = advance(pow2, ~init, n);
  uint32_t raw = block_xor(apply(wm, acc), s_w);
  if (tid == 0) {
    const uint8_t* rest =
        reinterpret_cast<const uint8_t*>(base) + body_words * 16;
    for (int k = 0; k < tail; ++k) {
      const uint32_t b = body_words * 16 + k < lead ? 0u : rest[k];
      raw = t[(raw ^ b) & 255] ^ (raw >> 8);
    }
    out[0] = ~(raw ^ s_adv);
  }
}

}  // namespace

// crc32 of the n > 0 bytes at data, chained from init, into scratch[0].
// spans must be the count the caller allocated scratch for (checked).
extern "C" int jd_crc32(const void* data, int64_t n, uint32_t init,
                        const void* tabs, void* scratch, int64_t spans,
                        void* stream) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(data);
  const int lead = (int)(p & 15);
  const int64_t body = ((int64_t)lead + n) & ~(int64_t)15;
  const int64_t want = body > 0 ? (body + kSpan - 1) / kSpan : 1;
  if (n <= 0 || spans != want || spans > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* sc = (uint32_t*)scratch;
  cudaError_t e = cudaMemsetAsync(sc + 1, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  crc32_kernel<<<(unsigned)spans, kThreads, 0, s>>>(
      reinterpret_cast<const uint4*>(p - lead), body >> 4,
      spans * kSpan - body, lead, (int)(((int64_t)lead + n) & 15), init,
      (uint64_t)n, (const uint32_t*)tabs, sc + 2, (int*)(sc + 1), sc);
  return (int)cudaGetLastError();
}
