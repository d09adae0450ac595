// expand5 resolve for Hopper (sm_90a): per-position plan -> output bytes.
//
// Replaces the Pallas kernel jdeflate_tpu/ops/expand5.py::_resolve_kernel
// (reached by resolve_tpu). Contract: ops/expand5.py::resolve_ref in this
// package. P[p] is position p's plan pack (bit 25 valid, bit 24 literal;
// literal byte in 0:8; match dist-1 in 0:15 and phase in 15:24). A literal
// position takes its byte, a match position the byte at its collapsed
// source src = p - phase - d + phase % d (always before the match; negative
// reads the 32 KiB halo), an invalid position 0.
//
// The output is one dependency chain: a position may read any byte of the
// last 32 KiB. So ONE thread block walks the batch's output in 2 KiB steps,
// in order, and no step is split across blocks. Inside a step:
//   1. every position loads its plan; literals are staged in shared memory;
//      each match points at its source, every other position at itself;
//   2. pointer doubling grounds the chains inside the step: a pointer into
//      the step jumps to that position's pointer, so after at most
//      log2(2048) = 11 rounds it is either before the step (a final byte,
//      written by an earlier step) or a literal/invalid position of the
//      step (a staged value);
//   3. every position gathers its byte from there and writes it.
// This is the TPU kernel's algorithm without its MXU one-hot gathers: Hopper
// has real gathers, and the step's pointers live in shared memory.
//
// What bounds it: latency. Each step costs a few block-wide barriers and
// dependent reads, and the 2 KiB steps run one after another on one SM,
// while the byte bound (read P once, write the output once) is a few
// microseconds. Spreading independent steps over SMs is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHalo = 32768;
constexpr int kStep = 2048;
constexpr int kThreads = 1024;
constexpr int kPer = kStep / kThreads;   // positions per thread
constexpr int kRounds = 11;              // log2(kStep)
constexpr int kValid = 1 << 25;
constexpr int kLit = 1 << 24;

__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int* __restrict__ P, const uint8_t* __restrict__ halo,
               uint8_t* out, int out_cap) {
  __shared__ int ptr[kStep];
  __shared__ uint8_t val[kStep];
  const int t = threadIdx.x;
  for (int sbase = 0; sbase < out_cap; sbase += kStep) {
    int kind[kPer];            // 0 invalid, 1 literal, 2 match
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = t + k * kThreads;
      const int p = sbase + j;
      const int pv = p < out_cap ? __ldg(P + p) : 0;
      const bool valid = (pv & kValid) != 0;
      const bool lit = valid && (pv & kLit) != 0;
      kind[k] = valid ? (lit ? 1 : 2) : 0;
      int cur = p;
      if (kind[k] == 2) {
        const int d = (pv & 0x7FFF) + 1;
        const int phase = (pv >> 15) & 0x1FF;
        cur = p - phase - d + phase % d;
      }
      ptr[j] = cur;
      val[j] = lit ? (uint8_t)(pv & 0xFF) : 0;
    }
    __syncthreads();
    for (int r = 0; r < kRounds; ++r) {
      int nxt[kPer];
      int changed = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int j = t + k * kThreads;
        const int c = ptr[j];
        nxt[k] = c;
        if (c >= sbase && c < sbase + kStep) {
          nxt[k] = ptr[c - sbase];
          changed |= nxt[k] != c;
        }
      }
      // every read of this round happens before any write
      const int any = __syncthreads_or(changed);
#pragma unroll
      for (int k = 0; k < kPer; ++k) ptr[t + k * kThreads] = nxt[k];
      __syncthreads();
      if (!any) break;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = t + k * kThreads;
      const int p = sbase + j;
      if (p >= out_cap) continue;
      uint8_t v = val[j];
      if (kind[k] == 2) {
        const int c = ptr[j];
        if (c >= sbase)
          v = val[min(c - sbase, kStep - 1)];
        else if (c >= 0)
          v = out[c];                   // final: written by an earlier step
        else
          v = c >= -kHalo ? halo[c + kHalo] : 0;
      }
      out[p] = v;
    }
    // this step's bytes are visible to the next step's reads
    __syncthreads();
  }
}

}  // namespace

extern "C" int jd_expand5_resolve(const void* P, const void* halo, void* out,
                                  int64_t out_cap, void* stream) {
  if (out_cap <= 0) return 0;
  if (out_cap > (int64_t)0x7FFFFFFF - kStep) return (int)cudaErrorInvalidValue;
  resolve_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)P, (const uint8_t*)halo, (uint8_t*)out, (int)out_cap);
  return (int)cudaGetLastError();
}
