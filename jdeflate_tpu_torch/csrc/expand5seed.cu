// expand5 seed placement for Hopper (sm_90a): slot seeds -> seed at each
// output position.
//
// Replaces the Pallas kernel jdeflate_tpu/ops/expand5.py::_seed_mm_kernel
// (reached by seed_scatter_mm). Contract: ops/expand5.py::
// seed_scatter_ref in this package. For every slot i with seed16[i] != 0
// and 0 <= off[i] < out_cap: S16[off[i]] = seed16[i]. The caller zeroes S16.
//
// The TPU kernel placed seeds by one-hot matrix products on the MXU over a
// window of two candidate blocks per 4 KiB region (it had no scatter). On
// Hopper a scatter is a plain store: one thread per slot. Valid seeds have
// strictly increasing offsets, so no two write one position; the store is
// an atomicMax all the same, so malformed input (repeated offsets) still
// gives the plain version's max-scatter result. Empty slots (seed 0)
// inherit their lane's running offset and write nothing. The reference's
// window err is computed beside the launch in PyTorch (seed_window_err).
//
// What bounds it: bytes. Each slot's two words are read once (coalesced)
// and each seed written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
seed_kernel(const int* __restrict__ off, const int* __restrict__ seed16,
            int64_t n, int* __restrict__ s16, int64_t out_cap) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = __ldg(seed16 + i);
    const int o = __ldg(off + i);
    if (s != 0 && o >= 0 && o < out_cap) atomicMax(s16 + o, s);
  }
}

}  // namespace

extern "C" int jd_expand5_seed(const void* off, const void* seed16, int64_t n,
                               void* s16, int64_t out_cap, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  seed_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)off, (const int*)seed16, n, (int*)s16, out_cap);
  return (int)cudaGetLastError();
}
