// Window-grid Huffman walk for Hopper (sm_90a).
//
// Replaces the Pallas kernel jdeflate_tpu/ops/walk.py::_walk_kernel (reached
// by walk_tpu). Contract: ops/walk.py::walk_windows_ref in this package.
//
// One thread per lane. A lane is one 32-bit window of the stream; it starts
// at the exact anchor bit the index gives and decodes up to 32 symbols with
// canonical arithmetic (15-bit code window, binary search over limt, rank
// into the sorted symbols, base plus extra bits). Its three words w, w+1,
// w+2 are read straight from the stream: neighbouring lanes read
// neighbouring words, so the loads coalesce.
//
// What bounds it: the dependent chain of shared-memory table reads per
// symbol (about ten per match), not bytes. A block of 256 threads lies in
// one 1024-lane pseudo-entry, which shares one tree, so the four 128-entry
// table rows (2 KiB) are loaded once into shared memory. Tokens are staged
// in shared memory and written lane-major (L, 32) with coalesced stores.
//
// Outputs: tok (L, 32) u32 lane-major; meta (L,) i32 packing outlen 0:15,
// cnt 15:21, err|still-active 21, eob 22, exit pos 23:31.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 256;       // threads per block
constexpr int kPE = 1024;         // lanes per pseudo-entry (one tree)
constexpr int kSlots = 32;
constexpr int kSegPad = 8;

__device__ __forceinline__ uint32_t field(uint32_t s0, uint32_t s1,
                                          uint32_t s2, int o, int n) {
  uint32_t a = o < 32 ? s0 : (o < 64 ? s1 : s2);
  uint32_t b = o < 32 ? s1 : (o < 64 ? s2 : 0u);
  int oo = o & 31;
  // a shift by 32 is undefined: oo == 0 takes no high word
  uint32_t lo = (a >> oo) | (oo == 0 ? 0u : (b << (32 - oo)));
  uint32_t mask = n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1u);
  return lo & mask;
}

__device__ __forceinline__ int rev15(int x) {
  x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555);
  x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333);
  x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F);
  x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF);
  return x >> 1;
}

// code length k (0..15; 15 = invalid) by binary search over limt at lim[0..14]
__device__ __forceinline__ int code_len(const int* lim, int c15) {
  int k = 0;
#pragma unroll
  for (int step = 8; step >= 1; step >>= 1) {
    int kk = k + step;
    int t = lim[min(kk - 1, 14)];
    if (kk <= 15 && c15 >= t) k = kk;
  }
  return k;
}

__global__ void __launch_bounds__(kLanes)
walk_kernel(const uint32_t* __restrict__ words, int64_t nwords,
            const int* __restrict__ seg_word0, const int* __restrict__ pe_tab,
            const int* __restrict__ start_rel, const int* __restrict__ t1g,
            const int* __restrict__ t2ag, const int* __restrict__ t2bg,
            const int* __restrict__ t2cg, uint32_t* __restrict__ tok_out,
            int* __restrict__ meta_out) {
  __shared__ int t1[128];
  __shared__ int t2[384];                 // t2a | t2b | t2c
  __shared__ uint32_t stok[kLanes][kSlots + 1];

  const int tid = threadIdx.x;
  const int64_t lane0 = (int64_t)blockIdx.x * kLanes;
  const int64_t lane = lane0 + tid;
  const int pe = (int)(lane0 / kPE);
  const int tab = pe_tab[pe];
  if (tid < 128) {
    t1[tid] = t1g[tab * 128 + tid];
    t2[tid] = t2ag[tab * 128 + tid];
    t2[128 + tid] = t2bg[tab * 128 + tid];
    t2[256 + tid] = t2cg[tab * 128 + tid];
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) stok[tid][s] = 0u;
  __syncthreads();

  const int start = start_rel[lane];
  bool active = start >= 0 && start < 32;
  uint32_t s0 = 0, s1 = 0, s2 = 0;
  if (active) {
    int64_t w = (int64_t)seg_word0[pe] + (lane - (int64_t)pe * kPE);
    s0 = w < nwords ? words[w] : 0u;
    s1 = w + 1 < nwords ? words[w + 1] : 0u;
    s2 = w + 2 < nwords ? words[w + 2] : 0u;
  }
  int pos = active ? start : 0;
  int outlen = 0, cnt = 0;
  bool err = false, eobf = false;

  for (int s = 0; s < kSlots && active; ++s) {
    int c15 = rev15((int)field(s0, s1, s2, pos, 15));
    int k = code_len(t1, c15);
    bool bad = k >= 15;
    int l = min(k + 1, 15);
    int fb = t1[16 + min(k, 14)];
    int sidx = (fb >> 16) + (c15 >> (15 - l)) - (fb & 0xFFFF);
    sidx = min(max(sidx, 0), 287);
    int sym = t2[sidx];
    bool is_eob = !bad && sym == 256;
    bool is_lit = !bad && sym < 256;
    bool is_len = !bad && sym > 256;

    uint32_t tok = 0;
    int nbits = l;
    int ol = 0;
    if (is_lit) {
      tok = (1u << 30) | (uint32_t)sym;
      ol = 1;
    } else if (is_len) {
      int lsym = min(max(sym - 257, 0), 28);
      int lat = t2[256 + 32 + lsym];
      int lext = lat >> 12;
      int o2 = pos + l;
      int length = (lat & 0xFFF) + (int)field(s0, s1, s2, o2, lext);
      if (sym > 285) bad = true;
      int o3 = o2 + lext;
      int c15d = rev15((int)field(s0, s1, s2, o3, 15));
      int kd = code_len(t1 + 32, c15d);
      if (kd >= 15) bad = true;
      int ld = min(kd + 1, 15);
      int dfb = t1[48 + min(kd, 14)];
      int didx = (dfb >> 16) + (c15d >> (15 - ld)) - (dfb & 0xFFFF);
      didx = min(max(didx, 0), 29);
      int dsym = t1[64 + didx];
      if (dsym > 29) bad = true;
      int dat = t1[94 + min(max(dsym, 0), 29)];
      int dext = dat >> 16;
      int dist = (dat & 0xFFFF) + (int)field(s0, s1, s2, o3 + ld, dext);
      nbits = l + lext + ld + dext;
      tok = (2u << 30) | (uint32_t)length | ((uint32_t)(dist - 1) << 9);
      ol = length;
    }
    if (bad) {
      tok = 0;
      ol = 0;
      err = true;
    }
    stok[tid][s] = tok;
    pos += nbits;
    outlen += ol;
    if (!is_eob && !bad) ++cnt;
    if (is_eob) eobf = true;
    active = !is_eob && !bad && pos < 32;
  }
  // a lane still active after 32 symbols decoded sub-1-bit codes: an error
  err = err || active;
  meta_out[lane] = outlen | (cnt << 15) | ((int)err << 21) |
                   ((int)eobf << 22) | (min(pos, 255) << 23);
  __syncthreads();
  uint32_t* dst = tok_out + lane0 * kSlots;
  for (int i = tid; i < kLanes * kSlots; i += kLanes)
    dst[i] = stok[i / kSlots][i % kSlots];
}

}  // namespace

extern "C" int jd_walk(const void* words, const void* seg_word0,
                       const void* pe_tab, const void* start_rel,
                       const void* t1, const void* t2a, const void* t2b,
                       const void* t2c, void* tok, void* meta, int64_t nwords,
                       int npe, void* stream) {
  if (npe <= 0) return 0;
  dim3 grid((unsigned)((int64_t)npe * kPE / kLanes));
  walk_kernel<<<grid, kLanes, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, nwords, (const int*)seg_word0,
      (const int*)pe_tab, (const int*)start_rel, (const int*)t1,
      (const int*)t2a, (const int*)t2b, (const int*)t2c, (uint32_t*)tok,
      (int*)meta);
  return (int)cudaGetLastError();
}
