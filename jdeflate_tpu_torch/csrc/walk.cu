// Window-grid Huffman walk for Hopper (sm_90a), with the decode's checks in
// its epilogue.
//
// Replaces the Pallas kernel jdeflate_tpu/ops/walk.py::_walk_kernel (reached
// by walk_tpu) and the checks the JAX program runs right after it
// (jdeflate_tpu/codec/inflate.py, _decode_batch_windows_impl: the exit
// chain, the lane offsets and the far-offset check). Contract:
// ops/walk.py::walk_checked_ref in this package.
//
// One thread per lane. A lane is one 32-bit window of the stream; it starts
// at the exact anchor bit the index gives and decodes up to 32 symbols with
// canonical arithmetic (15-bit code window, binary search over limt, rank
// into the sorted symbols, base plus extra bits). Its three words w, w+1,
// w+2 are read straight from the stream: neighbouring lanes read
// neighbouring words, so the loads coalesce. A block of 256 threads lies in
// one 1024-lane pseudo-entry, which shares one tree, so the four 128-entry
// table rows (2 KiB) are loaded once into shared memory. Tokens are staged
// in shared memory (33 KiB; six blocks still fit on an SM, so registers,
// not the staging, cap residency) and written lane-major with coalesced
// stores.
//
// The epilogue, per lane:
//   * outlen: the bytes its tokens produce;
//   * laneoff: the exclusive scan of outlen over the batch. Blocks take
//     their lanes in the order of an atomic ticket and scan in one pass
//     with decoupled look-back: a block publishes its total, then warp 0
//     reads 32 predecessors' states at a time until it meets one holding
//     an inclusive prefix. Every predecessor holds a lower ticket, so it
//     is running and publishes its total without waiting: no deadlock,
//     whatever order the blocks are launched in;
//   * the exit chain: a lane's exit bit must be the next anchor, the first
//     later active anchor of its pseudo-entry or else, when the next
//     pseudo-entry has the same tree, that one's first anchor. All of it is
//     input, so a block reads the rest of its pseudo-entry's anchors (and
//     the next one's) itself and never waits on another block. Anchors are
//     counted on the pe_word0 base (clamped at 0), the words are read from
//     seg_word0 (clamped into the window): the two differ where a segment
//     clamps, and the check then fails, as in the reference;
//   * far offsets: a match may not reach before the history, hist = meta[1]
//     read on the device;
//   * err: lane errors + broken chain links + far matches, summed per block
//     and added with one atomicAdd (an exact integer in any order).
//
// What bounds it: the dependent chain of shared-memory table reads per
// symbol (about ten per match), then the bytes of the token plane. The
// epilogue adds a look-back of a few L2 round trips.
//
// Outputs: tok (L, 32) u32 lane-major; meta (L,) i32 packing outlen 0:15,
// cnt 15:21, err|still-active 21, eob 22, exit pos 23:31; outlen (L,) i32;
// laneoff (L,) i64; sync[1] the err count.
//
// sync: int32, zeroed, 2 + 2 * blocks entries: the ticket, the err count,
// then one 64-bit look-back state per block (flag in bits 62:64: 1 the
// block's total, 2 its inclusive prefix; the value in 0:62).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 256;       // threads per block
constexpr int kWarps = kLanes / 32;
constexpr int kPE = 1024;         // lanes per pseudo-entry (one tree)
constexpr int kSlots = 32;
constexpr int kBig = 1 << 29;     // "no next anchor"
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kTotal = 1ull << 62;
constexpr uint64_t kPrefix = 2ull << 62;
constexpr uint64_t kValue = (1ull << 62) - 1;

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

// lane j of a pseudo-entry at word pw0: its bit on the anchor base plus
// `bit` (i32 arithmetic wrapping as in the reference)
__device__ __forceinline__ int lane_bit(int pw0, int j, int bit) {
  return (int)(((unsigned)max(pw0, 0) + (unsigned)j) * 32u + (unsigned)bit);
}

__device__ __forceinline__ int anchor(int start, int pw0, int j) {
  return start >= 0 ? lane_bit(pw0, j, start) : kBig;
}

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int d = 16; d; d >>= 1) v = min(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

__global__ void __launch_bounds__(kLanes)
walk_kernel(const uint32_t* __restrict__ words, int64_t nwords,
            const int* __restrict__ seg_word0,
            const int* __restrict__ pe_word0, const int* __restrict__ pe_tab,
            const int* __restrict__ start_rel, const int* __restrict__ hist,
            const int* __restrict__ t1g, const int* __restrict__ t2ag,
            const int* __restrict__ t2bg, const int* __restrict__ t2cg,
            int npe, uint32_t* __restrict__ tok_out,
            int* __restrict__ meta_out, int* __restrict__ outlen_out,
            int64_t* __restrict__ laneoff_out, int* sync) {
  __shared__ int t1[128];
  __shared__ int t2[384];                 // t2a | t2b | t2c
  __shared__ uint32_t stok[kLanes][kSlots + 1];
  __shared__ int s_blk;
  __shared__ int s_len[kWarps], s_min[kWarps], s_rest[kWarps], s_err[kWarps];
  __shared__ long long s_prefix;

  int* ticket = sync;
  int* err_out = sync + 1;
  uint64_t* state = reinterpret_cast<uint64_t*>(sync + 2);

  const int tid = threadIdx.x;
  const int wid = tid >> 5, ln = tid & 31;
  if (tid == 0) s_blk = atomicAdd(ticket, 1);
  __syncthreads();
  const int blk = s_blk;
  const int64_t lane0 = (int64_t)blk * kLanes;
  const int64_t lane = lane0 + tid;
  const int pe = (int)(lane0 / kPE);
  const int j = (int)(lane - (int64_t)pe * kPE);
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
    int64_t w = (int64_t)seg_word0[pe] + j;
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
  outlen_out[lane] = outlen;

  // the block's scan of outlen: this lane's offset in the block, the total
  int incl = outlen;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (ln >= d) incl += v;
  }
  if (ln == 31) s_len[wid] = incl;
  // the exit chain's next anchor among this warp's later lanes
  const int pw0 = pe_word0[pe];
  int suf = anchor(start, pw0, j);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_down_sync(kFull, suf, d);
    if (ln + d < 32) suf = min(suf, v);
  }
  int nxt = __shfl_down_sync(kFull, suf, 1);
  if (ln == 31) nxt = kBig;
  if (ln == 0) s_min[wid] = suf;
  // ... and past this block: the later lanes of the pseudo-entry, then the
  // next pseudo-entry's anchors when it shares the tree (its head)
  const bool same_next = pe + 1 < npe && pe_tab[pe + 1] == tab;
  const int64_t rest_end = (int64_t)(pe + (same_next ? 2 : 1)) * kPE;
  int rest = kBig;
  for (int64_t i = lane0 + kLanes + tid; i < rest_end; i += kLanes) {
    const int q = (int)(i / kPE);
    rest = min(rest, anchor(start_rel[i], pe_word0[q],
                            (int)(i - (int64_t)q * kPE)));
  }
  rest = warp_min(rest);
  if (ln == 0) s_rest[wid] = rest;
  __syncthreads();

  // tokens out, coalesced, while the block total goes out for the scan
  uint32_t* dst = tok_out + lane0 * kSlots;
  for (int i = tid; i < kLanes * kSlots; i += kLanes)
    dst[i] = stok[i / kSlots][i % kSlots];
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = s_len[w];
    before += w < wid ? v : 0;
    total += v;
    if (w > wid) nxt = min(nxt, s_min[w]);
    nxt = min(nxt, s_rest[w]);
  }
  if (tid == 0)
    st_release(state + blk, (blk == 0 ? kPrefix : kTotal) | (uint64_t)total);
  const bool chain_bad = start >= 0 && !eobf && lane_bit(pw0, j, pos) != nxt;

  // look-back: the sum of every earlier block's lanes
  if (wid == 0) {
    long long excl = 0;
    if (blk > 0) {
      for (int look = blk - 1;; look -= 32) {
        const int idx = look - ln;
        uint64_t s;
        do {
          s = idx >= 0 ? ld_acquire(state + idx) : kPrefix;
        } while (!__all_sync(kFull, (s >> 62) != 0));
        const unsigned pre = __ballot_sync(kFull, (s >> 62) == 2);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        long long v = ln <= stop ? (long long)(s & kValue) : 0;
#pragma unroll
        for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
        excl += v;
        if (pre) break;
      }
      if (ln == 0)
        st_release(state + blk, kPrefix | (uint64_t)(excl + total));
    }
    if (ln == 0) s_prefix = excl;
  }
  __syncthreads();
  const long long off = s_prefix + before + incl - outlen;
  laneoff_out[lane] = off;

  // far offsets: a match reaching before the history
  const long long h = *hist;
  long long run = off;
  int far = 0;
#pragma unroll 4
  for (int s = 0; s < kSlots; ++s) {
    const uint32_t t = stok[tid][s];
    const uint32_t kind = t >> 30;
    if (kind == 2u) {
      far += (long long)((t >> 9) & 0x7FFF) + 1 > run + h;
      run += t & 0x1FF;
    } else if (kind == 1u) {
      run += 1;
    }
  }
  const int e = warp_sum((int)err + (int)chain_bad + far);
  if (ln == 0) s_err[wid] = e;
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_err[w];
    if (sum) atomicAdd(err_out, sum);
  }
}

}  // namespace

extern "C" int jd_walk(const void* words, const void* seg_word0,
                       const void* pe_word0, const void* pe_tab,
                       const void* start_rel, const void* hist,
                       const void* t1, const void* t2a, const void* t2b,
                       const void* t2c, void* tok, void* meta, void* outlen,
                       void* laneoff, void* sync, int64_t nwords, int npe,
                       void* stream) {
  if (npe <= 0) return 0;
  dim3 grid((unsigned)((int64_t)npe * kPE / kLanes));
  walk_kernel<<<grid, kLanes, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, nwords, (const int*)seg_word0,
      (const int*)pe_word0, (const int*)pe_tab, (const int*)start_rel,
      (const int*)hist, (const int*)t1, (const int*)t2a, (const int*)t2b,
      (const int*)t2c, npe, (uint32_t*)tok, (int*)meta, (int*)outlen,
      (int64_t*)laneoff, (int*)sync);
  return (int)cudaGetLastError();
}
