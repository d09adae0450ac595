// Two-queue Huffman code lengths for Hopper (sm_90a): the length-limited
// trees that levels 8-9 cost beside the package-merge ones
// (tree_both), one warp per row.
//
// Replaces no TPU kernel: the JAX package's code_lengths
// (jdeflate_tpu/ops/huffman.py) is XLA. Added because the port's plain
// version (ops/huffman.py::code_lengths_ref) is a Python loop over tiny
// tensors: about 24,000 launches for the (512, 286) literal/length rows of
// a 1 MiB level-9 batch and 2,200 for its (512, 30) distance rows, most of
// the level-9 coding stages' time. Contract: code_lengths_ref, bit for bit,
// for every input (tied keys, weights that saturate at _INF, cursors that
// run past the ends).
//
// A row's steps, each the plain version's:
// - keys f > 0 ? f : _INF, ordered stably by (key, symbol): each lane
//   ranks its symbols by counting the smaller keys and the equal keys of
//   smaller symbols;
// - the merge of the m used symbols on lane 0: m - 1 steps, each two picks
//   of the lighter head (the leaf on a tie), the cursors clamped as the
//   plain version's gathers clamp, the sum saturating at _INF;
// - node depths from the root down, on lane 0: a node's parent is the step
//   that took it, a larger index, so one descending pass suffices; only
//   steps t <= m - 2 = root take anything, so no node at or below the root
//   reads one above it, and the pass starts at the root;
// - bl_count of the leaves' depths clamped to max_bits (shared atomics),
//   then on lane 0 the Kraft repair while the excess is positive, within
//   the plain version's n - max_bits - 1 masked steps (a step with no
//   excess changes nothing), and the running sums;
// - each rank's length: torch.searchsorted's binary search (right side)
//   of its slot in the running sums, a lone used symbol paired with the
//   next in order, written back to its symbol.
//
// What bounds it: not bytes (n int64 in and out a row: 2.3 MB for 512 rows
// of 286, under 1 us at 3.35 TB/s) but the merge's and the depth pass's
// chains of dependent shared-memory reads, about 2m of them on one lane.
// All rows of a call run those chains side by side, one warp each, four
// to a block, in one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;                    // rows (warps) per block
constexpr int kMaxN = 288;                  // symbols per row, at most
constexpr int kPer = (kMaxN + 31) / 32;     // symbols per lane
constexpr int kMaxBits = 15;
constexpr long long kInf = 0x3FFFFFFF;      // huffman._INF

struct Row {
  long long wleaf[kMaxN + 1];   // keys by rank, then the _INF pad
  long long node_w[kMaxN];      // node weights (the keys while ranking)
  long long bl[kMaxBits + 1];   // bl_count, then its running sums
  int leaf_par[kMaxN + 1];
  int node_par[kMaxN];
  int depth[kMaxN];
  int order[kMaxN];             // the symbol of each rank
  int cnt[kMaxBits + 1];
};

// torch.searchsorted(cum, v, right=True) on one row: its binary search,
// whether or not the row is sorted
__device__ __forceinline__ int search_right(const long long* cum, int size,
                                           long long v) {
  int lo = 0, hi = size;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(cum[mid] > v))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kRows * 32)
two_queue_kernel(const long long* __restrict__ freqs,
                 long long* __restrict__ out, int G, int n, int max_bits) {
  __shared__ Row rows[kRows];
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kRows + (threadIdx.x >> 5);
  if (g >= G) return;
  Row& s = rows[threadIdx.x >> 5];
  const long long* f = freqs + (int64_t)g * n;

  unsigned used = 0;
  for (int i = lane; i < n; i += 32) {
    const long long v = __ldg(f + i);
    s.node_w[i] = v > 0 ? v : kInf;
    used += v > 0;
  }
  const int m = (int)__reduce_add_sync(0xffffffffu, used);
  if (lane <= kMaxBits) s.cnt[lane] = 0;
  __syncwarp();

  long long key[kPer];
  int rank[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = lane + 32 * e;
    key[e] = i < n ? s.node_w[i] : 0;
    rank[e] = 0;
  }
  for (int j = 0; j < n; ++j) {
    const long long kj = s.node_w[j];
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      rank[e] += kj < key[e] || (kj == key[e] && j < lane + 32 * e);
  }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = lane + 32 * e;
    if (i < n) {
      s.wleaf[rank[e]] = key[e];
      s.order[rank[e]] = i;
    }
  }
  for (int i = lane; i <= n; i += 32) {
    if (i < n) {
      s.node_w[i] = kInf;
      s.node_par[i] = 0;
      s.depth[i] = 0;
    } else {
      s.wleaf[n] = kInf;
    }
    s.leaf_par[i] = 0;
  }
  __syncwarp();

  if (m >= 2) {                      // m is the same on every lane
    if (lane == 0) {
      int li = 0, ni = 0;
      for (int t = 0; t < m - 1; ++t) {
        long long w[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int lc = min(li, n), nc = min(ni, n - 1);
          const long long lw = s.wleaf[lc], nw = s.node_w[nc];
          if (lw <= nw) {
            s.leaf_par[lc] = t;
            ++li;
            w[p] = lw;
          } else {
            s.node_par[nc] = t;
            ++ni;
            w[p] = nw;
          }
        }
        // int64 wraps as torch's does, then saturates
        const long long sum = (long long)((unsigned long long)w[0]
                                          + (unsigned long long)w[1]);
        s.node_w[t] = min(sum, kInf);
      }
      const int root = m - 2;
      s.depth[root] = 0;
      for (int i = root - 1; i >= 0; --i)
        s.depth[i] = s.depth[s.node_par[i]] + 1;
    }
    __syncwarp();
    for (int r = lane; r < m; r += 32)
      atomicAdd(&s.cnt[min(s.depth[s.leaf_par[r]] + 1, max_bits)], 1);
    __syncwarp();
    if (lane == 0) {
      long long excess = -(1LL << max_bits);
      for (int b = 0; b <= max_bits; ++b) {
        s.bl[b] = s.cnt[b];
        excess += (long long)s.cnt[b] << (max_bits - b);
      }
      for (int step = n - max_bits - 1; step > 0 && excess > 0;
           --step, --excess) {
        int b = 0;
        for (int c = max_bits - 1; c > 0; --c)
          if (s.bl[c] > 0) {
            b = c;
            break;
          }
        s.bl[b] -= 1;
        s.bl[b + 1] += 2;
        s.bl[max_bits] -= 1;
      }
      long long run = 0;
      for (int b = 0; b <= max_bits; ++b) {
        run += s.bl[b];
        s.bl[b] = run;
      }
    }
    __syncwarp();
  }

  long long* o = out + (int64_t)g * n;
  for (int r = lane; r < n; r += 32) {
    long long len = 0;
    if (m >= 2) {
      if (r < m) len = search_right(s.bl, max_bits + 1, m - 1 - r);
    } else if (m == 1) {
      len = r <= 1;
    }
    o[s.order[r]] = len;
  }
}

}  // namespace

// freqs, out: (G, n) int64, contiguous; out is written at every position.
// 1 <= n <= 288, 1 <= max_bits <= 15.
extern "C" int jd_code_lengths(const void* freqs, void* out, int G, int n,
                               int max_bits, void* stream) {
  if (G <= 0) return 0;
  if (n < 1 || n > kMaxN || max_bits < 1 || max_bits > kMaxBits)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((G + kRows - 1) / kRows);
  two_queue_kernel<<<grid, kRows * 32, 0, (cudaStream_t)stream>>>(
      (const long long*)freqs, (long long*)out, G, n, max_bits);
  return (int)cudaGetLastError();
}
