// Quantized tree-ensemble traversal for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pallas_traverse.py::fused_traverse_call (body
// _traverse_kernel).  For each row it computes the int32 sum over all T
// trees of leaf_q[t, leaf(row, t)], walking each tree exactly as
// models/tree.py::_tree_walk_q does:
//   f = split_feature[node], col = bins[row, f];
//   categorical node: left iff (cat_bits[node, min(col>>3, bb-1)] >> (col&7)) & 1;
//   else the NaN bin (col == nan_bins[f]) follows default_left;
//   else left iff col <= split_bin;
//   a child < 0 is leaf ~child (sentinel degenerate trees: -1 at node 0).
// Integer sums are associative, so the result is bit-for-bit the plain
// version's and the JAX package's whatever order the trees are walked in.
//
// What bounds it on this card: not bytes.  At the serving shape (T=500,
// 255 leaves, F=28) the inputs are the (N, F) int32 bins plus a ~1.5 MB
// walk table, read once in ~3 us per 65k rows at 3.35 TB/s.  The walk is
// a chain of dependent steps, about N * T * mean-depth of them, each a
// node's load, then the row's bin, then a compare: latency and issue.  The
// first design (a thread per row over the pack's int16 / bool node
// arrays through __ldg, blocks of 128 rows) spent five or six loads and
// their address arithmetic a step, the row's bin an L1 round trip: 1.22 ms
// at 65,536 rows and 14.9 ms at 1,048,576 on an H100 80GB HBM3 at 700 W.
//
// What this design does about it:
//   - one node record a step: the pack's walk table
//     (models/tree.py::walk_table, built once per pack) holds each tree's
//     nodes as two int32 words, [feature | default_left << 15 | split_bin
//     << 16 | is_cat << 31] and [left child | right child << 16], then its
//     leaf quanta widened to int32 (int16 and int8 packs alike): one 8-byte
//     load (through L1, where a block's trees stay) where there were five
//     or six;
//   - a block of 256 rows that walks many trees (16 or more:
//     ops/traverse.py::launch_shape) first copies its rows' bins, at an
//     odd stride, and the NaN bins into shared memory, so the step's second
//     load is a shared-memory read;
//   - a small request still spreads over the SMs: the tree axis is split
//     over blockIdx.y until there are 32 blocks an SM, and the partial sums
//     meet through integer atomicAdd into the zeroed output (exact,
//     order-free).
// Timed on an H100 80GB HBM3 at 700 W (tools/torch_kernel_ab.py against
// the first design, device ms a launch, int16 pack): 65,536 rows 1.22 ->
// 0.57, 1,048,576 rows 14.8 -> 8.65, 4,096 rows 0.089 -> 0.043, one row
// 0.0071 -> 0.0050; the rows' bins read from global memory instead: 0.59
// and 11.3.  Tried in design builds and not kept, slower at every size:
// tree-major tiling (a group of trees' tables staged in shared memory with
// cp.async, the next in flight: a barrier per group, and every block's
// copy of every tree) and 2 or 4 rows a thread.
// Categorical masks stay in global memory: categorical nodes are rare.
// No float atomics, no allocation inside.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Grid (ceil(n / kThreads), ceil(t / trees_per_block)), kThreads threads,
// a thread per row.  `table` is (T, words) int32: a tree's mp node records
// (2 words each), then its leaves.  With kRowsStaged the block first
// copies its rows' bins (at an odd stride: no bank conflicts between
// lanes reading one feature) and the NaN bins into dynamic shared memory,
// kThreads * (f | 1) + f int32.
template <bool kRowsStaged>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(const int32_t* __restrict__ bins,      // (N, F)
                const int32_t* __restrict__ nan_bins,  // (F,)
                const int32_t* __restrict__ table,     // (T, words)
                const uint8_t* __restrict__ cat_bits,  // (T, M, BB)
                int32_t* __restrict__ out,             // (N,)
                int64_t n, int f, int t, int m, int bb, int words, int mp,
                int depth, int trees_per_block, int split) {
  extern __shared__ int32_t s_rows[];
  const int64_t base = (int64_t)blockIdx.x * kThreads;
  const int64_t row = base + threadIdx.x;
  const int t0 = blockIdx.y * trees_per_block;
  const int t1 = min(t, t0 + trees_per_block);
  const int stride = f | 1;
  const int32_t* brow = bins + row * f;
  const int32_t* nanb = nan_bins;
  if (kRowsStaged) {
    const int rows = (int)min((int64_t)kThreads, n - base);
    int32_t* s_nan = s_rows + kThreads * stride;
    for (int i = threadIdx.x; i < rows * f; i += kThreads) {
      const int r = i / f;
      s_rows[r * stride + (i - r * f)] = __ldg(bins + base * f + i);
    }
    for (int j = threadIdx.x; j < f; j += kThreads)
      s_nan[j] = __ldg(nan_bins + j);
    __syncthreads();
    brow = s_rows + threadIdx.x * stride;
    nanb = s_nan;
  }
  if (row >= n) return;
  int32_t acc = 0;
  for (int ti = t0; ti < t1; ++ti) {
    const int32_t* tab = table + (int64_t)ti * words;
    const int2* recs = reinterpret_cast<const int2*>(tab);
    const uint8_t* cats = cat_bits + (int64_t)ti * m * bb;
    int node = 0;
    int leaf = 0;
    // `depth` is the pack's longest root->leaf hop count, so every row
    // reaches a leaf within it (the Pallas kernel's fixed trip count).
    for (int step = 0; step < depth; ++step) {
      const int2 rec = __ldg(recs + node);
      const int feat = rec.x & 0x7fff;
      const int col = kRowsStaged ? brow[feat] : __ldg(brow + feat);
      const int nan_bin = kRowsStaged ? nanb[feat] : __ldg(nanb + feat);
      bool go_left;
      if (rec.x < 0) {                     // is_cat, bit 31
        const int byte =
            __ldg(cats + (int64_t)node * bb + min(col >> 3, bb - 1));
        go_left = ((byte >> (col & 7)) & 1) != 0;
      } else if (col == nan_bin) {
        go_left = ((rec.x >> 15) & 1) != 0;
      } else {
        go_left = col <= ((rec.x >> 16) & 0x7fff);
      }
      // the children are the int16 halves of the second word
      const int nxt =
          go_left ? (int)(int16_t)(rec.y & 0xffff) : (rec.y >> 16);
      if (nxt < 0) {
        leaf = ~nxt;
        break;
      }
      node = nxt;
    }
    acc += __ldg(tab + 2 * mp + leaf);
  }
  if (split > 1) {
    atomicAdd(out + row, acc);
  } else {
    out[row] = acc;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns the first CUDA error.  `table` is the pack's
// (T, words) int32 walk table (mp node records, then the leaves; words a
// multiple of 4, the table 16-byte aligned); with `stage_rows` each block
// copies its rows' bins to shared memory first; `out` is zeroed by the
// caller where the tree axis is split.
extern "C" int lgbt_traverse_table(
    const void* bins, const void* nan_bins, const void* table,
    const void* cat_bits, void* out, int64_t n, int f, int t, int m, int bb,
    int words, int mp, int depth, int trees_per_block, int stage_rows,
    void* stream) {
  if (n <= 0 || t <= 0) return (int)cudaSuccess;
  if (words % 4 != 0 || ((uintptr_t)table & 15) != 0 ||
      trees_per_block < 1 || 2 * mp + 1 > words)
    return (int)cudaErrorInvalidValue;
  const int split = (t + trees_per_block - 1) / trees_per_block;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* b = (const int32_t*)bins;
  const int32_t* nb = (const int32_t*)nan_bins;
  const int32_t* tab = (const int32_t*)table;
  const uint8_t* cb = (const uint8_t*)cat_bits;
  int32_t* o = (int32_t*)out;
  if (stage_rows) {
    // at most 48 KB (ops/traverse.py::ROW_STAGE_BYTES): no opt-in
    const int smem = (kThreads * (f | 1) + f) * (int)sizeof(int32_t);
    traverse_kernel<true><<<grid, kThreads, smem, s>>>(
        b, nb, tab, cb, o, n, f, t, m, bb, words, mp, depth, trees_per_block,
        split);
  } else {
    traverse_kernel<false><<<grid, kThreads, 0, s>>>(
        b, nb, tab, cb, o, n, f, t, m, bb, words, mp, depth, trees_per_block,
        split);
  }
  return (int)cudaGetLastError();
}
