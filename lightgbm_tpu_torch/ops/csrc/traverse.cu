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
// 255 leaves, F=28) the inputs are the (N, F) int32 bins plus a ~5.6 MB
// pack, read once in ~4 us per 65k rows at 3.35 TB/s.  The walk is a chain
// of dependent loads, about N * T * mean-depth of them: node -> feature ->
// bin -> child.  Latency, not bandwidth, is the limit.
//
// What the design does about it (a simple first version):
//   - the TPU kernel's one-hot masked sums are dropped: each lookup is one
//     direct indexed load;
//   - the pack is read as quantize_stack_trees emits it (int16 node arrays,
//     bool flags, uint8 cat bytes, int16/int8 leaves), through the read-only
//     path (__ldg).  The whole pack fits in the 50 MB L2 and one tree's node
//     arrays (~3 KB) stay in L1 while the block's warps walk it;
//   - one thread per row, int32 accumulation in a register.  Many resident
//     warps hide the load latency;
//   - for small batches the tree axis is split over blockIdx.y so that a
//     1-row request still spreads over the SMs; the partial sums are then
//     combined with integer atomicAdd (exact, order-free).  No float
//     atomics, no allocation inside.
// Later work: warp-cooperative walks, tree-major tiling, cp.async staging.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename LeafT>
__global__ void traverse_kernel(
    const int32_t* __restrict__ bins,      // (N, F)
    const int32_t* __restrict__ nan_bins,  // (F,)
    const int16_t* __restrict__ sf,        // (T, M)
    const int16_t* __restrict__ sb,        // (T, M)
    const uint8_t* __restrict__ dl,        // (T, M) bool
    const uint8_t* __restrict__ ic,        // (T, M) bool
    const uint8_t* __restrict__ cat_bits,  // (T, M, BB)
    const int16_t* __restrict__ lc,        // (T, M)
    const int16_t* __restrict__ rc,        // (T, M)
    const LeafT* __restrict__ leaf_q,      // (T, L)
    int32_t* __restrict__ out,             // (N,)
    int64_t n, int f, int t, int m, int bb, int l, int depth,
    int trees_per_block, int split) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int t0 = blockIdx.y * trees_per_block;
  const int t1 = min(t, t0 + trees_per_block);
  const int32_t* brow = bins + row * f;
  int32_t acc = 0;
  for (int ti = t0; ti < t1; ++ti) {
    const int64_t base = (int64_t)ti * m;
    int node = 0;
    int leaf = 0;
    // `depth` is the pack's longest root->leaf hop count, so every row
    // reaches a leaf within it (the Pallas kernel's fixed trip count).
    for (int step = 0; step < depth; ++step) {
      const int64_t k = base + node;
      const int feat = __ldg(sf + k);
      const int col = __ldg(brow + feat);
      bool go_left;
      if (__ldg(ic + k)) {
        const int byte_idx = min(col >> 3, bb - 1);
        const int byte = __ldg(cat_bits + k * bb + byte_idx);
        go_left = ((byte >> (col & 7)) & 1) != 0;
      } else if (col == __ldg(nan_bins + feat)) {
        go_left = __ldg(dl + k) != 0;
      } else {
        go_left = col <= (int)__ldg(sb + k);
      }
      const int nxt = go_left ? (int)__ldg(lc + k) : (int)__ldg(rc + k);
      if (nxt < 0) {
        leaf = ~nxt;
        break;
      }
      node = nxt;
    }
    acc += (int32_t)__ldg(leaf_q + (int64_t)ti * l + leaf);
  }
  if (split > 1) {
    atomicAdd(out + row, acc);
  } else {
    out[row] = acc;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int lgbt_traverse_sums(
    const void* bins, const void* nan_bins, const void* sf, const void* sb,
    const void* dl, const void* ic, const void* cat_bits, const void* lc,
    const void* rc, const void* leaf_q, int leaf_bits, void* out,
    int64_t n, int f, int t, int m, int bb, int l, int depth,
    int trees_per_block, int block_rows, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int split = (t + trees_per_block - 1) / trees_per_block;
  const dim3 grid((unsigned)((n + block_rows - 1) / block_rows),
                  (unsigned)split);
  const dim3 block((unsigned)block_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (leaf_bits == 16) {
    traverse_kernel<int16_t><<<grid, block, 0, s>>>(
        (const int32_t*)bins, (const int32_t*)nan_bins, (const int16_t*)sf,
        (const int16_t*)sb, (const uint8_t*)dl, (const uint8_t*)ic,
        (const uint8_t*)cat_bits, (const int16_t*)lc, (const int16_t*)rc,
        (const int16_t*)leaf_q, (int32_t*)out, n, f, t, m, bb, l, depth,
        trees_per_block, split);
  } else if (leaf_bits == 8) {
    traverse_kernel<int8_t><<<grid, block, 0, s>>>(
        (const int32_t*)bins, (const int32_t*)nan_bins, (const int16_t*)sf,
        (const int16_t*)sb, (const uint8_t*)dl, (const uint8_t*)ic,
        (const uint8_t*)cat_bits, (const int16_t*)lc, (const int16_t*)rc,
        (const int8_t*)leaf_q, (int32_t*)out, n, f, t, m, bb, l, depth,
        trees_per_block, split);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
