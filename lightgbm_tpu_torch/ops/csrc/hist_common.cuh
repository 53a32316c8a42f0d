// Shared device code of the histogram kernel (histogram.cu) and the wave
// kernel (wave.cu): the row-chunk accumulation and the fixed-order combine.
//
//   out[f, b, c] = sum_n vals[n, c] * [bins[n, f] == b]
//
// No float atomics.  Rows are cut into chunks of `chunk_rows`; each block
// owns one chunk and kFeatPerBlock features and writes that chunk's
// partial histogram to global scratch.  A second kernel sums the partials
// of each cell in chunk order.  Every sum is therefore taken in the same
// order on every run: within a chunk in row order, across chunks in chunk
// order.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lgbt {
// Internal linkage: both .cu files include this header and are linked
// into one library.
namespace {

// One thread per bin: the bin axis B must be <= kThreads (uint8 bins).
constexpr int kThreads = 256;
// Features per block (grid.y covers ceil(F / kFeatPerBlock) groups).
constexpr int kFeatPerBlock = 8;
// Rows staged in shared memory per step (one loader thread per row).
constexpr int kTileRows = kThreads;

// Segment table of a multi-segment launch (device int32, 3W + 1 entries):
//   seg[w]          first perm position of segment w
//   seg[W + w]      its row count
//   seg[2W + w]     its first chunk; seg[3W] is the total chunk count.
// With seg == nullptr there is one segment: rows [0, single_cnt) in
// storage order (no perm).
template <bool kPerm>
__global__ void __launch_bounds__(kThreads)
hist_accumulate_kernel(const uint8_t* __restrict__ bins, int f,
                       const float* __restrict__ vals,
                       const int32_t* __restrict__ perm,
                       const int32_t* __restrict__ seg, int w_count,
                       int64_t single_cnt, int chunk_rows, int nbins,
                       float* __restrict__ partial) {
  __shared__ uint8_t s_bins[kTileRows * kFeatPerBlock];
  __shared__ float s_vals[kTileRows * 3];
  const int chunk = blockIdx.x;
  int64_t start = 0;
  int64_t cnt = single_cnt;
  int local = chunk;
  if (seg != nullptr) {
    // last segment whose first chunk is <= this chunk (empty segments
    // share their first chunk with the next one, which then wins)
    const int32_t* off = seg + 2 * w_count;
    int lo = 0, hi = w_count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= chunk) lo = mid; else hi = mid - 1;
    }
    start = seg[lo];
    cnt = seg[w_count + lo];
    local = chunk - off[lo];
  }
  const int64_t r0 = (int64_t)local * chunk_rows;
  const int64_t r1 = min(cnt, r0 + (int64_t)chunk_rows);
  const int f0 = blockIdx.y * kFeatPerBlock;
  const int nf = min(kFeatPerBlock, f - f0);
  const int b = threadIdx.x;
  float acc[kFeatPerBlock][3];
#pragma unroll
  for (int j = 0; j < kFeatPerBlock; ++j) {
    acc[j][0] = 0.f; acc[j][1] = 0.f; acc[j][2] = 0.f;
  }
  for (int64_t t0 = r0; t0 < r1; t0 += kTileRows) {
    const int rows = (int)min((int64_t)kTileRows, r1 - t0);
    __syncthreads();                       // the previous tile is consumed
    if (threadIdx.x < rows) {
      const int64_t pos = start + t0 + threadIdx.x;
      const int64_t row = kPerm ? (int64_t)perm[pos] : pos;
      const uint8_t* src = bins + row * f + f0;
#pragma unroll
      for (int j = 0; j < kFeatPerBlock; ++j)
        s_bins[threadIdx.x * kFeatPerBlock + j] = j < nf ? src[j] : 0;
      s_vals[threadIdx.x * 3 + 0] = vals[row * 3 + 0];
      s_vals[threadIdx.x * 3 + 1] = vals[row * 3 + 1];
      s_vals[threadIdx.x * 3 + 2] = vals[row * 3 + 2];
    }
    __syncthreads();
    for (int i = 0; i < rows; ++i) {
      const float g = s_vals[i * 3 + 0];
      const float h = s_vals[i * 3 + 1];
      const float c = s_vals[i * 3 + 2];
#pragma unroll
      for (int j = 0; j < kFeatPerBlock; ++j) {
        if (s_bins[i * kFeatPerBlock + j] == b) {
          acc[j][0] += g; acc[j][1] += h; acc[j][2] += c;
        }
      }
    }
  }
  if (b < nbins) {
    float* dst = partial + (int64_t)chunk * f * nbins * 3;
    for (int j = 0; j < nf; ++j) {
      float* cell = dst + ((int64_t)(f0 + j) * nbins + b) * 3;
      cell[0] = acc[j][0]; cell[1] = acc[j][1]; cell[2] = acc[j][2];
    }
  }
}

// Sums the chunk partials of every cell in chunk order.  With `parent`
// (the wave kernel) the sum is the smaller sibling; the larger sibling is
// parent - smaller, and the pair is written as (left, right) by the
// small_left lane (4) of `stats` (W, 2, 8).  Grid (ceil(cells / 256), W).
__global__ void hist_combine_kernel(const float* __restrict__ partial,
                                    const int32_t* __restrict__ seg,
                                    int w_count, int single_chunks,
                                    int64_t cells,
                                    const float* __restrict__ parent,
                                    const float* __restrict__ stats,
                                    float* __restrict__ out) {
  const int w = blockIdx.y;
  const int64_t cell = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  int c0 = 0, c1 = single_chunks;
  if (seg != nullptr) {
    c0 = seg[2 * w_count + w];
    c1 = seg[2 * w_count + w + 1];
  }
  float s = 0.f;
  for (int k = c0; k < c1; ++k) s += partial[(int64_t)k * cells + cell];
  if (parent == nullptr) {
    out[(int64_t)w * cells + cell] = s;
    return;
  }
  const float big = parent[(int64_t)w * cells + cell] - s;
  const bool small_left = stats[(int64_t)w * 16 + 4] > 0.5f;
  out[((int64_t)w * 2 + 0) * cells + cell] = small_left ? s : big;
  out[((int64_t)w * 2 + 1) * cells + cell] = small_left ? big : s;
}

}  // namespace
}  // namespace lgbt
