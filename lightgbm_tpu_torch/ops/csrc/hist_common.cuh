// Shared device code of the histogram kernel (histogram.cu) and the wave
// kernel (wave.cu): the row-chunk accumulation and the combine.
//
//   out[f, b, c] = sum_n vals[n, c] * [bins[n, f] == b]
//
// f32 mode: no float atomics.  Rows are cut into chunks of `chunk_rows`;
// each block owns one chunk and kFeatPerBlock features and writes that
// chunk's partial histogram to global scratch.  A second kernel sums the
// partials of each cell in chunk order.  Every sum is therefore taken in
// the same order on every run: within a chunk in row order, across chunks
// in chunk order.
//
// int8 mode (quantized training): int8 values, int32 sums.  Integer sums
// do not depend on their order, so each block accumulates its chunk into
// a block-private int32 histogram in shared memory with atomicAdd and
// flushes it with one global atomicAdd per nonzero cell.
//
// bf16 values (kVal = __nv_bfloat16) and 4-bit bins (kPacked) are
// template parameters of the loaders only.  A bf16 value is widened to
// f32 as it is staged (exact), and the accumulation loop is the f32 one,
// so a bf16 launch gives the bits of an f32 launch on the bf16-rounded
// values.  Packed bins are (N, ceil(F/2)) bytes, feature 2j in the low
// nibble of byte j and 2j+1 in the high one; a block's feature group
// starts on an even feature, so no byte straddles two groups, and the
// loader writes the same per-feature bin ids the unpacked loader writes:
// the packed kernel's sums are the unpacked kernel's, add for add.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
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

// The segment of a chunk in a multi-segment launch: the last segment whose
// first chunk is <= `chunk` (empty segments share their first chunk with
// the next one, which then wins).
__device__ __forceinline__ int segment_of(const int32_t* seg, int w_count,
                                          int chunk) {
  const int32_t* off = seg + 2 * w_count;
  int lo = 0, hi = w_count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Bin id of local feature j of a row whose feature group starts at `row`
// (at feature f0 of the unpacked row, at byte f0 / 2 of a packed one; f0
// is even).
template <bool kPacked>
__device__ __forceinline__ int bin_at(const uint8_t* row, int j) {
  if (kPacked) return (row[j >> 1] >> ((j & 1) << 2)) & 15;
  return row[j];
}

// Bytes per row of the bin matrix and the start of feature f0's group.
template <bool kPacked>
__device__ __forceinline__ const uint8_t* group_row(const uint8_t* bins,
                                                    int64_t row, int f,
                                                    int f0) {
  if (kPacked) return bins + row * ((f + 1) >> 1) + (f0 >> 1);
  return bins + row * f + f0;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Segment table of a multi-segment launch (device int32, 3W + 1 entries):
//   seg[w]          first perm position of segment w
//   seg[W + w]      its row count
//   seg[2W + w]     its first chunk; seg[3W] is the total chunk count.
// With seg == nullptr there is one segment: rows [0, single_cnt) in
// storage order (no perm).  `f` is the real feature count; kVal is float
// or __nv_bfloat16.
template <bool kPerm, bool kPacked, typename kVal>
__global__ void __launch_bounds__(kThreads)
hist_accumulate_kernel(const uint8_t* __restrict__ bins, int f,
                       const kVal* __restrict__ vals,
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
    const int lo = segment_of(seg, w_count, chunk);
    start = seg[lo];
    cnt = seg[w_count + lo];
    local = chunk - seg[2 * w_count + lo];
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
      const uint8_t* src = group_row<kPacked>(bins, row, f, f0);
#pragma unroll
      for (int j = 0; j < kFeatPerBlock; ++j)
        s_bins[threadIdx.x * kFeatPerBlock + j] =
            j < nf ? (uint8_t)bin_at<kPacked>(src, j) : 0;
      s_vals[threadIdx.x * 3 + 0] = to_f32(vals[row * 3 + 0]);
      s_vals[threadIdx.x * 3 + 1] = to_f32(vals[row * 3 + 1]);
      s_vals[threadIdx.x * 3 + 2] = to_f32(vals[row * 3 + 2]);
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

// Launches the f32 / bf16 accumulation of `packed` or unpacked bins:
// grid (nchunks, ceil(f / kFeatPerBlock)).  Returns cudaGetLastError().
template <bool kPerm>
inline int launch_accumulate(const void* bins, int f, const void* vals,
                             bool packed, bool bf16, const int32_t* perm,
                             const int32_t* seg, int w_count,
                             int64_t single_cnt, int chunk_rows, int nbins,
                             int nchunks, float* partial, cudaStream_t s) {
  const dim3 grid((unsigned)nchunks,
                  (unsigned)((f + kFeatPerBlock - 1) / kFeatPerBlock));
  const uint8_t* b = (const uint8_t*)bins;
#define LGBT_ACC(P, V)                                                    \
  hist_accumulate_kernel<kPerm, P, V><<<grid, kThreads, 0, s>>>(          \
      b, f, (const V*)vals, perm, seg, w_count, single_cnt, chunk_rows,   \
      nbins, partial)
  if (packed && bf16) LGBT_ACC(true, __nv_bfloat16);
  else if (packed) LGBT_ACC(true, float);
  else if (bf16) LGBT_ACC(false, __nv_bfloat16);
  else LGBT_ACC(false, float);
#undef LGBT_ACC
  return (int)cudaGetLastError();
}

// int8 mode, threads per block.
constexpr int kI8Threads = 512;

// int8 mode accumulation.  Grid (chunks, feature groups of
// `feat_per_block`, even under kPacked); dynamic shared memory of
// feat_per_block * nbins * 3 int32.  `vals` is (N, 3) int8; `out` is
// (segments, f, nbins, 3) int32, zeroed by the caller.  A bin >= nbins
// is dropped.
template <bool kPerm, bool kPacked>
__global__ void __launch_bounds__(kI8Threads)
hist_accumulate_i8_kernel(const uint8_t* __restrict__ bins, int f,
                          const int8_t* __restrict__ vals,
                          const int32_t* __restrict__ perm,
                          const int32_t* __restrict__ seg, int w_count,
                          int64_t single_cnt, int chunk_rows, int nbins,
                          int feat_per_block, int32_t* __restrict__ out) {
  extern __shared__ int32_t s_hist[];
  const int chunk = blockIdx.x;
  int64_t start = 0;
  int64_t cnt = single_cnt;
  int local = chunk;
  int w = 0;
  if (seg != nullptr) {
    w = segment_of(seg, w_count, chunk);
    start = seg[w];
    cnt = seg[w_count + w];
    local = chunk - seg[2 * w_count + w];
  }
  const int64_t r0 = (int64_t)local * chunk_rows;
  const int64_t r1 = min(cnt, r0 + (int64_t)chunk_rows);
  const int f0 = blockIdx.y * feat_per_block;
  const int nf = min(feat_per_block, f - f0);
  const int cells = nf * nbins * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  for (int64_t i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    const int64_t pos = start + i;
    const int64_t row = kPerm ? (int64_t)perm[pos] : pos;
    const int8_t* v = vals + row * 3;
    const int g = v[0], h = v[1], c = v[2];
    if ((g | h | c) == 0) continue;
    const uint8_t* src = group_row<kPacked>(bins, row, f, f0);
    for (int j = 0; j < nf; ++j) {
      const int b = bin_at<kPacked>(src, j);
      if (b >= nbins) continue;
      int32_t* cell = s_hist + (j * nbins + b) * 3;
      if (g != 0) atomicAdd(cell + 0, g);
      if (h != 0) atomicAdd(cell + 1, h);
      if (c != 0) atomicAdd(cell + 2, c);
    }
  }
  __syncthreads();
  int32_t* dst = out + ((int64_t)w * f + f0) * nbins * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int32_t v = s_hist[i];
    if (v != 0) atomicAdd(dst + i, v);
  }
}

// int8 mode: features per block whose int32 histogram fits the shared
// memory budget (above 48 KB a block must opt in), and that opt-in.
constexpr int kI8SmemBudget = 96 * 1024;

// Under packed bins a group must start on an even feature (a byte holds
// features 2j and 2j + 1), so a group that does not cover every feature
// is rounded down to even.
inline int i8_feat_per_block(int f, int nbins, bool packed) {
  const int fit = kI8SmemBudget / (nbins * 3 * (int)sizeof(int32_t));
  if (fit >= f) return f;
  if (!packed) return fit < 1 ? 1 : fit;
  return fit < 2 ? 2 : (fit & ~1);
}

template <typename Kernel>
inline int i8_smem_opt_in(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Launches the int8 accumulation of `packed` or unpacked bins into `out`
// (zeroed by the caller).  Returns the first CUDA error.
template <bool kPerm>
inline int launch_accumulate_i8(const void* bins, int f, const void* vals,
                                bool packed, const int32_t* perm,
                                const int32_t* seg, int w_count,
                                int64_t single_cnt, int chunk_rows,
                                int nbins, int nchunks, int32_t* out,
                                cudaStream_t s) {
  const int fpb = i8_feat_per_block(f, nbins, packed);
  const int smem = fpb * nbins * 3 * (int)sizeof(int32_t);
  const dim3 grid((unsigned)nchunks, (unsigned)((f + fpb - 1) / fpb));
  const uint8_t* b = (const uint8_t*)bins;
  const int8_t* v = (const int8_t*)vals;
  int err;
  if (packed) {
    err = i8_smem_opt_in(hist_accumulate_i8_kernel<kPerm, true>, smem);
    if (err != 0) return err;
    hist_accumulate_i8_kernel<kPerm, true><<<grid, kI8Threads, smem, s>>>(
        b, f, v, perm, seg, w_count, single_cnt, chunk_rows, nbins, fpb,
        out);
  } else {
    err = i8_smem_opt_in(hist_accumulate_i8_kernel<kPerm, false>, smem);
    if (err != 0) return err;
    hist_accumulate_i8_kernel<kPerm, false><<<grid, kI8Threads, smem, s>>>(
        b, f, v, perm, seg, w_count, single_cnt, chunk_rows, nbins, fpb,
        out);
  }
  return (int)cudaGetLastError();
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
