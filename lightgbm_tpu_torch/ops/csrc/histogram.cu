// Gradient/hessian histogram for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pallas_histogram.py::histogram_flat (body
// _flat_kernel, contraction pallas_common.py::onehot_contract), every
// mode:
//   out[f, b, c] = sum_n vals[n, c] * [bins[n, f] == b]
// for (N, F) uint8 or uint16 bins and (N, 3) vals (grad, hess, in-bag
// count), out (F, B, 3).  On the training path it builds every root
// histogram (and, unfused, every smaller sibling).  The TPU kernel
// contracts against an in-VMEM one-hot on the MXU because a TPU has no
// atomics; its VMEM tile budget and 128-lane bin padding have no
// counterpart here: the bin axis is the data's own B (<= 256 over uint8
// bins, <= 65,536 over uint16 bins).
//
// f32 mode, (N, 3) f32 values, f32 sums; two launches (hist_common.cuh):
// the accumulation, a block per (row chunk, feature group) with a warp per
// feature's shared-memory histogram (the lanes of one bin are grouped and
// the group's lowest lane adds them in row order), and the combine of the
// chunk partials in chunk order.  What bounds it: issue and latency of
// N * F / 32 warp steps (grouping the lanes, about half of it, then the
// leaders' read-modify-writes in shared memory), then the partials:
// each chunk writes F * B * 3 floats and the combine reads them back (196
// chunks, 16.8 MB at the bench shape).  The function itself needs
// N * (F + 12) bytes (~6 MB at N = 200k, F = 28: ~2 us at 3.35 TB/s) and
// N * F * 3 adds.  The chunking (ops/histogram_flat.py::chunking) fixes
// every sum's order: the same bits on every run, equal to the plain twin
// ops/histogram.py::histogram_chunked on any values.
//
// int8 mode (quantized training; the TPU kernel's dtype="int8", s8 x s8 ->
// s32 on the MXU): (N, 3) int8 values (grad and hess levels, in-bag 0/1),
// out (F, B, 3) int32.  Bound by bytes (N * (F + 3) + F * B * 12: ~6.2
// MB at N = 200k, F = 28, ~1.9 us); what holds it back is issue of the
// shared-memory atomics and, in the first design, blocks too few to fill
// the card.  Integer sums are exact in any order, so each block owns a
// row chunk and a group of 8 features (4 over uint16 bins), one thread
// per row adds its three levels with shared-memory atomicAdd (zero levels
// skipped; lanes start at different features, so rows on one bin meet at
// most 4-fold, 8-fold over uint16 bins), and writes its int32 chunk
// partial; the combine sums the chunks (hist_common.cuh).  The result is
// the same bits on every run.
//
// bf16 mode (the TPU kernel's dtype="bf16": bf16 operands, f32
// accumulation): (N, 3) __nv_bfloat16 values, f32 sums.  The kernel reads
// the bf16 values themselves, so the value bytes a row streams halve (6
// instead of 12); the wrapper rounds f32 values once and the grower builds
// its values in bf16 once per tree.  Each value is widened to f32 as a
// lane reads it and summed by the f32 mode's adds in the same order: a
// bf16 launch gives the bits of an f32 launch on the bf16-rounded values.
//
// packed4 mode (the TPU kernel's packed4=True, any value type): bins are
// (N, ceil(F/2)) bytes of two 4-bit features (feature 2j low nibble, 2j+1
// high), so the bin bytes a row streams halve too.  The lanes read the
// nibbles and get the bin ids the unpacked bytes hold; feature groups
// start on even features.  A packed4 launch gives the bits of the
// unpacked launch on the same rows, in every value type, and at B = 16 a
// lane still adds only its own row (no thread waits on 240 empty bins).
// The TPU kernel's nibble-plane layout and the un-permute after it exist
// for Mosaic's lane rules only: this kernel writes original feature order.

// uint16 bins (max_bin above 255; the TPU kernel takes (N, F) uint16 bins
// at a 128-multiple padded B): every value type above.  f32 and bf16 run
// hist_accumulate_wide_kernel (hist_common.cuh), the same sums add for
// add with the work laid out for large B: at F = 28 and B = 1,023 a
// feature's chunk histogram is 12 KB, so a block covers 8 features (4
// groups), the next tile's rows are loaded while a tile is summed, and
// past B = 8,192 the bin axis is tiled over the grid.  What bounds it is
// the warps shared memory leaves an SM (16) against each step's chain of
// shared-memory round trips, plus the partials: F * B * 12 bytes a chunk
// (344 KB at B = 1,023), so the chunking caps them at 256 MB
// (ops/histogram_flat.py::chunking).  int8 values take the int8 kernel
// over uint16 ids, its int32 cells tiled the same way, its partials
// capped at 16 MB (ops/histogram_flat.py::int8_chunk_rows).  The f32 /
// bf16 uint8 and packed4 entry points below are the uint8 kernels,
// untouched.

#include "hist_common.cuh"

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launches.  `vals`
// is (N, 3) f32, or __nv_bfloat16 with `bf16`; `bins` (N, F) uint8, or
// (N, ceil(F/2)) nibble pairs with `packed4`; `f` the real F.  `partial`
// is scratch of nchunks * f * nbins * 3 floats.
extern "C" int lgbt_histogram(const void* bins, const void* vals, int64_t n,
                              int f, int nbins, int chunk_rows, int nchunks,
                              int packed4, int bf16, void* partial, void* out,
                              void* stream) {
  if (nbins < 1 || nbins > lgbt::kMaxBins || f < 1 || nchunks < 1 || n < 1 ||
      (packed4 && nbins > 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = lgbt::launch_accumulate<false>(
      bins, f, vals, packed4 != 0, bf16 != 0, nullptr, nullptr, 1, n,
      chunk_rows, nbins, nchunks, (float*)partial, s);
  if (err != 0) return err;
  const int64_t cells = (int64_t)f * nbins * 3;
  const dim3 cgrid((unsigned)((cells + 255) / 256), 1);
  lgbt::hist_combine_kernel<<<cgrid, 256, 0, s>>>(
      (const float*)partial, nullptr, 1, nchunks, cells, nullptr, nullptr,
      (float*)out);
  return (int)cudaGetLastError();
}

// int8 mode.  `vals` (N, 3) int8, `out` (F, B, 3) int32; `bins` as above;
// `partial` scratch of nchunks * f * nbins * 3 int32; blocks of `fpb`
// features and `tile` bins (ops/histogram_flat.py::int8_shape).  Two
// launches on `stream` (accumulate, combine); does not synchronise;
// returns the first CUDA error.
extern "C" int lgbt_histogram_i8(const void* bins, const void* vals,
                                 int64_t n, int f, int nbins, int chunk_rows,
                                 int nchunks, int fpb, int tile, int packed4,
                                 void* partial, void* out, void* stream) {
  if (nbins < 1 || nbins > lgbt::kMaxBins || f < 1 || nchunks < 1 || n < 1 ||
      (packed4 && nbins > 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = lgbt::launch_accumulate_i8<false>(
      bins, f, vals, packed4 != 0, nullptr, nullptr, 1, n, chunk_rows, nbins,
      fpb, tile, nchunks, (int32_t*)partial, s);
  if (err != 0) return err;
  return lgbt::launch_combine_i8((const int32_t*)partial, nullptr, 1,
                                 nchunks, (int64_t)f * nbins * 3, nchunks,
                                 nullptr, nullptr, (int32_t*)out, s);
}

// uint16 bins, f32 / bf16 values: lgbt_histogram over (N, F) uint16 bins
// (never packed), up to kMaxBinsWide bins.
extern "C" int lgbt_histogram_u16(const void* bins, const void* vals,
                                  int64_t n, int f, int nbins, int chunk_rows,
                                  int nchunks, int bf16, void* partial,
                                  void* out, void* stream) {
  if (nbins < 1 || nbins > lgbt::kMaxBinsWide || f < 1 || nchunks < 1 ||
      n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = lgbt::launch_accumulate_wide<false>(
      bins, f, vals, bf16 != 0, nullptr, nullptr, 1, n, chunk_rows, nbins,
      nchunks, (float*)partial, s);
  if (err != 0) return err;
  const int64_t cells = (int64_t)f * nbins * 3;
  const dim3 cgrid((unsigned)((cells + 255) / 256), 1);
  lgbt::hist_combine_kernel<<<cgrid, 256, 0, s>>>(
      (const float*)partial, nullptr, 1, nchunks, cells, nullptr, nullptr,
      (float*)out);
  return (int)cudaGetLastError();
}

// uint16 bins, int8 values: lgbt_histogram_i8 over (N, F) uint16 bins.
extern "C" int lgbt_histogram_i8_u16(const void* bins, const void* vals,
                                     int64_t n, int f, int nbins,
                                     int chunk_rows, int nchunks, int fpb,
                                     int tile, void* partial, void* out,
                                     void* stream) {
  if (nbins < 1 || nbins > lgbt::kMaxBinsWide || f < 1 || nchunks < 1 ||
      n < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = lgbt::launch_accumulate_i8<false, uint16_t>(
      bins, f, vals, false, nullptr, nullptr, 1, n, chunk_rows, nbins, fpb,
      tile, nchunks, (int32_t*)partial, s);
  if (err != 0) return err;
  return lgbt::launch_combine_i8((const int32_t*)partial, nullptr, 1,
                                 nchunks, (int64_t)f * nbins * 3, nchunks,
                                 nullptr, nullptr, (int32_t*)out, s);
}
