// Shared device code of the histogram kernel (histogram.cu) and the wave
// kernel (wave.cu): the row-chunk accumulation and the combine.
//
//   out[f, b, c] = sum_n vals[n, c] * [bins[n, f] == b]
//
// f32 / bf16 mode: no float atomics, one fixed order of every sum.  Rows
// are cut into chunks of `chunk_rows`; each block owns one chunk and a
// group of features and writes that chunk's partial histogram to global
// scratch; a second kernel sums the partials of each cell in chunk order.
// Every cell is therefore ((0 + v_first) + v_next) + ... over the chunk's
// rows in row order, then the chunk partials in chunk order, on every run.
//
// What bounds the accumulation: instruction issue and latency on the
// CUDA cores.  A histogram needs N * F * 3 adds; the bytes (N * (F + 12))
// take ~2 us at the bench shape.  The design spends one warp step of
// grouping and read-modify-write per 32 row-features:
//   - a block's shared memory holds its chunk histogram of every feature
//     of its group, and one warp owns each feature's histogram: no other
//     warp writes it, so it needs no atomics.  Over rows in storage order
//     a group is every feature, up to kMaxFeatPerBlock (all 28 at B = 255:
//     86 KB, with the dynamic shared-memory opt-in); over rows gathered
//     through a permutation (the wave) it is kMaxFeatPerGather = 8, whose
//     smaller blocks keep more warps in flight to hide the gathers (both
//     timed on an H100 with tools/torch_kernel_ab.py: PERF.md).  Wider F
//     is cut into groups that fit kHistSmemBudget, even under packed bins;
//   - per step the warp's 32 lanes take 32 consecutive staged rows; the
//     lanes that hit one bin are grouped (what __match_any_sync returns,
//     computed with a ballot per bit of the id: same_bin_lanes), and the
//     lowest lane of each group reads the cell, adds its own value and
//     then each peer's in ascending lane (= row) order, and writes the
//     cell back.  That is the
//     register sum of a one-thread-per-row loop, add for add, at N * F /
//     32 steps instead of the N * F * 256 compares of one thread per bin;
//     16 bins (packed4) leave no thread idle;
//   - rows are staged in shared memory in tiles of kTileRows, two tiles
//     in flight: the contiguous rows of an unpermuted histogram whose
//     block covers every feature are copied with cp.async (16-byte
//     blocks, aligned down and up: the copy may read up to 15 bytes
//     around a tile in the same 16-byte block, never across a page),
//     other rows are loaded by a thread per row, all of its loads in
//     flight, each gathered row's bytes read once per feature group.
// Not tensor cores: a one-hot mma / wgmma would take bf16 products
// exactly, but it accumulates in f32 in the unit's own order, not in row
// order, so the sums would neither equal the plain twin's nor keep the
// bf16 launch equal to the f32 launch on the rounded values.
//
// int8 mode (quantized training): int8 values, int32 sums, exact in any
// order, so the chunk layout is free (hist_accumulate_i8_kernel).  What
// bounded the first design on an H100 (a block per chunk of at least
// 2,048 rows over every feature, a thread per row reading its bins byte
// by byte, three shared atomics a row-feature, one global atomic a
// nonzero cell): too few blocks (98 for a 200,000-row histogram, 7 for a
// wave of one 12,500-row sibling), and lanes on one bin serializing
// 32-fold (a bin per feature took 3.2x the time).  What this design does:
// blocks of 8 features (4 over uint16 bins, whose cells then take 48 KB)
// and chunks sized to put 528 blocks on the card (four an SM); a thread
// per row with four rows' loads in flight, the group's bins read as
// 32-bit words; each lane visits its row's features from lane % 8 on
// (lane % 4 over uint16 bins), so the lanes of a step spread over the
// features and meet at most 4-fold on a cell (8-fold over uint16 bins);
// each block writes its int32 chunk partial with plain stores and
// hist_combine_i8_kernel sums the chunks (no global atomics, no memset).
// Timed on an H100 80GB HBM3 at 700 W (tools/torch_kernel_ab.py against
// the first design, device ms of all launches): a 200,000 x 28 x 255
// histogram 0.0275 -> 0.0206 ms, one bin a feature 0.0854 -> 0.0215; a
// wave of 16 x 12,500 rows' stage 1 + combine 0.0504 -> 0.0376, of 1 x
// 12,500 0.0453 -> 0.0104; uint16 (B = 1,023) 0.0423 -> 0.0339; slower at
// 10.5M rows (0.512 -> 0.611: each row's levels read once a group, where
// the first design read them once).  Packing a cell's three sums into one
// 64-bit shared atomic was tried and dropped: sm_90a compiles it to a
// compare-and-swap loop (ATOMS.CAST.SPIN.64), slower than three adds.
//
// uint16 bins (more than 256 bins, up to 65,536), f32 / bf16 values:
// hist_accumulate_wide_kernel, the same sums add for add.  What bounds it
// on an H100: one feature's f32 chunk histogram is B * 12 bytes (12 KB at
// B = 1,023), so shared memory, not warps, caps an SM at 16 features (two
// blocks of 8) and 16 warps, a third of the warps the byte kernel keeps
// in flight; each 32-row step is a chain of shared-memory round trips
// (the bin id, 11 ballots, the cell, the values) that those few warps
// cannot hide.  Then the fixed per-chunk work: at B = 1,023 a block zeroes
// and flushes as many cells as it adds (the partials, 67 MB at 200,000
// rows, are the chunk layout's and stay).  What the design does: the rows
// of the next tile are loaded into registers while a tile is summed (the
// byte kernel's gather path waits for them tile by tile), a group's
// lowest lane loads its own values beside the cell, the bin ids are
// staged as words at an odd stride (no bank conflicts), and over gathered
// rows the lanes are grouped with one __match_any_sync (over rows in
// storage order, the ballots).  Past B = 8,192 the bin axis is cut into
// equal tiles over grid.z (bin_tile): a lane whose bin lies outside its
// block's tile adds nothing there.  Timed on an H100 80GB HBM3 at 700 W
// (tools/torch_kernel_ab.py against the earlier build, 200,000 rows x 28
// x 1,023 and a wave of 16 x 12,500): stage 1 0.112 -> 0.079 ms
// (histogram) and 0.182 -> 0.125 ms (wave), bit for bit; ballots over the
// gathered rows 0.133 ms (0.038 against 0.033 at W = 1; at B = 511 they
// win, 0.079 against 0.084), __match_any_sync over rows in storage order
// 0.088 ms.  Blocks held resident to walk several units (the flush
// overlapping the next unit's loads) and cp.async staging were tried in
// design builds and not kept: no faster at both shapes.
// int8 values take hist_accumulate_i8_kernel over uint16 ids, its int32
// cells tiled the same way.  The uint8 instantiations of the f32 / bf16
// kernels keep the code of earlier builds (tools/torch_kernel_ab.py
// compares it).
//
// bf16 values (kVal = __nv_bfloat16) and 4-bit bins (kPacked) are
// template parameters.  A bf16 value is widened to f32 as the lane reads
// it (exact) and summed by the f32 adds, so a bf16 launch gives the bits
// of an f32 launch on the bf16-rounded values.  Packed bins are (N,
// ceil(F/2)) bytes of two nibbles, feature 2j low in byte j and 2j + 1
// high; a feature group starts on an even feature, so no byte straddles
// two groups, and the lanes read the same bin ids the unpacked bytes
// hold: the packed kernel's sums are the unpacked kernel's, add for add.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lgbt {
// Internal linkage: both .cu files include this header and are linked
// into one library.
namespace {

// Bins per feature at most: uint8 bin ids, uint16 bin ids.
constexpr int kMaxBins = 256;
constexpr int kMaxBinsWide = 65536;
// Rows per staged tile, and warps per block at most.
constexpr int kTileRows = 256;
constexpr int kMaxWarps = 16;
// f32 / bf16 mode: features per block at most, over rows in storage
// order (whole rows copied with cp.async) and over rows gathered through
// a permutation (smaller blocks, more of them in flight to hide the
// gathers' latency), and the shared memory its chunk histograms may take.
constexpr int kMaxFeatPerBlock = 32;
constexpr int kMaxFeatPerGather = 8;
constexpr int kHistSmemBudget = 96 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

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
// is even).  kBin is the stored id's type, uint8_t or uint16_t (never
// packed); `row` is 2-byte aligned for uint16_t.
template <bool kPacked, typename kBin = uint8_t>
__device__ __forceinline__ int bin_at(const uint8_t* row, int j) {
  if (kPacked) return (row[j >> 1] >> ((j & 1) << 2)) & 15;
  return reinterpret_cast<const kBin*>(row)[j];
}

// Bytes that hold `nf` features (a group starting on an even feature).
__host__ __device__ __forceinline__ int feat_bytes(int nf, bool packed) {
  return packed ? (nf + 1) >> 1 : nf;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Bins per tile of one feature's chunk histogram over uint16 bins (12
// bytes a bin: three f32 or int32 sums) within `budget`: every bin (up to
// B = 8,192 at 96 KB), else the fewest equal tiles that fit.
__host__ __device__ inline int bin_tile(int nbins, int budget) {
  const int tiles = (nbins * 12 + budget - 1) / budget;
  return (nbins + tiles - 1) / tiles;
}

// Warps for `nf` features, a warp owning each: at most kMaxWarps, each
// with the same number of features (the last ones with one fewer).
__host__ __device__ inline int warps_for(int nf) {
  const int per = (nf + kMaxWarps - 1) / kMaxWarps;
  return (nf + per - 1) / per;
}

// f32 / bf16 mode over uint8 bins: features per block (every feature
// when its chunk histograms fit kHistSmemBudget and it has at most
// kMaxFeatPerBlock, or kMaxFeatPerGather under `perm`; otherwise the most
// that do, even under packed bins), warps per block (each warp owns the
// same number of features, at most kMaxWarps warps) and the dynamic
// shared memory: the histograms, then two stages of kTileRows rows (bin
// bytes, then values, each with 32 bytes of slack for the 16-byte
// alignment of cp.async).
struct AccShape {
  int fpb, groups, warps, row_stride, bin_stage, stage, smem;
};

__host__ __device__ inline AccShape acc_shape(int f, int nbins, bool packed,
                                              int val_bytes, bool perm) {
  AccShape a;
  const int most = perm ? kMaxFeatPerGather : kMaxFeatPerBlock;
  int fit = kHistSmemBudget / (nbins * 3 * (int)sizeof(float));
  fit = fit < most ? fit : most;
  if (fit >= f) a.fpb = f;
  else if (packed) a.fpb = fit < 2 ? 2 : (fit & ~1);
  else a.fpb = fit < 1 ? 1 : fit;
  a.groups = (f + a.fpb - 1) / a.fpb;
  a.warps = warps_for(a.fpb);
  // one group stages whole rows (contiguous in storage order); several
  // stage their own bytes of each row
  a.row_stride = a.groups == 1 ? feat_bytes(f, packed)
                               : feat_bytes(a.fpb, packed);
  a.bin_stage = align16(kTileRows * a.row_stride + 32);
  a.stage = a.bin_stage + align16(kTileRows * val_bytes + 32);
  a.smem = align16(a.fpb * nbins * 3 * (int)sizeof(float)) + 2 * a.stage;
  return a;
}

// cp.async of the bytes [b0, b1) of `base` into `dst` (16-byte aligned) as
// whole 16-byte blocks of the aligned span; returns the offset in `dst` of
// byte b0.  The span may reach up to 15 bytes before b0 and after b1, in
// the same 16-byte blocks (the caching allocator's blocks are 512-byte
// aligned, so these stay in memory it owns).
__device__ __forceinline__ int copy_async16(unsigned char* dst,
                                            const unsigned char* base,
                                            int64_t b0, int64_t b1) {
  const uintptr_t lo = (uintptr_t)(base + b0) & ~(uintptr_t)15;
  const uintptr_t hi = ((uintptr_t)(base + b1) + 15) & ~(uintptr_t)15;
  const int blocks = (int)((hi - lo) >> 4);
  for (int i = threadIdx.x; i < blocks; i += blockDim.x) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 16 * i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"((const void*)(lo + 16 * (uintptr_t)i)));
  }
  return (int)((uintptr_t)(base + b0) - lo);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The lanes of `act` whose bin id `b` equals this lane's (what
// __match_any_sync returns, which measured slower here): one ballot per
// bit of the id, kBits = 8 for bytes and 4 for nibbles.
template <int kBits>
__device__ __forceinline__ unsigned same_bin_lanes(unsigned act, int b) {
  unsigned m = act;
#pragma unroll
  for (int i = 0; i < kBits; ++i) {
    const unsigned set = __ballot_sync(act, (b >> i) & 1);
    m &= ((b >> i) & 1) ? set : ~set;
  }
  return m;
}

// uint16 bins: the lanes of `act` in this lane's bin tile (`mine`) whose
// offset `b` in the tile (< 2^bits) equals this lane's: a ballot for the
// tile, then one per bit.  `bits` is the same in every lane.
__device__ __forceinline__ unsigned same_tile_lanes(unsigned act, bool mine,
                                                    int b, int bits) {
  unsigned m = __ballot_sync(act, mine);
  for (int i = 0; i < bits; ++i) {
    const unsigned set = __ballot_sync(act, (b >> i) & 1);
    m &= ((b >> i) & 1) ? set : ~set;
  }
  return m;
}

// Segment table of a multi-segment launch (device int32, 3W + 1 entries):
//   seg[w]          first perm position of segment w
//   seg[W + w]      its row count
//   seg[2W + w]     its first chunk; seg[3W] is the total chunk count.
// With seg == nullptr there is one segment: rows [0, single_cnt) in
// storage order (no perm).  `f` is the real feature count; kVal is float
// or __nv_bfloat16; bins are uint8 (kBin stays a parameter so the kernel
// keeps the name tools/torch_kernel_ab.py holds its code to).  Grid
// (chunks, feature groups), acc_shape's warps and shared memory;
// `partial` is (chunks, f, nbins, 3) f32.  A bin id >= nbins is dropped.
// Packed bins keep three blocks on an SM (at most 42 registers a thread;
// an H100 timed it 8-20% faster there, and the byte-bin kernels slower
// under the same cap).
template <bool kPerm, bool kPacked, typename kVal, typename kBin = uint8_t>
__global__ void __launch_bounds__(kMaxWarps * 32, kPacked ? 3 : 1)
hist_accumulate_kernel(const uint8_t* __restrict__ bins, int f,
                       const kVal* __restrict__ vals,
                       const int32_t* __restrict__ perm,
                       const int32_t* __restrict__ seg, int w_count,
                       int64_t single_cnt, int chunk_rows, int nbins,
                       float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char s_acc[];
  constexpr int kValBytes = 3 * (int)sizeof(kVal);
  const AccShape a = acc_shape(f, nbins, kPacked, kValBytes, kPerm);
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
  const int f0 = blockIdx.y * a.fpb;
  const int nf = min(a.fpb, f - f0);
  const int row_bytes = feat_bytes(f, kPacked);
  const int group_bytes = feat_bytes(nf, kPacked);
  const int fb0 = kPacked ? f0 >> 1 : f0;
  const bool contiguous = !kPerm && a.groups == 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* hist = reinterpret_cast<float*>(s_acc);
  unsigned char* stages =
      s_acc + align16(a.fpb * nbins * 3 * (int)sizeof(float));
  const int cells = nf * nbins * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0.f;

  // Stage tile k into buffer k & 1 and commit it as one cp.async group
  // (an empty group on the gather path, whose plain stores the next
  // __syncthreads publishes).
  const int ntiles = (int)((r1 - r0 + kTileRows - 1) / kTileRows);
  auto issue = [&](int k) {
    unsigned char* buf = stages + (k & 1) * a.stage;
    const int64_t t0 = r0 + (int64_t)k * kTileRows;
    const int rows = (int)min((int64_t)kTileRows, r1 - t0);
    if (contiguous) {
      const int64_t g0 = start + t0;
      copy_async16(buf, bins, g0 * row_bytes, (g0 + rows) * row_bytes);
      copy_async16(buf + a.bin_stage, (const unsigned char*)vals,
                   g0 * kValBytes, (g0 + rows) * kValBytes);
    } else {                               // a thread per row, its loads
      kVal* dv = reinterpret_cast<kVal*>(buf + a.bin_stage);   // in flight
      for (int r = threadIdx.x; r < rows; r += blockDim.x) {
        const int64_t pos = start + t0 + r;
        const int64_t row = kPerm ? (int64_t)perm[pos] : pos;
        const uint8_t* src = bins + row * row_bytes + fb0;
        uint8_t* dst = buf + r * a.row_stride;
        const kVal v0 = vals[row * 3 + 0], v1 = vals[row * 3 + 1],
                   v2 = vals[row * 3 + 2];
        for (int j0 = 0; j0 < group_bytes; j0 += 16) {
          uint8_t x[16];
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (j0 + j < group_bytes) x[j] = src[j0 + j];
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (j0 + j < group_bytes) dst[j0 + j] = x[j];
        }
        dv[r * 3 + 0] = v0; dv[r * 3 + 1] = v1; dv[r * 3 + 2] = v2;
      }
    }
    cp_async_commit();
  };

  issue(0);
  for (int k = 0; k < ntiles; ++k) {
    if (k + 1 < ntiles) issue(k + 1);
    else cp_async_commit();
    cp_async_wait_one();                   // this thread's tile k landed
    __syncthreads();                       // every thread's, and the zeros
    const unsigned char* buf = stages + (k & 1) * a.stage;
    const int64_t t0 = r0 + (int64_t)k * kTileRows;
    const int rows = (int)min((int64_t)kTileRows, r1 - t0);
    const uint8_t* tb = buf;
    const kVal* tv = reinterpret_cast<const kVal*>(buf + a.bin_stage);
    if (contiguous) {                      // the offsets copy_async16 used
      const int64_t g0 = start + t0;
      tb += (uintptr_t)(bins + g0 * row_bytes) & 15;
      tv = reinterpret_cast<const kVal*>(
          buf + a.bin_stage +
          ((uintptr_t)((const unsigned char*)vals + g0 * kValBytes) & 15));
    }
    for (int s0 = 0; s0 < rows; s0 += 32) {
      if (s0 + lane >= rows) break;        // live lanes are a prefix
      const unsigned act =
          rows - s0 >= 32 ? kFullMask : (1u << (rows - s0)) - 1u;
      const uint8_t* rb = tb + (s0 + lane) * a.row_stride;
      // the group's lowest lane adds its own value and each peer's, in
      // lane (= row) order
      auto add_group = [&](float* cell, unsigned grp) {
        float g = cell[0], h = cell[1], c = cell[2];
        for (unsigned m = grp; m != 0; m &= m - 1) {
          const kVal* v = tv + (s0 + __ffs(m) - 1) * 3;
          g += to_f32(v[0]);
          h += to_f32(v[1]);
          c += to_f32(v[2]);
        }
        cell[0] = g; cell[1] = h; cell[2] = c;
      };
      for (int j = warp; j < nf; j += nwarps) {
        const int b = bin_at<kPacked>(rb, j);
        const unsigned grp = same_bin_lanes<kPacked ? 4 : 8>(act, b);
        if (b < nbins && lane == __ffs(grp) - 1)
          add_group(hist + (j * nbins + b) * 3, grp);
        __syncwarp(act);                   // the cell, for the next step
      }
    }
    __syncthreads();                       // buffer k & 1 is free again
  }
  float* dst = partial + ((int64_t)chunk * f + f0) * nbins * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) dst[i] = hist[i];
}

// Raises the dynamic shared-memory limit of `kernel` to `smem` where it
// is above the default 48 KB.
template <typename Kernel>
inline int smem_opt_in(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Launches the f32 / bf16 accumulation of `packed` or unpacked uint8
// bins: grid (nchunks, feature groups).  Returns the first CUDA error.
template <bool kPerm>
inline int launch_accumulate(const void* bins, int f, const void* vals,
                             bool packed, bool bf16, const int32_t* perm,
                             const int32_t* seg, int w_count,
                             int64_t single_cnt, int chunk_rows, int nbins,
                             int nchunks, float* partial, cudaStream_t s) {
  const AccShape a = acc_shape(f, nbins, packed, bf16 ? 6 : 12, kPerm);
  const dim3 grid((unsigned)nchunks, (unsigned)a.groups);
  const uint8_t* b = (const uint8_t*)bins;
  int err = 0;
#define LGBT_ACC(P, V)                                                    \
  do {                                                                    \
    err = smem_opt_in(hist_accumulate_kernel<kPerm, P, V>, a.smem);       \
    if (err != 0) return err;                                             \
    hist_accumulate_kernel<kPerm, P, V>                                   \
        <<<grid, 32 * a.warps, a.smem, s>>>(b, f, (const V*)vals, perm,   \
                                            seg, w_count, single_cnt,     \
                                            chunk_rows, nbins, partial);  \
  } while (0)
  if (packed && bf16) LGBT_ACC(true, __nv_bfloat16);
  else if (packed) LGBT_ACC(true, float);
  else if (bf16) LGBT_ACC(false, __nv_bfloat16);
  else LGBT_ACC(false, float);
#undef LGBT_ACC
  return (int)cudaGetLastError();
}

// uint16 bins, f32 / bf16 values (hist_accumulate_wide_kernel): bins per
// tile and tiles (the grid's z past 8,192 bins, as acc_shape), then the
// most features a block (at most kMaxFeatPerBlock, or kMaxFeatPerGather
// under `perm`) whose block fits kWideSmemBudget, two blocks an SM (8 at
// B = 1,023), else one feature; warps (one row a thread per staged tile:
// at least kTileRows / 32) and the dynamic shared memory: the histograms
// and two stages of kTileRows rows (the group's bin ids as 32-bit words at
// an odd stride, so lanes reading consecutive rows meet no bank conflict,
// then the values).
constexpr int kWideMinWarps = kTileRows / 32;
constexpr int kWideSmemBudget = 112 * 1024;

struct WideShape {
  int tile, tiles, fpb, groups, warps, stride, bin_stage, stage, smem;
};

__host__ __device__ inline WideShape wide_fit(int tile, int fpb,
                                              int val_bytes) {
  WideShape a;
  a.tile = tile;
  a.fpb = fpb;
  const int w = warps_for(fpb);
  a.warps = w > kWideMinWarps ? w : kWideMinWarps;
  a.stride = ((fpb + 1) >> 1) | 1;
  a.bin_stage = align16(kTileRows * a.stride * 4);
  a.stage = a.bin_stage + align16(kTileRows * val_bytes);
  a.smem = align16(fpb * tile * 3 * (int)sizeof(float)) + 2 * a.stage;
  return a;
}

__host__ __device__ inline WideShape wide_shape(int f, int nbins, bool perm,
                                                int val_bytes) {
  const int tile = bin_tile(nbins, kHistSmemBudget);
  const int most = perm ? kMaxFeatPerGather : kMaxFeatPerBlock;
  int fpb = f < most ? f : most;
  WideShape a = wide_fit(tile, fpb, val_bytes);
  while (fpb > 1 && a.smem > kWideSmemBudget)
    a = wide_fit(tile, --fpb, val_bytes);
  a.tiles = (nbins + tile - 1) / tile;
  a.groups = (f + fpb - 1) / fpb;
  return a;
}

// The f32 / bf16 accumulation over uint16 bin ids (the note at the top of
// this file): a block per (chunk, feature group, bin tile), a warp per
// feature's shared-memory chunk histogram, 32 staged rows a step; the
// lanes of one bin are grouped (__match_any_sync over gathered rows, a
// ballot per bit over rows in storage order: each timed the faster on its
// path), and the group's lowest lane adds its own value and then each
// peer's in lane (= row) order.  Rows of tile k + 1 are loaded into
// registers (the permutation index one tile earlier still) while tile k
// is summed.  wide_shape's warps and shared memory; arguments as
// hist_accumulate_kernel's.
template <bool kPerm, typename kVal>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
hist_accumulate_wide_kernel(const uint16_t* __restrict__ bins, int f,
                            const kVal* __restrict__ vals,
                            const int32_t* __restrict__ perm,
                            const int32_t* __restrict__ seg, int w_count,
                            int64_t single_cnt, int chunk_rows, int nbins,
                            float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char s_acc[];
  constexpr int kValBytes = 3 * (int)sizeof(kVal);
  constexpr int kMaxWords = (kMaxFeatPerBlock + 1) / 2;
  const WideShape a = wide_shape(f, nbins, kPerm, kValBytes);
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
  const int f0 = blockIdx.y * a.fpb;
  const int nf = min(a.fpb, f - f0);
  const int bin0 = (int)blockIdx.z * a.tile;
  const int tlen = min(a.tile, nbins - bin0);
  const int bits = 32 - __clz(tlen - 1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* hist = reinterpret_cast<float*>(s_acc);
  unsigned char* stages =
      s_acc + align16(a.fpb * a.tile * 3 * (int)sizeof(float));
  const int cells = nf * tlen * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0.f;

  // A thread's row of a tile: its group's bin ids, as whole 32-bit words
  // where every group starts on an even id of an even-width row (else id
  // by id), and its values.
  const bool by_word = ((f | f0) & 1) == 0 && ((uintptr_t)bins & 3) == 0;
  const int nwords = (nf + 1) >> 1;
  const int ntiles = (int)((r1 - r0 + kTileRows - 1) / kTileRows);
  const int tr = threadIdx.x;               // the thread's row in a tile
  uint32_t w[kMaxWords];
  kVal v[3];
  auto rows_of = [&](int k) {
    return (int)min((int64_t)kTileRows, r1 - (r0 + (int64_t)k * kTileRows));
  };
  auto row_at = [&](int k) -> int64_t {     // -1: no row
    if (k >= ntiles || tr >= rows_of(k)) return -1;
    const int64_t pos = start + r0 + (int64_t)k * kTileRows + tr;
    return kPerm ? (int64_t)perm[pos] : pos;
  };
  auto load = [&](int64_t row) {
    if (row < 0) return;
    const uint16_t* src = bins + row * f + f0;
    if (by_word) {
      const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
      for (int i = 0; i < kMaxWords; ++i)
        if (i < nwords) w[i] = s32[i];
    } else {
#pragma unroll
      for (int i = 0; i < kMaxWords; ++i) {
        if (2 * i < nf) {
          const uint32_t lo = src[2 * i];
          const uint32_t hi = 2 * i + 1 < nf ? src[2 * i + 1] : 0u;
          w[i] = lo | (hi << 16);
        }
      }
    }
    v[0] = vals[row * 3 + 0];
    v[1] = vals[row * 3 + 1];
    v[2] = vals[row * 3 + 2];
  };
  auto store = [&](int64_t row, int k) {
    if (row < 0) return;
    unsigned char* buf = stages + (k & 1) * a.stage;
    uint32_t* dw = reinterpret_cast<uint32_t*>(buf) + tr * a.stride;
#pragma unroll
    for (int i = 0; i < kMaxWords; ++i)
      if (i < nwords) dw[i] = w[i];
    kVal* dv = reinterpret_cast<kVal*>(buf + a.bin_stage) + tr * 3;
    dv[0] = v[0]; dv[1] = v[1]; dv[2] = v[2];
  };

  // The tile in stage k & 1: each warp's features, 32 rows a step.
  auto sum_tile = [&](int k) {
    const unsigned char* buf = stages + (k & 1) * a.stage;
    const uint16_t* tb = reinterpret_cast<const uint16_t*>(buf);
    const kVal* tv = reinterpret_cast<const kVal*>(buf + a.bin_stage);
    const int rows = rows_of(k);
    for (int j = warp; j < nf; j += nwarps) {
      float* hj = hist + j * tlen * 3;
      for (int s0 = 0; s0 < rows; s0 += 32) {
        const int r = s0 + lane;
        const int b = r < rows ? (int)tb[r * a.stride * 2 + j] - bin0 : -1;
        const bool mine = (unsigned)b < (unsigned)tlen;
        unsigned grp;
        if constexpr (kPerm)
          grp = __match_any_sync(kFullMask, mine ? b : 0x10000 + lane);
        else
          grp = same_tile_lanes(kFullMask, mine, b, bits);
        if (mine && lane == __ffs(grp) - 1) {
          const kVal* own = tv + r * 3;
          const float g0 = to_f32(own[0]), h0 = to_f32(own[1]),
                      c0 = to_f32(own[2]);
          float* cell = hj + b * 3;
          float g = cell[0] + g0, h = cell[1] + h0, c = cell[2] + c0;
          for (unsigned m = grp & (grp - 1); m != 0; m &= m - 1) {
            const kVal* pv = tv + (s0 + __ffs(m) - 1) * 3;
            g += to_f32(pv[0]);
            h += to_f32(pv[1]);
            c += to_f32(pv[2]);
          }
          cell[0] = g; cell[1] = h; cell[2] = c;
        }
        __syncwarp();                       // the cells, for the next step
      }
    }
  };

  int64_t row = row_at(0);
  load(row);
  store(row, 0);
  int64_t next = row_at(1);                 // tile 1's row, loaded below
  __syncthreads();                          // tile 0 and the zeros
  for (int k = 0; k < ntiles; ++k) {
    const int64_t cur = next;
    load(cur);                              // tile k + 1, in flight
    next = row_at(k + 2);
    sum_tile(k);
    store(cur, k + 1);                      // stage (k + 1) & 1 is free
    __syncthreads();
  }
  // each feature's tile in place: (chunk, f, nbins, 3)
  const int span = tlen * 3;
  float* dst = partial + (((int64_t)chunk * f + f0) * nbins + bin0) * 3;
  for (int j = 0; j < nf; ++j) {
    const float* src = hist + j * span;
    float* dj = dst + (int64_t)j * nbins * 3;
    for (int i = threadIdx.x; i < span; i += blockDim.x) dj[i] = src[i];
  }
}

// Launches the f32 / bf16 accumulation over (N, F) uint16 bins: grid
// (nchunks, feature groups, bin tiles).  Returns the first CUDA error.
template <bool kPerm>
inline int launch_accumulate_wide(const void* bins, int f, const void* vals,
                                  bool bf16, const int32_t* perm,
                                  const int32_t* seg, int w_count,
                                  int64_t single_cnt, int chunk_rows,
                                  int nbins, int nchunks, float* partial,
                                  cudaStream_t s) {
  const WideShape a = wide_shape(f, nbins, kPerm, bf16 ? 6 : 12);
  const dim3 grid((unsigned)nchunks, (unsigned)a.groups, (unsigned)a.tiles);
  const uint16_t* b = (const uint16_t*)bins;
  int err = 0;
#define LGBT_ACC_WIDE(V)                                                   \
  do {                                                                     \
    err = smem_opt_in(hist_accumulate_wide_kernel<kPerm, V>, a.smem);      \
    if (err != 0) return err;                                              \
    hist_accumulate_wide_kernel<kPerm, V>                                  \
        <<<grid, 32 * a.warps, a.smem, s>>>(b, f, (const V*)vals, perm,    \
                                            seg, w_count, single_cnt,      \
                                            chunk_rows, nbins, partial);   \
  } while (0)
  if (bf16) LGBT_ACC_WIDE(__nv_bfloat16);
  else LGBT_ACC_WIDE(float);
#undef LGBT_ACC_WIDE
  return (int)cudaGetLastError();
}

// int8 mode (hist_accumulate_i8_kernel): threads a block, rows a thread
// loads before it adds them, and the widest feature group a thread's two
// 32-bit words of bin ids hold (8 nibbles or bytes, 4 uint16 ids).  The
// block layout itself (features a group, bins a tile) is the wrapper's,
// ops/histogram_flat.py::int8_shape; the launcher checks it against these.
constexpr int kI8Threads = 256;
constexpr int kI8Batch = 4;
constexpr int kI8Group = 8;
constexpr int kI8GroupWide = 4;

// The `nbytes` bytes at `p` (a feature group of one row) as kWords
// 32-bit words, read as the aligned words that hold them (up to 3 bytes
// before and after, in the same words: memory the row's allocation owns)
// and shifted into place.
template <int kWords>
__device__ __forceinline__ void i8_row_words(const uint8_t* p, int nbytes,
                                             uint32_t (&a)[kWords]) {
  const uintptr_t addr = (uintptr_t)p;
  const uint32_t* base =
      reinterpret_cast<const uint32_t*>(addr & ~(uintptr_t)3);
  const int off = (int)(addr & 3);
  const int nw = (off + nbytes + 3) >> 2;
  uint32_t w[kWords + 1];
#pragma unroll
  for (int i = 0; i <= kWords; ++i) w[i] = i < nw ? __ldg(base + i) : 0u;
#pragma unroll
  for (int i = 0; i < kWords; ++i)
    a[i] = __funnelshift_r(w[i], w[i + 1], 8 * off);
}

// Bin id of local feature k (below the group's width) of a row group's
// words: nibbles, bytes or uint16 ids (a group of kI8Group nibbles or
// bytes, or kI8GroupWide uint16 ids).
template <bool kPacked, typename kBin, int kWords>
__device__ __forceinline__ int i8_bin(const uint32_t (&a)[kWords], int k) {
  static_assert(kWords == (kPacked ? 1 : 2), "a group is 4 or 8 bytes");
  if constexpr (kPacked) {
    return (a[0] >> (k * 4)) & 15;
  } else if constexpr (sizeof(kBin) == 2) {
    return ((k & 2 ? a[1] : a[0]) >> ((k & 1) * 16)) & 0xffff;
  } else {
    return ((k & 4 ? a[1] : a[0]) >> ((k & 3) * 8)) & 0xff;
  }
}

// A full group's words rotated by r features (0 <= r < the group's
// width), so that feature (r + j) mod width sits where feature j sat.
template <bool kPacked, typename kBin, int kWords>
__device__ __forceinline__ void i8_rotate(const uint32_t (&a)[kWords], int r,
                                          uint32_t (&x)[kWords]) {
  if constexpr (kPacked) {
    x[0] = __funnelshift_r(a[0], a[0], 4 * r);
  } else {
    // 8 bytes: r bytes, or r uint16 ids (2r bytes)
    const int bytes = sizeof(kBin) == 2 ? 2 * r : r;
    const bool swap = (bytes & 4) != 0;
    const uint32_t lo = swap ? a[1] : a[0];
    const uint32_t hi = swap ? a[0] : a[1];
    x[0] = __funnelshift_r(lo, hi, 8 * (bytes & 3));
    x[1] = __funnelshift_r(hi, lo, 8 * (bytes & 3));
  }
}

// int8 mode accumulation: grid (chunks, ceil(f / fpb) feature groups,
// ceil(nbins / tile) bin tiles), kI8Threads threads and fpb * tile * 12
// bytes of shared memory.  A block adds its chunk's rows into int32 cells
// of its group's features and tile's bins with shared-memory integer
// atomicAdd, a thread per row, kI8Batch rows' loads (the perm index, the
// levels, the group's bin bytes as words) in flight before their adds; a
// level of 0 adds nothing.  A
// lane visits its row's features starting at lane % nf, so the 32 lanes
// of a step spread over the features: rows that all hold one bin meet at
// most ceil(32 / nf)-fold on a cell, not 32-fold.  In a full group (nf
// the group's width) the lane rotates its row's words once and reads the
// features at fixed offsets.  Then the block writes
// its cells (zeros too) to its chunk's partial, `partial` being (chunks,
// f, nbins, 3) int32; hist_combine_i8_kernel sums them.  A bin >= nbins
// is dropped.
template <bool kPerm, bool kPacked, typename kBin = uint8_t>
__global__ void __launch_bounds__(kI8Threads)
hist_accumulate_i8_kernel(const uint8_t* __restrict__ bins, int f,
                          const int8_t* __restrict__ vals,
                          const int32_t* __restrict__ perm,
                          const int32_t* __restrict__ seg, int w_count,
                          int64_t single_cnt, int chunk_rows, int nbins,
                          int fpb, int tile, int32_t* __restrict__ partial) {
  extern __shared__ __align__(16) int32_t s_i8[];
  constexpr bool kWide = sizeof(kBin) == 2;
  constexpr int kGroupBytes = kPacked ? kI8Group / 2
                              : kWide ? kI8GroupWide * 2
                                      : kI8Group;
  constexpr int kWords = (kGroupBytes + 3) / 4;
  const int chunk = blockIdx.x;
  int64_t start = 0;
  int64_t cnt = single_cnt;
  int local = chunk;
  if (seg != nullptr) {
    const int w = segment_of(seg, w_count, chunk);
    start = seg[w];
    cnt = seg[w_count + w];
    local = chunk - seg[2 * w_count + w];
  }
  const int64_t r0 = (int64_t)local * chunk_rows;
  const int64_t r1 = min(cnt, r0 + (int64_t)chunk_rows);
  const int f0 = blockIdx.y * fpb;
  const int nf = min(fpb, f - f0);
  const int bin0 = (int)blockIdx.z * tile;
  const int tlen = min(tile, nbins - bin0);
  const int cells = nf * tlen * 3;
  for (int i = threadIdx.x; i < cells; i += kI8Threads) s_i8[i] = 0;
  __syncthreads();
  const int row_bytes = kPacked ? (f + 1) >> 1 : f * (int)sizeof(kBin);
  const int fb0 = kPacked ? f0 >> 1 : f0 * (int)sizeof(kBin);
  const int nbytes = kPacked ? (nf + 1) >> 1 : nf * (int)sizeof(kBin);
  constexpr int kWidth = kWide ? kI8GroupWide : kI8Group;
  const bool full = nf == kWidth;
  const int k0 = (threadIdx.x & 31) % nf;   // this lane's first feature
  for (int64_t i0 = r0 + threadIdx.x; i0 < r1;
       i0 += (int64_t)kI8Batch * kI8Threads) {
    uint32_t words[kI8Batch][kWords];
    int g[kI8Batch], h[kI8Batch], c[kI8Batch];
#pragma unroll
    for (int u = 0; u < kI8Batch; ++u) {
      const int64_t i = i0 + (int64_t)u * kI8Threads;
      g[u] = h[u] = c[u] = 0;
      if (i < r1) {
        const int64_t pos = start + i;
        const int64_t row = kPerm ? (int64_t)__ldg(perm + pos) : pos;
        const int8_t* v = vals + row * 3;
        g[u] = __ldg(v);
        h[u] = __ldg(v + 1);
        c[u] = __ldg(v + 2);
        i8_row_words(bins + row * row_bytes + fb0, nbytes, words[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kI8Batch; ++u) {
      if ((g[u] | h[u] | c[u]) == 0) continue;
      auto add = [&](int32_t* cell) {
        if (g[u] != 0) atomicAdd(cell + 0, g[u]);
        if (h[u] != 0) atomicAdd(cell + 1, h[u]);
        if (c[u] != 0) atomicAdd(cell + 2, c[u]);
      };
      if (full) {
        uint32_t x[kWords];
        i8_rotate<kPacked, kBin>(words[u], k0, x);
#pragma unroll
        for (int j = 0; j < kWidth; ++j) {
          const int b = i8_bin<kPacked, kBin>(x, j) - bin0;
          if ((unsigned)b < (unsigned)tlen)
            add(s_i8 + (((k0 + j) & (kWidth - 1)) * tlen + b) * 3);
        }
      } else {
        int k = k0;
        for (int j = 0; j < nf; ++j) {
          const int b = i8_bin<kPacked, kBin>(words[u], k) - bin0;
          if ((unsigned)b < (unsigned)tlen) add(s_i8 + (k * tlen + b) * 3);
          k = k + 1 == nf ? 0 : k + 1;
        }
      }
    }
  }
  __syncthreads();
  // each feature's tile in place: (chunk, f, nbins, 3)
  const int span = tlen * 3;
  int32_t* dst = partial + (((int64_t)chunk * f + f0) * nbins + bin0) * 3;
  for (int j = 0; j < nf; ++j) {
    const int32_t* src = s_i8 + j * span;
    int32_t* dj = dst + (int64_t)j * nbins * 3;
    for (int i = threadIdx.x; i < span; i += kI8Threads) dj[i] = src[i];
  }
}

// Launches the int8 accumulation of `packed` or unpacked bins of type
// kBin (uint16_t: never packed) into the chunk partials `partial`
// (nchunks * f * nbins * 3 int32), in blocks of `fpb` features (at most
// kI8Group, kI8GroupWide over uint16 bins) and `tile` bins.  Returns the
// first CUDA error.
template <bool kPerm, typename kBin = uint8_t>
inline int launch_accumulate_i8(const void* bins, int f, const void* vals,
                                bool packed, const int32_t* perm,
                                const int32_t* seg, int w_count,
                                int64_t single_cnt, int chunk_rows,
                                int nbins, int fpb, int tile, int nchunks,
                                int32_t* partial, cudaStream_t s) {
  const int widest = sizeof(kBin) == 2 ? kI8GroupWide : kI8Group;
  if (fpb < 1 || fpb > widest || tile < 1 || tile > nbins)
    return (int)cudaErrorInvalidValue;
  const int smem = fpb * tile * 12;
  const dim3 grid((unsigned)nchunks, (unsigned)((f + fpb - 1) / fpb),
                  (unsigned)((nbins + tile - 1) / tile));
  const uint8_t* b = (const uint8_t*)bins;
  const int8_t* v = (const int8_t*)vals;
  int err = 0;
#define LGBT_ACC_I8(P, B)                                                  \
  do {                                                                     \
    err = smem_opt_in(hist_accumulate_i8_kernel<kPerm, P, B>, smem);       \
    if (err != 0) return err;                                              \
    hist_accumulate_i8_kernel<kPerm, P, B>                                 \
        <<<grid, kI8Threads, smem, s>>>(b, f, v, perm, seg, w_count,       \
                                        single_cnt, chunk_rows, nbins, fpb, \
                                        tile, partial);                    \
  } while (0)
  if constexpr (sizeof(kBin) == 2) LGBT_ACC_I8(false, kBin);
  else if (packed) LGBT_ACC_I8(true, uint8_t);
  else LGBT_ACC_I8(false, uint8_t);
#undef LGBT_ACC_I8
  return (int)cudaGetLastError();
}

// int8 mode combine: each cell's chunk partials summed in int32 (exact in
// any order).  A block of kI8CombineThreads threads takes kI8CombineThreads
// / `lanes` consecutive cells, and lane k of a cell sums chunks k, k +
// lanes, ... of its range (each a coalesced row of cells); the lanes' sums
// meet in shared memory.  `lanes` is 1 or a power of two up to 8: many
// lanes where a range holds many chunks (a histogram's), one where it
// holds a few (a wave sibling's), so each thread reads the parent and
// writes the pair itself.  Without `parent` (the histogram kernel) the sum
// is written to `out` (cells); with it (the wave kernel) the sum is slot
// w's smaller sibling, the larger is parent - smaller in int32, and the
// pair is written as (left, right) by the small_left lane (4) of `stats`,
// `out` being (W, 2, cells).  Grid (ceil(cells * lanes /
// kI8CombineThreads), W); `seg` as the accumulation's (nullptr: chunks [0,
// single_chunks)).
constexpr int kI8CombineThreads = 256;

__global__ void __launch_bounds__(kI8CombineThreads)
hist_combine_i8_kernel(const int32_t* __restrict__ partial,
                       const int32_t* __restrict__ seg, int w_count,
                       int single_chunks, int64_t cells, int lanes,
                       const int32_t* __restrict__ parent,
                       const float* __restrict__ stats,
                       int32_t* __restrict__ out) {
  __shared__ int32_t s_sum[kI8CombineThreads];
  const int w = blockIdx.y;
  const int width = kI8CombineThreads / lanes;
  const int lane = threadIdx.x / width;
  const int64_t cell =
      (int64_t)blockIdx.x * width + (threadIdx.x - lane * width);
  int c0 = 0, c1 = single_chunks;
  if (seg != nullptr) {
    c0 = seg[2 * w_count + w];
    c1 = seg[2 * w_count + w + 1];
  }
  int32_t s = 0;
  if (cell < cells)
    for (int k = c0 + lane; k < c1; k += lanes)
      s += partial[(int64_t)k * cells + cell];
  if (lanes > 1) {
    s_sum[threadIdx.x] = s;
    __syncthreads();
    if (lane != 0) return;
    for (int k = 1; k < lanes; ++k) s += s_sum[k * width + threadIdx.x];
  }
  if (cell >= cells) return;
  if (parent == nullptr) {
    out[cell] = s;
    return;
  }
  const int32_t big = parent[(int64_t)w * cells + cell] - s;
  const bool small_left = stats[(int64_t)w * 16 + 4] > 0.5f;
  out[((int64_t)w * 2 + 0) * cells + cell] = small_left ? s : big;
  out[((int64_t)w * 2 + 1) * cells + cell] = small_left ? big : s;
}

// Launches hist_combine_i8_kernel over `w_count` slots of `cells` cells,
// with 8 lanes a cell where a slot's range averages 32 chunks or more.
inline int launch_combine_i8(const int32_t* partial, const int32_t* seg,
                             int w_count, int single_chunks, int64_t cells,
                             int total_chunks, const int32_t* parent,
                             const float* stats, int32_t* out,
                             cudaStream_t s) {
  const int lanes = total_chunks >= 32 * w_count ? 8 : 1;
  const int width = kI8CombineThreads / lanes;
  const dim3 grid((unsigned)((cells + width - 1) / width),
                  (unsigned)w_count);
  hist_combine_i8_kernel<<<grid, kI8CombineThreads, 0, s>>>(
      partial, seg, w_count, single_chunks, cells, lanes, parent, stats,
      out);
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
