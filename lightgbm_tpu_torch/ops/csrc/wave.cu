// Fused wave step for Hopper (sm_90a): smaller-sibling histograms ->
// sibling subtraction -> split scan -> winner selection, for the W leaves
// that split in one wave of leaf-wise growth.
//
// Replaces lightgbm_tpu/ops/pallas_wave.py::fused_wave_call (body
// _wave_kernel), every mode.  For each wave slot w:
//   1. accumulate the smaller sibling's histogram over its rows, reading
//      bins[perm[start + i], f] directly (no gathered copy of the rows);
//   2. larger sibling = parent - smaller;
//   3. order the pair as (left, right) by small_left;
//   4. scan both children for every (feature, threshold, NaN direction)
//      candidate with the arithmetic of ops/split.py::scan_tables: the
//      1e-15 gain floor, min_data_in_leaf / min_sum_hessian_in_leaf,
//      lambda_l1 / lambda_l2, max_delta_step, path_smooth through the
//      child's output, one-hot categoricals;
//   5. select the winner as ops/split.py::select_payload does: maximum
//      gain, then the lowest feature * B + bin;
//   6. write the raw (left, right) histograms and a (W, 2, 16 + B) f32
//      payload [gain, feature, bin, default_left, is_cat, GL, HL, CL, GR,
//      HR, CR, 0 x 5, cat one-hot]; an inactive slot gets gain -inf.
//
// What bounds it on this card.  Stage 1 is the histogram kernel's
// accumulation over the smaller siblings' rows (hist_common.cuh): issue
// of about one warp instruction per row-feature, the bins gathered
// through the permutation.  The combine reads the chunk partials and the
// W parents and writes the 2W child histograms (~86 KB each at F = 28, B
// = 255).  The scan is 2W * F * B candidates, each a few dozen flops with
// two IEEE divisions, and a cumulative sum over B bins per (child,
// feature) whose adds must stay in sequence.
//
// What the design does about it (three launches, deterministic):
//   - stage 1 splits every sibling's rows into chunks over many blocks
//     (a wave has only 1-16 leaves, so one block per leaf would leave most
//     of the 132 SMs idle); a block covers a group of 8 features of its
//     rows with a warp per feature's shared-memory histogram (blocks over
//     every feature, each gathered row read once, timed 40% slower: fewer
//     blocks in flight hide the gathers worse); the chunk partials are
//     summed in chunk order by the combine, which also subtracts from the
//     parent and orders the pair.  No float atomics;
//   - the scan runs one block per child and one warp per feature: the
//     cumulative sums stay sequential in f32 (lanes 0-2, a channel each,
//     the same adds in the same order), every lane evaluates the
//     candidates of its bins, and (gain, key) is reduced across lanes,
//     features and warps with the lowest key on ties, so the payload is
//     the sequential first-max scan's, bit for bit.  A warp-parallel
//     prefix scan would round differently, and is not used;
//   - built with --fmad=false so every a*b+c rounds twice, as the plain
//     version's separate torch ops round.
// Later work: fuse the combine into the scan (the child histogram read
// once from the partials), and spread a child's features over more than
// one SM for small waves (the uint16 scan below does).
//
// int8 mode (quantized training; the TPU kernel with dtype="int8" and its
// scale3 operand), the same three launches: stage 1 is the histogram
// kernel's int8 accumulation over the smaller siblings' rows gathered
// through `perm` (hist_common.cuh: blocks of 8 features over chunks of
// all the siblings' rows together, sized to put 528 blocks on the card
// whatever W, int32 chunk partials; exact in any order); the combine sums
// each sibling's chunks, computes parent - smaller in int32 and orders the
// pair; the child histograms come out int32, as the grower stores them;
// the scan stages each cell as float(h) * scale[c] (one multiply, as the
// JAX package's _scale_hist and _wave_kernel do), then runs the f32 scan
// unchanged.  The scales stay on the device (a pointer), so quantized
// growth adds no device-to-host copy.
//
// bf16 and packed4 modes: stage 1 runs the histogram kernel's bf16 and
// packed4 forms (hist_common.cuh): bf16 values are widened to f32 as the
// lanes read them, `bins[perm[i], f]` reads become nibble reads of
// `bins4[perm[i], f / 2]`, and the accumulation order, the combine and
// the scan are unchanged.  So a bf16 wave gives the bits of an f32 wave on
// the bf16-rounded values, and a packed4 wave those of the unpacked wave
// on the same rows, in every value type.  The child histograms stay in the
// grower's (F, B, 3) original feature order: the TPU kernel's nibble
// planes, and the original-order tie-break keys they force, fall away
// (the scan already breaks ties in original order).  An odd F's phantom
// high nibble is never read: a lane reads only features below F.
//
// uint16 bins (max_bin above 255, up to 65,536 bins; the TPU kernel takes
// them wherever its VMEM wave_layout fits), in every value type above but
// packed4: the entry points lgbt_wave_u16 and lgbt_wave_i8_u16, so the
// uint8 and packed4 entry points keep their code.  Stage 1 is the
// histogram kernel's uint16 accumulation over the gathered rows
// (hist_common.cuh, hist_accumulate_wide_kernel with kPerm; int8:
// hist_accumulate_i8_kernel over uint16 ids); the combines do not depend
// on B.  The scan is wave_scan_wide_kernel.  What bounds it on an H100:
// per (child, feature) a chain of B dependent adds per channel (the
// cumulative sums, which must stay in sequence) and B candidates of ~40
// flops with IEEE divisions; a block per child (the byte scan's design)
// puts a W = 1 wave's 56 (feature, child) chains on 2 SMs, two chains a
// warp back to back, each add waiting on a shared-memory round trip (the
// B = 1,023 scan took 0.079-0.086 ms at any W).  What the design does: a
// block per (child, feature) (fewer features a block only where B / 12
// slots cannot hold a block's best a feature), so a W = 1 wave fills 56
// SMs; threads 0-2 run the chains with the next 16 cells in registers
// ahead of the adds, every thread of the block evaluates candidates; the
// blocks of a child leave their bests in its payload's one-hot lanes,
// count in through an integer counter, and the last reads the bests in
// block order (maximum gain, lowest key: the sequential first-max, bit
// for bit) and writes the payload.  Tiles of 4,096 bins keep a block's
// staging at 48 KB up to B = 65,536 (16 tiles).  Timed on an H100 80GB
// HBM3 at 700 W (tools/torch_kernel_ab.py against the earlier build, F =
// 28, B = 1,023): the f32 scan of a 16 x 12,500 wave 0.086 -> 0.022 ms,
// of a W = 1 wave 0.079 -> 0.015 ms, bit for bit; with 8 cells ahead in
// place of 16, 0.0245 and 0.0175 ms.  The payload is 16 + B wide and
// carries the bin id as an f32, exact below 2^24.
// Scratch: segment_table (ops/wave.py) keeps the chunk partials under 256
// MB, but gives every non-empty sibling a chunk, so the partials of W
// siblings are at least W * F * B * 12 bytes (352 MB at W = 16, F = 28, B
// = 65,536, past the cap), and the child histograms 2W * F * B * 12 (704
// MB there).

#include <climits>
#include <math_constants.h>

#include "hist_common.cuh"

namespace {

constexpr int kPayloadScalars = 16;
constexpr int kStatLanes = 8;
constexpr float kEps = 1e-15f;

struct ScanCfg {
  float l1, l2, min_count, min_hess, gain_thr, max_delta, path_smooth;
  int has_nan, has_cat, max_cat_onehot;
};

__device__ __forceinline__ float tl1(float s, const ScanCfg& c) {
  if (c.l1 <= 0.f) return s;
  const float m = fmaxf(fabsf(s) - c.l1, 0.f);
  const float sg = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
  return sg * m;
}

__device__ __forceinline__ float denom(float h, const ScanCfg& c) {
  // (h + l2) + 1e-15, two roundings, in the order of ops/split.py
  float d = h + c.l2;
  d = d + kEps;
  return d;
}

__device__ __forceinline__ float leaf_output(float g, float h,
                                             const ScanCfg& c) {
  float out = -tl1(g, c) / denom(h, c);
  if (c.max_delta > 0.f) out = fminf(fmaxf(out, -c.max_delta), c.max_delta);
  return out;
}

__device__ __forceinline__ float leaf_gain(float g, float h,
                                           const ScanCfg& c) {
  const float t = tl1(g, c);
  return (t * t) / denom(h, c);
}

__device__ __forceinline__ float gain_given_output(float g, float h,
                                                   float out,
                                                   const ScanCfg& c) {
  const float t = tl1(g, c);
  const float a = (2.f * t) * out;
  const float b = ((h + c.l2) * out) * out;
  return -(a + b);
}

__device__ __forceinline__ float child_gain(float g, float h, float cnt,
                                            float pout, const ScanCfg& c) {
  if (c.path_smooth <= 0.f) return leaf_gain(g, h, c);
  const float w = leaf_output(g, h, c);
  const float ratio = cnt / c.path_smooth;
  const float r1 = ratio + 1.f;
  const float sw = (w * ratio) / r1 + pout / r1;
  return gain_given_output(g, h, sw, c);
}

struct Cand {
  float gain;
  float s[6];  // GL HL CL GR HR CR
};

__device__ __forceinline__ Cand eval_dir(float gl, float hl, float cl,
                                         float pg, float ph, float pc,
                                         float pout, float pgain,
                                         const ScanCfg& c) {
  Cand r;
  const float gr = pg - gl, hr = ph - hl, cr = pc - cl;
  const bool valid = cl >= c.min_count && cr >= c.min_count &&
                     hl >= c.min_hess && hr >= c.min_hess;
  float gain = child_gain(gl, hl, cl, pout, c) +
               child_gain(gr, hr, cr, pout, c);
  gain = gain - pgain;
  r.gain = (valid && gain > c.gain_thr) ? gain : -CUDART_INF_F;
  r.s[0] = gl; r.s[1] = hl; r.s[2] = cl;
  r.s[3] = gr; r.s[4] = hr; r.s[5] = cr;
  return r;
}

// A histogram cell as the scan sees it: f32 as stored; int32 (int8 mode)
// rescaled by its channel's scale.
__device__ __forceinline__ float cell(const float* h, int i, float) {
  return h[i];
}
__device__ __forceinline__ float cell(const int32_t* h, int i, float scale) {
  return (float)h[i] * scale;
}

// A candidate split as the scan keeps it: gain, key = feature * B + bin,
// NaN direction, kind, and the six child sums of the payload.
struct Best {
  float gain;
  int key;
  int dl, cat;
  float s[6];
};

// Dynamic shared memory of the scan: each warp's Best and the winner's
// bin, then each warp's (B, 3) cells.
inline int scan_smem(int warps, int nbins) {
  return lgbt::align16(warps * (int)sizeof(Best) + (int)sizeof(int)) +
         warps * nbins * 3 * (int)sizeof(float);
}

// One block per (slot, child), one warp per feature (a warp scans
// features warp, warp + warps, ...).  hist: (W, 2, F, B, 3) f32 or int32;
// scale3: 3 f32 channel scales (int8 mode; nullptr for f32); stats: (W,
// 2, 8) [pg, ph, pc, pout, small_left, active, 0, 0]; meta: (F, 4) int32
// [num_bins, nan_bin, is_cat, fmask].  Per feature the warp stages the
// cells in shared memory (int8: times the channel's scale), lanes 0-2
// turn them into the masked cumulative sums of G, H and C over the bins
// in sequence (one channel each, the adds of a sequential scan), and
// every lane evaluates the candidates of bins lane, lane + 32, ...; the
// winner is the maximum gain with the lowest key on ties, reduced across
// lanes, then features, then warps: the sequential first-max over keys in
// order (an all -inf child selects key 0).
template <typename T>
__global__ void __launch_bounds__(lgbt::kMaxWarps * 32)
wave_scan_kernel(const T* __restrict__ hist,
                 const float* __restrict__ scale3,
                 const float* __restrict__ stats,
                 const int32_t* __restrict__ meta, int f, int nbins,
                 ScanCfg c, float* __restrict__ payload) {
  extern __shared__ __align__(16) unsigned char s_scan[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  Best* s_best = reinterpret_cast<Best*>(s_scan);
  int* s_win_bin = reinterpret_cast<int*>(s_best + nwarps);
  float* cells = reinterpret_cast<float*>(
                     s_scan + lgbt::align16(nwarps * (int)sizeof(Best) +
                                            (int)sizeof(int))) +
                 warp * nbins * 3;
  const float scale[3] = {scale3 != nullptr ? scale3[0] : 1.f,
                          scale3 != nullptr ? scale3[1] : 1.f,
                          scale3 != nullptr ? scale3[2] : 1.f};
  const int child = blockIdx.x;         // w * 2 + ci
  const float* st = stats + (int64_t)child * kStatLanes;
  const float pg = st[0], ph = st[1], pc = st[2], pout = st[3];
  const bool active = st[5] > 0.5f;
  const float pgain = c.path_smooth > 0.f ? gain_given_output(pg, ph, pout, c)
                                          : leaf_gain(pg, ph, c);
  const T* h0 = hist + (int64_t)child * f * nbins * 3;

  // the warp's best so far (the same in every lane)
  float run_gain = -CUDART_INF_F;
  int run_key = INT_MAX;
  if (lane == 0) s_best[warp] = Best{-CUDART_INF_F, INT_MAX, 0, 0, {}};
  for (int feat = warp; feat < f; feat += nwarps) {
    const int nb = meta[feat * 4 + 0];
    const int nanb = meta[feat * 4 + 1];
    const bool iscat = c.has_cat && meta[feat * 4 + 2] != 0;
    const bool fm = meta[feat * 4 + 3] != 0;
    const bool sorted_el = iscat && nb > c.max_cat_onehot;
    const T* hf = h0 + (int64_t)feat * nbins * 3;
    for (int i = lane; i < nbins * 3; i += 32)
      cells[i] = cell(hf, i, scale[i % 3]);
    __syncwarp();
    float gn = 0.f, hn = 0.f, cn = 0.f;
    if (nanb < nbins) {
      gn = cells[nanb * 3 + 0];
      hn = cells[nanb * 3 + 1];
      cn = cells[nanb * 3 + 2];
    }
    __syncwarp();
    if (!iscat && lane < 3) {           // categorical bins stand alone
      float run = 0.f;
      for (int b = 0; b < nbins; ++b) {
        const bool vm = b < nb && b != nanb;
        float* p = cells + b * 3 + lane;
        run = run + (vm ? *p : 0.f);
        *p = run;
      }
    }
    __syncwarp();
    Best mine{-CUDART_INF_F, INT_MAX, 0, 0, {}};
    for (int b = lane; b < nbins; b += 32) {
      const float* p = cells + b * 3;   // the bin's cells, or cumulative
      const bool in_f = b < nb;
      const bool vm = in_f && b != nanb;
      Cand cand;
      bool dl = false;
      float gain;
      if (iscat) {
        cand = eval_dir(p[0], p[1], p[2], pg, ph, pc, pout, pgain, c);
        gain = in_f ? cand.gain : -CUDART_INF_F;
      } else {
        const Cand mr = eval_dir(p[0], p[1], p[2], pg, ph, pc, pout, pgain,
                                 c);
        cand = mr;
        gain = mr.gain;
        if (c.has_nan) {
          const Cand ml = eval_dir(p[0] + gn, p[1] + hn, p[2] + cn, pg, ph,
                                   pc, pout, pgain, c);
          const float gml = nanb < nbins ? ml.gain : -CUDART_INF_F;
          gain = fmaxf(mr.gain, gml);
          dl = gml > mr.gain;
          if (dl) cand = ml;
        }
        if (!vm) gain = -CUDART_INF_F;
      }
      if (sorted_el || !fm) gain = -CUDART_INF_F;
      // in key order: the lane's first candidate seeds its best
      if (mine.key == INT_MAX || gain > mine.gain) {
        mine.gain = gain;
        mine.key = feat * nbins + b;
        mine.dl = dl;
        mine.cat = iscat;
        for (int i = 0; i < 6; ++i) mine.s[i] = cand.s[i];
      }
    }
    float wg = mine.gain;
    int wk = mine.key;
    for (int o = 16; o > 0; o >>= 1) {
      const float og = __shfl_xor_sync(lgbt::kFullMask, wg, o);
      const int ok = __shfl_xor_sync(lgbt::kFullMask, wk, o);
      if (og > wg || (og == wg && ok < wk)) { wg = og; wk = ok; }
    }
    if (wg > run_gain || (wg == run_gain && wk < run_key)) {
      run_gain = wg;
      run_key = wk;
      if (mine.key == wk) s_best[warp] = mine;
    }
    __syncwarp();                       // cells and s_best, for the next
  }
  __syncthreads();
  float* pay = payload + (int64_t)child * (kPayloadScalars + nbins);
  if (threadIdx.x == 0) {
    int bi = 0;
    for (int i = 1; i < nwarps; ++i) {
      const Best& o = s_best[i];
      if (o.gain > s_best[bi].gain ||
          (o.gain == s_best[bi].gain && o.key < s_best[bi].key))
        bi = i;
    }
    const Best& win = s_best[bi];
    pay[0] = active ? win.gain : -CUDART_INF_F;
    pay[1] = (float)(win.key / nbins);
    pay[2] = (float)(win.key % nbins);
    pay[3] = (!win.cat && win.dl) ? 1.f : 0.f;
    pay[4] = win.cat ? 1.f : 0.f;
    for (int i = 0; i < 6; ++i) pay[5 + i] = win.s[i];
    for (int i = 11; i < kPayloadScalars; ++i) pay[i] = 0.f;
    *s_win_bin = win.cat ? win.key % nbins : -1;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += blockDim.x)
    pay[kPayloadScalars + b] = b == *s_win_bin ? 1.f : 0.f;
}

// The uint16 scan's steps below are wave_scan_kernel's arithmetic line
// for line; wave_scan_kernel keeps its own copy, so the byte modes
// compile to the SASS of earlier builds (tools/torch_kernel_ab.py
// compares it).

// A feature as the scan reads it from meta (F, 4) and the config.
struct Feat {
  int nb, nanb;
  bool iscat, fm, sorted_el;
};

__device__ __forceinline__ Feat read_feat(const int32_t* meta, int feat,
                                          const ScanCfg& c) {
  Feat q;
  q.nb = meta[feat * 4 + 0];
  q.nanb = meta[feat * 4 + 1];
  q.iscat = c.has_cat && meta[feat * 4 + 2] != 0;
  q.fm = meta[feat * 4 + 3] != 0;
  q.sorted_el = q.iscat && q.nb > c.max_cat_onehot;
  return q;
}

// The candidate of bin b of feature `feat` into the thread's best `mine`:
// `p` is the bin's cells (categorical) or masked cumulative sums, (gn,
// hn, cn) the NaN bin's cells.  A thread's candidates come in ascending
// key order, so its first seeds `mine` and a later one must be strictly
// better.
__device__ __forceinline__ void scan_bin(Best& mine, const float* p, int b,
                                         int feat, int nbins, const Feat& q,
                                         float gn, float hn, float cn,
                                         float pg, float ph, float pc,
                                         float pout, float pgain,
                                         const ScanCfg& c) {
  const bool in_f = b < q.nb;
  const bool vm = in_f && b != q.nanb;
  Cand cand;
  bool dl = false;
  float gain;
  if (q.iscat) {
    cand = eval_dir(p[0], p[1], p[2], pg, ph, pc, pout, pgain, c);
    gain = in_f ? cand.gain : -CUDART_INF_F;
  } else {
    const Cand mr = eval_dir(p[0], p[1], p[2], pg, ph, pc, pout, pgain, c);
    cand = mr;
    gain = mr.gain;
    if (c.has_nan) {
      const Cand ml = eval_dir(p[0] + gn, p[1] + hn, p[2] + cn, pg, ph, pc,
                               pout, pgain, c);
      const float gml = q.nanb < nbins ? ml.gain : -CUDART_INF_F;
      gain = fmaxf(mr.gain, gml);
      dl = gml > mr.gain;
      if (dl) cand = ml;
    }
    if (!vm) gain = -CUDART_INF_F;
  }
  if (q.sorted_el || !q.fm) gain = -CUDART_INF_F;
  if (mine.key == INT_MAX || gain > mine.gain) {
    mine.gain = gain;
    mine.key = feat * nbins + b;
    mine.dl = dl;
    mine.cat = q.iscat;
    for (int i = 0; i < 6; ++i) mine.s[i] = cand.s[i];
  }
}

// The warp's winner over its lanes' `mine` (maximum gain, lowest key on
// ties) into its running best (run_gain, run_key) and s_best[warp].
__device__ __forceinline__ void warp_select(const Best& mine, float& run_gain,
                                            int& run_key, Best* s_best,
                                            int warp) {
  float wg = mine.gain;
  int wk = mine.key;
  for (int o = 16; o > 0; o >>= 1) {
    const float og = __shfl_xor_sync(lgbt::kFullMask, wg, o);
    const int ok = __shfl_xor_sync(lgbt::kFullMask, wk, o);
    if (og > wg || (og == wg && ok < wk)) { wg = og; wk = ok; }
  }
  if (wg > run_gain || (wg == run_gain && wk < run_key)) {
    run_gain = wg;
    run_key = wk;
    if (mine.key == wk) s_best[warp] = mine;
  }
}

// The index of the best of `n` candidates (gain, key) read through
// `at`: the maximum gain, the lowest key on ties (the sequential
// first-max, whatever order the candidates come in).
template <typename At>
__device__ __forceinline__ int pick_best(int n, At at) {
  int bi = 0;
  Best b = at(0);
  for (int i = 1; i < n; ++i) {
    const Best o = at(i);
    if (o.gain > b.gain || (o.gain == b.gain && o.key < b.key)) {
      bi = i;
      b = o;
    }
  }
  return bi;
}

// Thread 0 writes the winner's scalars into `pay` (nbins one-hot lanes
// follow them) and its bin, if categorical, into *s_win_bin.
__device__ __forceinline__ void write_scalars(const Best& win, int nbins,
                                              bool active, float* pay,
                                              int* s_win_bin) {
  pay[0] = active ? win.gain : -CUDART_INF_F;
  pay[1] = (float)(win.key / nbins);
  pay[2] = (float)(win.key % nbins);
  pay[3] = (!win.cat && win.dl) ? 1.f : 0.f;
  pay[4] = win.cat ? 1.f : 0.f;
  for (int i = 0; i < 6; ++i) pay[5 + i] = win.s[i];
  for (int i = 11; i < kPayloadScalars; ++i) pay[i] = 0.f;
  *s_win_bin = win.cat ? win.key % nbins : -1;
}

// The uint16 scan's geometry (any B up to 65,536): a block per (child,
// group of `fpb` features), its warps on one feature at a time, the bin
// axis staged in tiles of `tile` bins.  A child's blocks leave their bests
// in its payload's one-hot lanes (kBestFloats each, so at most B /
// kBestFloats blocks), and the last to finish picks the winner.
constexpr int kScanWideWarps = 4;
constexpr int kScanWideTile = 4096;
constexpr int kBestFloats = 12;

struct ScanGeom {
  int blocks, fpb, tile, smem;
};

inline ScanGeom scan_geom(int f, int nbins) {
  ScanGeom g;
  g.tile = nbins < kScanWideTile ? nbins : kScanWideTile;
  const int slots = nbins / kBestFloats;
  int blocks = f < slots ? f : slots;
  blocks = blocks < 1 ? 1 : blocks;
  g.fpb = (f + blocks - 1) / blocks;
  g.blocks = (f + g.fpb - 1) / g.fpb;
  g.smem = lgbt::align16(kScanWideWarps * (int)sizeof(Best) +
                         2 * (int)sizeof(int)) +
           lgbt::align16(g.tile * 3 * (int)sizeof(float) + 32);
  return g;
}

// Thread c < 3 of a block turns channel c of a staged tile (`p` = its
// first cell, stride 3; bins b0 .. b0 + tlen) into the masked cumulative
// sums, carrying `run` on from the previous tile: run = run + (bin counted
// ? cell : 0), bin by bin, as one pass over B adds.  The next kCumAhead
// cells are loaded before the current ones are added, so the chain waits
// on the adds, not on a shared-memory round trip; a run of kCumAhead bins
// below the feature's last bin and clear of its NaN bin (all but one or
// two runs) loads and adds without a mask.
constexpr int kCumAhead = 16;

__device__ __forceinline__ void cumsum_tile(float* p, int tlen, int b0,
                                            const Feat& q, float& run) {
  const int lim = min(tlen, q.nb - b0);  // bins below: in the feature
  auto load = [&](float (&x)[kCumAhead], int i) {
    if (i + kCumAhead <= lim && (unsigned)(q.nanb - b0 - i) >= kCumAhead) {
#pragma unroll
      for (int u = 0; u < kCumAhead; ++u) x[u] = p[(i + u) * 3];
    } else {
#pragma unroll
      for (int u = 0; u < kCumAhead; ++u) {
        const int k = i + u;
        x[u] = (k < lim && b0 + k != q.nanb) ? p[k * 3] : 0.f;
      }
    }
  };
  float x[kCumAhead];
  load(x, 0);
  for (int i = 0; i < tlen; i += kCumAhead) {
    float y[kCumAhead];
    load(y, i + kCumAhead);
    if (i + kCumAhead <= tlen) {
#pragma unroll
      for (int u = 0; u < kCumAhead; ++u) {
        run = run + x[u];
        p[(i + u) * 3] = run;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kCumAhead; ++u) {
        if (i + u < tlen) {
          run = run + x[u];
          p[(i + u) * 3] = run;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kCumAhead; ++u) x[u] = y[u];
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// A staged tile of `n` cells as the scan reads them: f32 as stored; int32
// (int8 mode) rescaled in place, float(h) * scale[channel] (cell()).
__device__ __forceinline__ void rescale_tile(const float*, float*, int,
                                             const float*) {}
__device__ __forceinline__ void rescale_tile(const int32_t*, float* cells,
                                             int n, const float* scale) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    cells[i] = (float)__float_as_int(cells[i]) * scale[i % 3];
  __syncthreads();
}

// The scan over uint16 bins: wave_scan_kernel's arithmetic, each child's
// features spread over gridDim.y blocks (scan_geom), a block's threads on
// one feature at a time.  Per feature and tile the block copies the cells
// to shared memory with cp.async (int8: then times the channel's scale),
// threads 0-2 turn them into the masked cumulative sums, carried from tile
// to tile (cumsum_tile: the adds of one sequential pass; the NaN bin's
// cells come from global memory first), and thread t evaluates bins b0 +
// t, b0 + t + blockDim.x, ...: each thread meets its candidates in
// ascending key order, so its first seeds its best and a later one must be
// strictly better.  The winner is the maximum gain with the lowest key on
// ties, reduced across threads, warps, then blocks: an order-free rule, so
// the payload is the sequential first-max scan's, bit for bit, and an all
// -inf child selects key 0.  Blocks meet through an integer counter in
// payload lane 15 (zeroed by the launcher): each leaves its best in the
// one-hot lanes, and the last block reads them in block order and writes
// the payload.  Keys are feature * B + bin in an int: F * B <= 2^31 - 1 (F
// < 32,768 at B = 65,536; the entry points check it).
template <typename T>
__global__ void __launch_bounds__(kScanWideWarps * 32)
wave_scan_wide_kernel(const T* __restrict__ hist,
                      const float* __restrict__ scale3,
                      const float* __restrict__ stats,
                      const int32_t* __restrict__ meta, int f, int nbins,
                      int fpb, int tile, ScanCfg c,
                      float* __restrict__ payload) {
  extern __shared__ __align__(16) unsigned char s_scan[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  Best* s_best = reinterpret_cast<Best*>(s_scan);
  int* s_win_bin = reinterpret_cast<int*>(s_best + nwarps);
  int* s_last = s_win_bin + 1;
  unsigned char* stage = s_scan + lgbt::align16(nwarps * (int)sizeof(Best) +
                                                2 * (int)sizeof(int));
  const float scale[3] = {scale3 != nullptr ? scale3[0] : 1.f,
                          scale3 != nullptr ? scale3[1] : 1.f,
                          scale3 != nullptr ? scale3[2] : 1.f};
  const int child = blockIdx.x;         // w * 2 + ci
  const float* st = stats + (int64_t)child * kStatLanes;
  const float pg = st[0], ph = st[1], pc = st[2], pout = st[3];
  const bool active = st[5] > 0.5f;
  const float pgain = c.path_smooth > 0.f ? gain_given_output(pg, ph, pout, c)
                                          : leaf_gain(pg, ph, c);
  const T* h0 = hist + (int64_t)child * f * nbins * 3;
  const int f0 = blockIdx.y * fpb;
  const int f1 = min(f, f0 + fpb);

  if (lane == 0) s_best[warp] = Best{-CUDART_INF_F, INT_MAX, 0, 0, {}};
  Best mine{-CUDART_INF_F, INT_MAX, 0, 0, {}};
  for (int feat = f0; feat < f1; ++feat) {
    const Feat q = read_feat(meta, feat, c);
    const T* hf = h0 + (int64_t)feat * nbins * 3;
    float gn = 0.f, hn = 0.f, cn = 0.f;
    if (q.nanb < nbins) {
      gn = cell(hf, q.nanb * 3 + 0, scale[0]);
      hn = cell(hf, q.nanb * 3 + 1, scale[1]);
      cn = cell(hf, q.nanb * 3 + 2, scale[2]);
    }
    float run = 0.f;                    // thread c < 3: channel c's cumsum
    for (int b0 = 0; b0 < nbins; b0 += tile) {
      const int tlen = min(tile, nbins - b0);
      const T* ht = hf + (int64_t)b0 * 3;
      const int off = lgbt::copy_async16(
          stage, reinterpret_cast<const unsigned char*>(ht), 0,
          (int64_t)tlen * 3 * (int64_t)sizeof(T));
      lgbt::cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      float* cells = reinterpret_cast<float*>(stage + off);
      rescale_tile(ht, cells, tlen * 3, scale);
      if (!q.iscat && threadIdx.x < 3)
        cumsum_tile(cells + threadIdx.x, tlen, b0, q, run);
      __syncthreads();
      for (int i = threadIdx.x; i < tlen; i += blockDim.x)
        scan_bin(mine, cells + i * 3, b0 + i, feat, nbins, q, gn, hn, cn, pg,
                 ph, pc, pout, pgain, c);
      __syncthreads();                  // the stage, for the next tile
    }
  }
  float run_gain = -CUDART_INF_F;
  int run_key = INT_MAX;
  warp_select(mine, run_gain, run_key, s_best, warp);
  __syncthreads();
  float* pay = payload + (int64_t)child * (kPayloadScalars + nbins);
  auto warp_best = [&](int i) { return s_best[i]; };
  if (gridDim.y > 1) {                  // leave this block's best, count in
    if (threadIdx.x == 0) {
      const Best& b = s_best[pick_best(nwarps, warp_best)];
      float* slot = pay + kPayloadScalars + blockIdx.y * kBestFloats;
      slot[0] = b.gain;
      slot[1] = __int_as_float(b.key);
      slot[2] = __int_as_float(b.dl);
      slot[3] = __int_as_float(b.cat);
      for (int i = 0; i < 6; ++i) slot[4 + i] = b.s[i];
      __threadfence();
      const unsigned done = atomicAdd(
          reinterpret_cast<unsigned*>(pay + kPayloadScalars - 1), 1u);
      *s_last = done == gridDim.y - 1;
    }
    __syncthreads();
    if (!*s_last) return;
    // every block's best: thread t reads blocks t, t + blockDim.x, ...
    __threadfence();
    auto block_best = [&](int i) {
      const float* slot = pay + kPayloadScalars + i * kBestFloats;
      Best b;
      b.gain = __ldcg(slot + 0);
      b.key = __float_as_int(__ldcg(slot + 1));
      b.dl = __float_as_int(__ldcg(slot + 2));
      b.cat = __float_as_int(__ldcg(slot + 3));
      for (int k = 0; k < 6; ++k) b.s[k] = __ldcg(slot + 4 + k);
      return b;
    };
    Best mb{-CUDART_INF_F, INT_MAX, 0, 0, {}};
    for (int i = threadIdx.x; i < (int)gridDim.y; i += blockDim.x) {
      const Best o = block_best(i);
      if (o.gain > mb.gain || (o.gain == mb.gain && o.key < mb.key)) mb = o;
    }
    float rg = -CUDART_INF_F;
    int rk = INT_MAX;
    if (lane == 0) s_best[warp] = Best{-CUDART_INF_F, INT_MAX, 0, 0, {}};
    __syncwarp();
    warp_select(mb, rg, rk, s_best, warp);
    __syncthreads();
    if (threadIdx.x == 0)
      write_scalars(s_best[pick_best(nwarps, warp_best)], nbins, active, pay,
                    s_win_bin);
  } else if (threadIdx.x == 0) {
    write_scalars(s_best[pick_best(nwarps, warp_best)], nbins, active, pay,
                  s_win_bin);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += blockDim.x)
    pay[kPayloadScalars + b] = b == *s_win_bin ? 1.f : 0.f;
}

template <typename T>
int launch_scan(const T* hist, const float* scale3, const float* stats,
                const int32_t* meta, int f, int nbins, int w, ScanCfg c,
                float* payload, cudaStream_t s) {
  const int warps = lgbt::warps_for(f);
  const int smem = scan_smem(warps, nbins);
  const int err = lgbt::smem_opt_in(wave_scan_kernel<T>, smem);
  if (err != 0) return err;
  wave_scan_kernel<T><<<(unsigned)(2 * w), 32 * warps, smem, s>>>(
      hist, scale3, stats, meta, f, nbins, c, payload);
  return (int)cudaGetLastError();
}

// The uint16 scan: a memset of the blocks' counters (payload lane 15 of
// each child) where a child has more than one block, then the scan.
template <typename T>
int launch_scan_wide(const T* hist, const float* scale3, const float* stats,
                     const int32_t* meta, int f, int nbins, int w, ScanCfg c,
                     float* payload, cudaStream_t s) {
  const ScanGeom g = scan_geom(f, nbins);
  const size_t pitch = (size_t)(kPayloadScalars + nbins) * sizeof(float);
  int err = 0;
  if (g.blocks > 1) {
    err = (int)cudaMemset2DAsync(payload + kPayloadScalars - 1, pitch, 0,
                                 sizeof(float), (size_t)(2 * w), s);
    if (err != 0) return err;
  }
  err = lgbt::smem_opt_in(wave_scan_wide_kernel<T>, g.smem);
  if (err != 0) return err;
  const dim3 grid((unsigned)(2 * w), (unsigned)g.blocks);
  wave_scan_wide_kernel<T><<<grid, 32 * kScanWideWarps, g.smem, s>>>(
      hist, scale3, stats, meta, f, nbins, g.fpb, g.tile, c, payload);
  return (int)cudaGetLastError();
}

// The uint16 entry points' shape check: up to kMaxBinsWide bins, and
// every key feature * B + bin an int.
inline bool wide_shape_ok(int f, int nbins, int w, int total_chunks) {
  return nbins >= 1 && nbins <= lgbt::kMaxBinsWide && f >= 1 && w >= 1 &&
         total_chunks >= 0 && (int64_t)f * nbins <= INT_MAX;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Three launches on `stream`
// (accumulate, combine + subtract, scan + select); does not synchronise;
// returns the first CUDA error.  `seg` is the device segment table of
// hist_common.cuh for the W smaller siblings; `partial` is scratch of
// total_chunks * f * nbins * 3 floats.  `vals` is (N, 3) f32, or
// __nv_bfloat16 with `bf16`; `bins` (N, F) uint8, or (N, ceil(F/2)) nibble
// pairs with `packed4`; `f` the real F.
extern "C" int lgbt_wave(const void* bins, const void* vals, const void* perm,
                         int f, int nbins, const void* seg, int w,
                         int total_chunks, int chunk_rows, const void* parent,
                         const void* stats, const void* meta, float l1,
                         float l2, float min_count, float min_hess,
                         float gain_thr, float max_delta, float path_smooth,
                         int has_nan, int has_cat, int max_cat_onehot,
                         int packed4, int bf16, void* partial,
                         void* out_hist, void* payload, void* stream) {
  if (nbins < 1 || nbins > lgbt::kMaxBins || f < 1 || w < 1 ||
      total_chunks < 0 || (packed4 && nbins > 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total_chunks > 0) {
    const int err = lgbt::launch_accumulate<true>(
        bins, f, vals, packed4 != 0, bf16 != 0, (const int32_t*)perm,
        (const int32_t*)seg, w, 0, chunk_rows, nbins, total_chunks,
        (float*)partial, s);
    if (err != 0) return err;
  }
  const int64_t cells = (int64_t)f * nbins * 3;
  const dim3 cgrid((unsigned)((cells + 255) / 256), (unsigned)w);
  lgbt::hist_combine_kernel<<<cgrid, 256, 0, s>>>(
      (const float*)partial, (const int32_t*)seg, w, 0, cells,
      (const float*)parent, (const float*)stats, (float*)out_hist);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const ScanCfg c{l1, l2, min_count, min_hess, gain_thr, max_delta,
                  path_smooth, has_nan, has_cat, max_cat_onehot};
  return launch_scan((const float*)out_hist, nullptr, (const float*)stats,
                     (const int32_t*)meta, f, nbins, w, c, (float*)payload,
                     s);
}

// int8 mode: `vals` (N, 3) int8, `parent` (W, F, B, 3) int32, `scale3` 3
// device f32 channel scales, `partial` scratch of the chunk partials,
// total_chunks * F * B * 3 int32, `out_hist` (W, 2, F, B, 3) int32; `bins`
// as above; blocks of `fpb` features and `tile` bins
// (ops/histogram_flat.py::int8_shape).  Three launches on `stream`
// (accumulate, combine, scan); does not synchronise; returns the first
// CUDA error.
extern "C" int lgbt_wave_i8(const void* bins, const void* vals,
                            const void* perm, int f, int nbins,
                            const void* seg, int w, int total_chunks,
                            int chunk_rows, int fpb, int tile,
                            const void* parent,
                            const void* stats, const void* meta,
                            const void* scale3, float l1, float l2,
                            float min_count, float min_hess, float gain_thr,
                            float max_delta, float path_smooth, int has_nan,
                            int has_cat, int max_cat_onehot, int packed4,
                            void* partial, void* out_hist, void* payload,
                            void* stream) {
  if (nbins < 1 || nbins > lgbt::kMaxBins || f < 1 || w < 1 ||
      total_chunks < 0 || (packed4 && nbins > 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t cells = (int64_t)f * nbins * 3;
  int err = 0;
  if (total_chunks > 0) {
    err = lgbt::launch_accumulate_i8<true>(
        bins, f, vals, packed4 != 0, (const int32_t*)perm,
        (const int32_t*)seg, w, 0, chunk_rows, nbins, fpb, tile,
        total_chunks, (int32_t*)partial, s);
    if (err != 0) return err;
  }
  err = lgbt::launch_combine_i8((const int32_t*)partial, (const int32_t*)seg,
                                w, 0, cells, total_chunks,
                                (const int32_t*)parent, (const float*)stats,
                                (int32_t*)out_hist, s);
  if (err != 0) return err;
  const ScanCfg c{l1, l2, min_count, min_hess, gain_thr, max_delta,
                  path_smooth, has_nan, has_cat, max_cat_onehot};
  return launch_scan((const int32_t*)out_hist, (const float*)scale3,
                     (const float*)stats, (const int32_t*)meta, f, nbins, w,
                     c, (float*)payload, s);
}

// uint16 bins, f32 / bf16 values: lgbt_wave over (N, F) uint16 bins
// (never packed), up to kMaxBinsWide bins, its scan tiled over the bins
// (wave_scan_wide_kernel).  `partial` is total_chunks * f * nbins * 3
// floats, as above.
extern "C" int lgbt_wave_u16(const void* bins, const void* vals,
                             const void* perm, int f, int nbins,
                             const void* seg, int w, int total_chunks,
                             int chunk_rows, const void* parent,
                             const void* stats, const void* meta, float l1,
                             float l2, float min_count, float min_hess,
                             float gain_thr, float max_delta,
                             float path_smooth, int has_nan, int has_cat,
                             int max_cat_onehot, int bf16, void* partial,
                             void* out_hist, void* payload, void* stream) {
  if (!wide_shape_ok(f, nbins, w, total_chunks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total_chunks > 0) {
    const int err = lgbt::launch_accumulate_wide<true>(
        bins, f, vals, bf16 != 0, (const int32_t*)perm, (const int32_t*)seg,
        w, 0, chunk_rows, nbins, total_chunks, (float*)partial, s);
    if (err != 0) return err;
  }
  const int64_t cells = (int64_t)f * nbins * 3;
  const dim3 cgrid((unsigned)((cells + 255) / 256), (unsigned)w);
  lgbt::hist_combine_kernel<<<cgrid, 256, 0, s>>>(
      (const float*)partial, (const int32_t*)seg, w, 0, cells,
      (const float*)parent, (const float*)stats, (float*)out_hist);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const ScanCfg c{l1, l2, min_count, min_hess, gain_thr, max_delta,
                  path_smooth, has_nan, has_cat, max_cat_onehot};
  return launch_scan_wide((const float*)out_hist, nullptr,
                          (const float*)stats, (const int32_t*)meta, f,
                          nbins, w, c, (float*)payload, s);
}

// uint16 bins, int8 values: lgbt_wave_i8 over (N, F) uint16 bins, its
// scan tiled as in lgbt_wave_u16.
extern "C" int lgbt_wave_i8_u16(const void* bins, const void* vals,
                                const void* perm, int f, int nbins,
                                const void* seg, int w, int total_chunks,
                                int chunk_rows, int fpb, int tile,
                                const void* parent,
                                const void* stats, const void* meta,
                                const void* scale3, float l1, float l2,
                                float min_count, float min_hess,
                                float gain_thr, float max_delta,
                                float path_smooth, int has_nan, int has_cat,
                                int max_cat_onehot, void* partial,
                                void* out_hist, void* payload, void* stream) {
  if (!wide_shape_ok(f, nbins, w, total_chunks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t cells = (int64_t)f * nbins * 3;
  int err = 0;
  if (total_chunks > 0) {
    err = lgbt::launch_accumulate_i8<true, uint16_t>(
        bins, f, vals, false, (const int32_t*)perm, (const int32_t*)seg, w,
        0, chunk_rows, nbins, fpb, tile, total_chunks, (int32_t*)partial, s);
    if (err != 0) return err;
  }
  err = lgbt::launch_combine_i8((const int32_t*)partial, (const int32_t*)seg,
                                w, 0, cells, total_chunks,
                                (const int32_t*)parent, (const float*)stats,
                                (int32_t*)out_hist, s);
  if (err != 0) return err;
  const ScanCfg c{l1, l2, min_count, min_hess, gain_thr, max_delta,
                  path_smooth, has_nan, has_cat, max_cat_onehot};
  return launch_scan_wide((const int32_t*)out_hist, (const float*)scale3,
                          (const float*)stats, (const int32_t*)meta, f,
                          nbins, w, c, (float*)payload, s);
}
