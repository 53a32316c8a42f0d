// Fused wave step for Hopper (sm_90a): smaller-sibling histograms ->
// sibling subtraction -> split scan -> winner selection, for the W leaves
// that split in one wave of leaf-wise growth.
//
// Replaces lightgbm_tpu/ops/pallas_wave.py::fused_wave_call (body
// _wave_kernel), every mode; f32 first.  For each wave slot w:
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
// What bounds it on this card: operations.  Stage 1 is the histogram
// kernel's one-hot accumulation over the smaller siblings' rows (R * F * B
// compares for R rows in the wave); the bytes are the rows' bins and
// values plus the W parent histograms read and 2W child histograms
// written (~86 KB each at F = 28, B = 255).  The scan is 2W * F * B
// candidates, each a few dozen flops, but this first version runs it with
// only 2W blocks of one thread per feature, so on small waves the scan's
// latency, not stage 1, takes most of the kernel's time.
//
// What the design does about it (a simple first version, deterministic):
//   - stage 1 splits every sibling's rows into chunks over many blocks
//     (a wave has only 1-16 leaves, so one block per leaf would leave most
//     of the 132 SMs idle); chunk partials are summed in chunk order by a
//     second launch, which also subtracts from the parent and orders the
//     pair (hist_common.cuh).  No float atomics;
//   - stage 3 runs one block per child and one thread per feature: the
//     cumulative sums run sequentially over bins in f32, the candidates
//     of each feature are compared in bin order, and a block reduction
//     keeps (gain, key) with the lowest key on ties;
//   - built with --fmad=false so every a*b+c rounds twice, as the plain
//     version's separate torch ops round.
// Later work: keep the child histograms in shared memory between the
// stages (one child is 86 KB at the bench shape, within the 227 KB a block
// may opt into), a warp-parallel prefix scan, fusing the partition.
//
// int8 mode (quantized training; the TPU kernel with dtype="int8" and its
// scale3 operand), the same three launches: stage 1 accumulates each
// smaller sibling's int8 levels into an int32 histogram (the histogram
// kernel's privatized shared-memory design, flushed with integer atomics:
// exact in any order); the combine computes parent - smaller in int32 and
// orders the pair; the child histograms come out int32, as the grower
// stores them; the scan reads each cell as float(h) * scale[c] (one
// multiply, as the JAX package's _scale_hist and _wave_kernel do), then
// runs the f32 scan unchanged.  The scales stay on the device (a pointer),
// so quantized growth adds no device-to-host copy.
//
// bf16 and packed4 modes: stage 1 runs the histogram kernel's bf16 and
// packed4 loaders (hist_common.cuh): bf16 values are widened to f32 as
// they are staged, `bins[perm[i], f]` reads become nibble reads of
// `bins4[perm[i], f / 2]`, and the accumulation, the combine and the scan
// are unchanged.  So a bf16 wave gives the bits of an f32 wave on the
// bf16-rounded values, and a packed4 wave those of the unpacked wave on
// the same rows, in every value type.  The child histograms stay in the
// grower's (F, B, 3) original feature order: the TPU kernel's nibble
// planes, and the original-order tie-break keys they force, fall away
// (the scan already breaks ties in original order).  An odd F's phantom
// high nibble is never read: feature groups stop at F.

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

// One block per (slot, child); thread t scans features t, t + blockDim, ...
// hist: (W, 2, F, B, 3) f32 or int32; scale3: 3 f32 channel scales (int8
// mode; nullptr for f32); stats: (W, 2, 8) [pg, ph, pc, pout, small_left,
// active, 0, 0]; meta: (F, 4) int32 [num_bins, nan_bin, is_cat, fmask].
template <typename T>
__global__ void wave_scan_kernel(const T* __restrict__ hist,
                                 const float* __restrict__ scale3,
                                 const float* __restrict__ stats,
                                 const int32_t* __restrict__ meta, int f,
                                 int nbins, ScanCfg c,
                                 float* __restrict__ payload) {
  __shared__ float s_gain[1024];
  __shared__ int s_key[1024];
  __shared__ int s_win[3];  // key, bin, is_cat
  const float sg = scale3 != nullptr ? scale3[0] : 1.f;
  const float sh = scale3 != nullptr ? scale3[1] : 1.f;
  const float sc = scale3 != nullptr ? scale3[2] : 1.f;
  const int child = blockIdx.x;         // w * 2 + ci
  const float* st = stats + (int64_t)child * kStatLanes;
  const float pg = st[0], ph = st[1], pc = st[2], pout = st[3];
  const bool active = st[5] > 0.5f;
  const float pgain = c.path_smooth > 0.f ? gain_given_output(pg, ph, pout, c)
                                          : leaf_gain(pg, ph, c);
  const T* h0 = hist + (int64_t)child * f * nbins * 3;

  float best_gain = -CUDART_INF_F;
  int best_key = 0x7fffffff;
  bool best_dl = false, best_cat = false;
  float best_s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int feat = threadIdx.x; feat < f; feat += blockDim.x) {
    const int nb = meta[feat * 4 + 0];
    const int nanb = meta[feat * 4 + 1];
    const bool iscat = c.has_cat && meta[feat * 4 + 2] != 0;
    const bool fm = meta[feat * 4 + 3] != 0;
    const bool sorted_el = iscat && nb > c.max_cat_onehot;
    const T* hf = h0 + (int64_t)feat * nbins * 3;
    float gn = 0.f, hn = 0.f, cn = 0.f;
    if (nanb < nbins) {
      gn = cell(hf, nanb * 3 + 0, sg);
      hn = cell(hf, nanb * 3 + 1, sh);
      cn = cell(hf, nanb * 3 + 2, sc);
    }
    float cg = 0.f, ch = 0.f, cc = 0.f;
    for (int b = 0; b < nbins; ++b) {
      const float g = cell(hf, b * 3 + 0, sg), h = cell(hf, b * 3 + 1, sh),
                  cnt = cell(hf, b * 3 + 2, sc);
      const bool in_f = b < nb;
      const bool vm = in_f && b != nanb;
      cg = cg + (vm ? g : 0.f);
      ch = ch + (vm ? h : 0.f);
      cc = cc + (vm ? cnt : 0.f);
      Cand cand;
      bool dl = false;
      float gain;
      if (iscat) {
        cand = eval_dir(g, h, cnt, pg, ph, pc, pout, pgain, c);
        gain = in_f ? cand.gain : -CUDART_INF_F;
      } else {
        const Cand mr = eval_dir(cg, ch, cc, pg, ph, pc, pout, pgain, c);
        cand = mr;
        gain = mr.gain;
        if (c.has_nan) {
          const Cand ml = eval_dir(cg + gn, ch + hn, cc + cn, pg, ph, pc,
                                   pout, pgain, c);
          const float gml = nanb < nbins ? ml.gain : -CUDART_INF_F;
          gain = fmaxf(mr.gain, gml);
          dl = gml > mr.gain;
          if (dl) cand = ml;
        }
        if (!vm) gain = -CUDART_INF_F;
      }
      if (sorted_el || !fm) gain = -CUDART_INF_F;
      // in key order: the first candidate seeds the best (an all -inf
      // block selects key 0, as the plain version's min-key tie-break)
      if (best_key == 0x7fffffff || gain > best_gain) {
        best_gain = gain;
        best_key = feat * nbins + b;
        best_dl = dl;
        best_cat = iscat;
        for (int i = 0; i < 6; ++i) best_s[i] = cand.s[i];
      }
    }
  }
  s_gain[threadIdx.x] = best_gain;
  s_key[threadIdx.x] = best_key;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      const float og = s_gain[threadIdx.x + stride];
      const int ok = s_key[threadIdx.x + stride];
      const float mg = s_gain[threadIdx.x];
      if (og > mg || (og == mg && ok < s_key[threadIdx.x])) {
        s_gain[threadIdx.x] = og;
        s_key[threadIdx.x] = ok;
      }
    }
    __syncthreads();
  }
  const int win_key = s_key[0];
  float* pay = payload + (int64_t)child * (kPayloadScalars + nbins);
  if (best_key == win_key) {
    pay[0] = active ? best_gain : -CUDART_INF_F;
    pay[1] = (float)(win_key / nbins);
    pay[2] = (float)(win_key % nbins);
    pay[3] = (!best_cat && best_dl) ? 1.f : 0.f;
    pay[4] = best_cat ? 1.f : 0.f;
    for (int i = 0; i < 6; ++i) pay[5 + i] = best_s[i];
    for (int i = 11; i < kPayloadScalars; ++i) pay[i] = 0.f;
    s_win[0] = win_key;
    s_win[1] = win_key % nbins;
    s_win[2] = best_cat ? 1 : 0;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbins; b += blockDim.x)
    pay[kPayloadScalars + b] = (s_win[2] && b == s_win[1]) ? 1.f : 0.f;
}

// int8 mode combine: larger sibling = parent - smaller in int32, the pair
// written as (left, right) by the small_left lane (4) of `stats`.
// small: (W, cells) int32; parent: (W, cells); out: (W, 2, cells).
__global__ void hist_combine_i8_kernel(const int32_t* __restrict__ small,
                                       int64_t cells,
                                       const int32_t* __restrict__ parent,
                                       const float* __restrict__ stats,
                                       int32_t* __restrict__ out) {
  const int w = blockIdx.y;
  const int64_t cell_i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (cell_i >= cells) return;
  const int32_t s = small[(int64_t)w * cells + cell_i];
  const int32_t big = parent[(int64_t)w * cells + cell_i] - s;
  const bool small_left = stats[(int64_t)w * 16 + 4] > 0.5f;
  out[((int64_t)w * 2 + 0) * cells + cell_i] = small_left ? s : big;
  out[((int64_t)w * 2 + 1) * cells + cell_i] = small_left ? big : s;
}

template <typename T>
int launch_scan(const T* hist, const float* scale3, const float* stats,
                const int32_t* meta, int f, int nbins, int w, ScanCfg c,
                float* payload, cudaStream_t s) {
  int threads = 32;
  while (threads < f && threads < 1024) threads *= 2;
  wave_scan_kernel<T><<<(unsigned)(2 * w), threads, 0, s>>>(
      hist, scale3, stats, meta, f, nbins, c, payload);
  return (int)cudaGetLastError();
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
  if (nbins < 1 || nbins > lgbt::kThreads || f < 1 || w < 1 ||
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
// device f32 channel scales, `small` scratch of W * F * B * 3 int32 (zeroed
// here), `out_hist` (W, 2, F, B, 3) int32; `bins` as above.  Three
// launches on `stream` (accumulate, combine, scan); does not synchronise;
// returns the first CUDA error.
extern "C" int lgbt_wave_i8(const void* bins, const void* vals,
                            const void* perm, int f, int nbins,
                            const void* seg, int w, int total_chunks,
                            int chunk_rows, const void* parent,
                            const void* stats, const void* meta,
                            const void* scale3, float l1, float l2,
                            float min_count, float min_hess, float gain_thr,
                            float max_delta, float path_smooth, int has_nan,
                            int has_cat, int max_cat_onehot, int packed4,
                            void* small, void* out_hist, void* payload,
                            void* stream) {
  if (nbins < 1 || nbins > lgbt::kThreads || f < 1 || w < 1 ||
      total_chunks < 0 || (packed4 && nbins > 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t cells = (int64_t)f * nbins * 3;
  int err = (int)cudaMemsetAsync(small, 0, (size_t)w * cells * 4, s);
  if (err != 0) return err;
  if (total_chunks > 0) {
    err = lgbt::launch_accumulate_i8<true>(
        bins, f, vals, packed4 != 0, (const int32_t*)perm,
        (const int32_t*)seg, w, 0, chunk_rows, nbins, total_chunks,
        (int32_t*)small, s);
    if (err != 0) return err;
  }
  const dim3 cgrid((unsigned)((cells + 255) / 256), (unsigned)w);
  hist_combine_i8_kernel<<<cgrid, 256, 0, s>>>(
      (const int32_t*)small, cells, (const int32_t*)parent,
      (const float*)stats, (int32_t*)out_hist);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const ScanCfg c{l1, l2, min_count, min_hess, gain_thr, max_delta,
                  path_smooth, has_nan, has_cat, max_cat_onehot};
  return launch_scan((const int32_t*)out_hist, (const float*)scale3,
                     (const float*)stats, (const int32_t*)meta, f, nbins, w,
                     c, (float*)payload, s);
}
