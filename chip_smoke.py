#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Drives the port's main paths (serving, training, quantized training,
bf16 and 4-bit-bin training, training at max_bin 1023 over uint16 bins,
unfused and through the fused wave; the regression, multiclass and other
objectives with a valid set, metrics and early stopping; text-file input,
model text loading, continued training and per-feature bins; bagging,
GOSS and feature_fraction, cv, and learning to rank; sorted many-vs-many
categorical splits; exclusive feature bundling; the histogram pool and
the tiled split scan) at full width and
holds every kernel against its plain PyTorch version and every result
against an independent reference.

Serving (slice 1) — quantized serving through the hand-written CUDA
traversal kernel at the width of the bench's headline ensemble (binary,
28 features, max_bin 255, 500 trees of 255 leaves; weights random from
the seed):

1. device: the card, its power limit and the CUDA version;
2. build: the kernels, built with nvcc from ops/csrc, one nvcc per source
   in parallel (seconds, and the ptxas register / shared-memory report);
3. model: a higgs-like matrix binned by the port, 500 random trees, int16
   and int8 packs; and a small categorical model;
4. traversal kernel vs its plain version, bitwise, for both models and
   both packs at N in {1, 33, 4096, 65536}; and (slice 10) on packs of
   edge-case trees (``edge_case_trees``: categorical nodes, single-leaf
   and chain trees; 21 x 255 and 3 x 5,000 leaves), with the rows' bins
   staged in shared memory and read from global memory;
5. device binning vs the port's host binning, bitwise, on 65,536 rows with
   NaN, zero-as-missing and categorical edge values;
6. serving: Predictor requests of 1, 7, 256, 4096 and 65,536 rows, each
   equal bit for bit to a vectorized numpy walk of the same pack, one
   transformed request within 1e-6 of the float32 sigmoid, and exactly one
   kernel launch per request;
7. timing: traversal kernel (CUDA events, and device ms a launch by
   kernel name) at 1, 4,096, 65,536 and 1,048,576 rows, int16 and int8
   packs, its bound, and the plain version's time (int16).

Training (slice 2) — binary GBDT through the hand-written CUDA histogram
and fused-wave kernels:

8. histogram kernel vs its plain version: bitwise on exact-sum values
   (+-0.5, 0.25, 1) at N in {1, 1,000, 200,000} x 28 features x 255 bins
   with NaN bins; run-to-run bitwise and within 1e-5 relative on random
   values;
9. wave kernel vs its plain version at W in {1, 16} with inactive slots
   and smaller siblings of 1 to 100,000 rows: child histograms and split
   payloads bitwise on exact-sum values; on random values run-to-run
   bitwise, and held to the plain version (``wave_agreement``): child
   histograms and winner sums within 1e-5 relative, counts equal, gains
   within float32's rounding bound of the split scan;
10. training: tests/fixtures/bench_auc.json's config (255 leaves, 100
    iterations) plus tpu_leaf_batch 16 on make_higgs_like(250,000, 28,
    seed 0) through ``lightgbm_tpu_torch.train``; holdout AUC within 1e-3
    of genuine LightGBM's, seconds per iteration (binning, once, and
    boosting) and each kernel's launches per iteration;
11. determinism: two 10-iteration runs give equal model text;
12. serving the trained model: ``Booster.serving_predictor(quantize=
    "int16")`` on 65,536 holdout rows within the pack's error bound of
    ``Booster.predict(raw_score=True)``;
13. profile: a fresh booster warmed up 3 iterations, then 5 under
    ``torch.profiler``: host milliseconds per iteration in each of the
    port's ``record_function`` ranges (``gbdt/*``, ``grower/*``), the
    device's busy and idle share of the window, the top kernels;
14. timing: histogram kernel at N = 200,000 and 10,500,000, wave kernel
    at a wave of 16 smaller siblings of 12,500 rows, plain versions, the
    index_add_ yardstick, and each bound.

Quantized training (slice 3) — ``use_quantized_grad`` through the int8
modes of the histogram and fused-wave kernels:

15. int8 histogram kernel vs its plain version (int32 sums), bitwise, at
    N in {1, 1,000, 200,000} x 28 features x 255 bins with NaN bins;
16. int8 wave kernel vs its plain version at W in {1, 16}: child
    histograms (int32) and counts bitwise on any levels, payloads bitwise
    on power-of-two scales and held by ``wave_agreement`` on ordinary
    ones;
17. quantized training: phase 10's config and binned rows plus
    ``use_quantized_grad``; holdout AUC within 3e-3 of genuine LightGBM's
    quantized run, seconds per iteration, the int8 kernels' launches (and
    no f32 launch); two 10-iteration runs give equal model text; the
    ``torch.profiler`` split of phase 13;
18. timing: int8 histogram kernel at N = 200,000 and 10,500,000 (the
    int32 ``index_add_`` yardstick), int8 wave kernel at 16 x 12,500, plain
    versions and bounds.

bf16 values and 4-bit bins (slice 4) — the last modes of the two
training kernels: bf16 (``tpu_histogram_impl=flat_bf16``), and packed4
(``max_bin`` <= 15: two 4-bit bins a byte) with f32, bf16 and int8
values:

19. histogram kernel, each new mode vs its plain version at F = 28 and
    27 (B = 255 for bf16, 16 packed) and N in {1, 1,000, 200,000}:
    bitwise on exact sums, within 1e-5 relative on random values
    (bitwise on int8 levels), run-to-run bitwise, and bitwise equal to
    the kernel's own f32 launch on the bf16-rounded values / unpacked
    launch on the same rows;
20. wave kernel, the same modes at W = 1 and W = 16 with inactive slots:
    bitwise on exact sums (int8: histograms always, payloads on
    power-of-two scales), ``wave_agreement`` otherwise, and bitwise equal
    to its own f32 / unpacked launch;
21. packed4 training: the bench rows binned once at max_bin 15, 50
    iterations f32, quantized and bf16 (fused; 100 until slice 13); the device bins are
    (200,000, 14) uint8, only the packed4 modes launch, and the model text
    equals the same run's with tpu_4bit_bins=false but for the parameter
    line recording that option; holdout AUC, s/iteration and resident
    bin bytes, packed and unpacked;
22. bf16 training at the bench config: fused, 100 iterations, holdout AUC
    within 3e-3 of genuine LightGBM's; unfused (``auto``), 10 iterations
    (20 until slice 13),
    one bf16 histogram launch per root and per smaller sibling (= the
    trees' leaves); two 10-iteration fused runs give equal model text;
23. timing of each new mode: histogram at N = 200,000 and 10,500,000, wave
    at 16 x 12,500, plain versions, bounds, and the ``index_add_``
    yardstick over the bf16-rounded values for bf16 (no single PyTorch
    call unpacks the nibbles: none for packed4).

The f32 / bf16 accumulation and the split scan of both kernels keep
every sum's order, so their results are checked bit for bit on random
values, not only on exact sums:

24. histogram kernel in f32, bf16, f32_packed4 and bf16_packed4 against
    ``ops/histogram.py::histogram_chunked`` (the plain twin of its
    summation order) at N in {1, 1,000, 20,000, 200,000}, F = 28 (and 27
    packed), random values, bit for bit; also with every row in one bin
    (32 lanes in one group), at B = 1 and B = 256, and odd F packed;
25. wave kernel's child histograms in the same four modes against
    ``ops/wave.py::wave_hists_chunked`` at W = 1 and W = 16 with inactive
    slots, random values, bit for bit (payloads: ``wave_agreement``), and
    a wave whose children have no valid split (all gains -inf: the
    payload of key 0, equal to the plain version's).

uint16 bins (slice 7, ``max_bin`` above 255): the histogram kernel's
uint16 modes, in f32, bf16 and int8, on the unfused wave path:

26. histogram kernel in f32_uint16, bf16_uint16 and int8_uint16 against
    its twin (``hist_twin``: ``histogram_chunked``, the plain twin of the
    f32 / bf16 summation order; ``histogram_segment`` for int8) bit for
    bit on random values at B in {257, 511, 1,023, 4,095, 65,536} (the
    last in eight bin tiles) and N in {1, 1,000, 200,000} (B = 65,536 at
    N <= 1,000), and 10,500,000 rows at B = 1,023; rows gathered through
    a permutation; and the unfused wave step over 16 smaller siblings
    (``wave_plain`` with the kernel vs with the twin, child histograms
    and payloads bit for bit);
27. training at max_bin 1023 on the bench rows, binned once (seconds
    reported, uint16 bins on the card), ``tpu_wave_kernel=unfused``: f32
    10 iterations, quantized 5, bf16 3, each launching only its uint16
    histogram mode and no wave kernel; the holdout AUC beside the 255-bin
    f32 run's at 10 iterations (no gate: no genuine-LightGBM number at
    1,023 bins); two 2-iteration f32 runs give equal model text, and
    2-iteration f32 and quantized runs with ``histogram_flat`` swapped for
    ``hist_twin`` give the kernel runs' model text; the f32 model served
    through ``Predictor`` (int16 pack) equals the numpy walk bit for bit;
28. timing of the uint16 modes at B = 1,023, N = 200,000 and 10,500,000:
    kernel, device ms by launch, plain version, ``index_add_``, bounds.

The fused wave over uint16 bins (slice 8): the wave kernel's uint16
modes, so max_bin above 255 trains through the fused wave:

29. wave kernel in f32_uint16, bf16_uint16 and int8_uint16 against
    ``wave_plain`` and ``wave_hists_chunked`` at B in {257, 511, 1,023,
    2,047, 4,095} (the scan tiled from 2,047), F = 28 and 27, W = 1 and
    W = 16 with inactive slots, and B = 65,536 at W = 1 over 300 rows:
    child histograms and payloads bit for bit on exact sums (int8:
    power-of-two scales); on random values child histograms bit for bit
    the twin's (int8: the plain version's) and payloads within
    ``wave_agreement``; the same at B = 1,023, W = 16 on bins that push
    the redesigned kernels (slice 9): every row of a feature in one bin,
    runs of 32 rows and pairs on one bin; an exact gain tie across two
    scan blocks (features 1 and 25 at B = 257 and 1,023) that must select
    the lower key; a wave with no valid split at B = 2,047;
30. fused training at max_bin 1023, 30 iterations: f32 and quantized
    under ``auto``, bf16 with ``flat_bf16`` and ``tpu_wave_kernel=fused``;
    only the ``<mode>_uint16`` wave launches, plus one uint16 histogram a
    tree (the root); s/iteration and holdout AUC beside phase 27's
    unfused runs and the 255-bin run's; two 10-iteration runs give equal
    model text (f32, quantized), and the fused f32 AUC at 10 iterations
    is within 1e-3 of the unfused run's; the ``torch.profiler`` split of
    phase 13 for the fused f32 run;
31. timing of the three uint16 wave modes at W = 16 x 12,500, F = 28, B =
    1,023 (and f32 at 511, int8 at 2,047, and f32 at B = 1,023 over W = 4
    and W = 1 siblings of 12,500 rows, where the scan has the fewest
    blocks): kernel, device ms by launch, plain version, bound, launches
    per iteration.

Slice 9 redesigned the uint16 accumulation (both kernels' stage 1) and
the uint16 split scan for Hopper, bit for bit the earlier sums: phases
26, 28, 29 and 31 hold and time them.

Slice 10 redesigned the int8 accumulation (both kernels' stage 1 in the
int8 modes: blocks of 8 features, int32 chunk partials summed by the
int8 combine) and the traversal kernel (a node record a step, the rows'
bins in shared memory), bit for bit the earlier results: phases 15, 16,
26 and 29 also hold the int8 modes on hot-bin rows (``I8_HOT_PATTERNS``:
one bin a feature, runs of 32 rows, half the rows in the NaN bin) and at
W = 1 and 4 (``I8_SMALL_WAVES``); phases 18, 28 and 31 time them there;
phases 4 and 7 hold and time the traversal.

The objectives, valid sets, metrics and early stopping (slice 11):
every non-ranking objective trains through the histogram and fused-wave
kernels on the bench rows (binned once, phase 10's dataset with each
run's labels; the 50,000 holdout rows binned once with the training
mappers, ``Dataset(reference=...)``, as the valid set), each run held
to the JAX package's holdout metrics (``tests/fixtures/
torch_objectives_ref.json``, made on the CPU by
``tools/gen_torch_objectives_fixture.py``; labels from
``objective_data``).  Each phase reports s/iteration, the binning
seconds, each kernel's launches per iteration with its mode, and checks
that only the expected modes launched, one root histogram a tree:

32. L2, f32, 100 iterations: the last recorded holdout l2 within 0.5%
    relative of the fixture's and within 1e-6 of a host recompute from
    ``Booster.predict``; two 10-iteration runs give equal model text;
33. L2, quantized, 50 iterations (the fixture's 100 cut for the time
    limit): int8 modes only, l2 within 1%;
34. ``regression_l1``, 20 iterations: the host percentile leaf renewal
    once a tree (its seconds per iteration), l1 within 0.5%; then phase
    13's ``torch.profiler`` split of an L1 iteration (``gbdt/renew``);
35. 4-class multiclass, 25 iterations (the fixture's 100 cut for the
    time limit): 4 trees (and 4 root histograms)
    an iteration, ``multi_logloss`` within 0.5% relative and
    ``multi_error`` within 5e-3 of the fixture's, two 5-iteration runs
    give equal model text; served through ``serving_predictor(quantize=
    "int16")`` on 65,536 holdout rows: (N, 4) raw scores bit for bit a
    numpy walk of each class's pack, one traversal launch per class pack
    a request (as the JAX package runs its kernel, a pass a class), the
    probabilities the float32 softmax of the served raw scores within
    1e-6, and the fp32 pack's equal to ``Booster.predict``; then phase
    13's ``torch.profiler`` split of a multiclass iteration;
36. early stopping: L2 with ``early_stopping_round`` 5 in params and
    learning rate 0.5, up to 300 rounds: it stops before 300, five rounds
    after ``best_iteration`` = 1 + the argmin of the
    ``record_evaluation`` history, and ``predict`` equals
    ``predict(num_iteration=best_iteration)`` bit for bit;
37. every other non-ranking objective (huber, fair, poisson, quantile,
    mape, gamma, tweedie, multiclassova, cross_entropy,
    cross_entropy_lambda), 10 iterations: finite, within 1% relative of
    the fixture's metric (multi_error: 5e-3; poisson: of the whole
    negative log-likelihood, the metric plus the mean(log(y!)) it
    leaves out, since the metric itself is near zero), and two runs give
    equal model text.

Text-file input, model text and continued training (slice 12), at the
bench width through the histogram and fused-wave kernels (data files in
a temporary directory):

38. file input: phase 10's 200,000 training rows written as TSV (label in
    column 0, ``%.17g``, so the text round trip is exact) and read by
    ``Dataset(path)`` at the bench params: ``mappers_to_arrays`` and the
    bin matrix byte for byte phase 10's array dataset's; 10 iterations
    through the fused wave give the first 10 ``Tree=`` blocks of phase
    10's model byte for byte; the parse and binning seconds;
39. genuine LightGBM's model text (``tests/fixtures/ref_model.txt``)
    loaded on the card: ``ref_rows.tsv`` predicted within 1e-6 of the
    genuine binary's ``ref_preds_50.txt``; the re-serialized text reloads
    to the same raw scores bit for bit;
40. phase 10's 100 x 255-leaf model saved and loaded in the port: the
    50,000 holdout rows' raw scores within 1e-6 plus the fp32 pack's own
    summation bound of the trained booster's, holdout AUC equal within
    1e-6; the load seconds and the predict's milliseconds;
41. continued training: phase 10's model cut to 50 iterations, continued
    50 with ``init_model=`` on phase 10's binned rows (kept: only the
    init score changes): one f32 root histogram a tree and the f32 wave
    launches counted, holdout AUC within 1e-3 of phase 10's and of
    genuine LightGBM's, the saved text's first 50 ``Tree=`` blocks the
    base text's (but for the leaf_weight / leaf_count lines a loaded tree
    does not keep), the text reloading to the combined booster's raw
    scores; the fold seconds and s/iteration;
42. ``max_bin_by_feature`` cycling 15, 63, 255 and 1,023 over the 28
    features with a forced-bins file on two: uint16 bins, each feature
    within its budget, the forced bounds in the mappers; 10 iterations
    through the fused wave's uint16 mode (holdout AUC recorded, no
    gate); one exact-sum iteration on the kernels gives the model text of
    the same run on their plain versions.

Row and feature sampling, cv and learning to rank (slice 13), through the
histogram, fused-wave and traversal kernels under traffic they had not
seen: rows with gradient, hessian and count 0 (out of bag), rows scaled
by GOSS's amplification, 137-feature ranking bins and a ranker's trees;
each held to the JAX package's results in ``tests/fixtures/
torch_sampling_ref.json`` (made on the CPU by
``tools/gen_torch_sampling_fixture.py``):

43. sampling at the bench config (phase 10's params and binned rows, 100
    iterations each): bagging 0.7 every iteration with feature_fraction
    0.8, and GOSS on the host (``tpu_device_goss=off``), each at
    ``bagging_seed`` = ``feature_fraction_seed`` 1 to 8, the mean holdout
    AUC within 1e-3 of the JAX package's mean over the same seeds (the
    same masks, draw for draw; one run's AUC moves ~1e-3 with the
    float32 summation order alone, so the bar holds the mean); GOSS on
    the card (``auto``) and quantized GOSS, one run each, within 3e-3
    (the draws of another generator); s/iteration and launches per
    iteration; two 10-iteration device-GOSS runs give equal model text;
44. the kernels under masks: the bench bins under one bagging mask and
    one GOSS mask (``sampling.SampleStrategy`` at 200,000 rows): the
    histogram kernel bit for bit its plain version on exact sums and on
    int8 levels, and its chunk-ordered twin on random values, with no
    out-of-bag row counted; the wave kernel at W = 1 and 16 on bagging-
    and GOSS-shaped masks, bit for bit its plain version on exact sums,
    its child histograms bit for bit their twin on random values and the
    payloads within ``wave_agreement``;
45. ``cv``: 5 stratified folds x 20 rounds on the 200,000 training rows,
    the last round's ``valid auc-mean`` within 1e-3 and ``-stdv`` within
    2e-3 of the JAX package's; seconds a fold, peak device memory, the
    memory left after ``cv`` returns;
46. learning to rank at the repo's MS-LTR width (``make_msltr_like``:
    137 features, 120 documents a query; the rung's 2,270,000 rows cut to
    120,000 training rows in 1,000 queries and 24,000 holdout rows in 200,
    for the time limit) with bench.py's rung params: lambdarank 15
    iterations, holdout ndcg@1,3,5 within 5e-3 of the JAX package's, the
    gradient step's ms, two runs give equal model text; rank_xendcg 10
    iterations within 1e-2; the ranker served through
    ``serving_predictor(quantize="int16")`` equal to a numpy walk of its
    pack bit for bit, one traversal launch a request;
47. the slice's seconds and each kernel's launches on these paths
    (``slice13_launches`` in the kernels line).

Sorted many-vs-many categorical splits (slice 15) — against
``tests/fixtures/torch_categorical_ref.json`` (made on the CPU by
``tools/gen_torch_categorical_fixture.py``):

48. ``make_airline_like(250,000, seed)``: the 28 higgs-like columns plus
    two 300-category airports (Zipf-like, the tail in the rest bin), a
    20-category carrier and a 12-category month, the label carried also
    by hidden sets of categories; 200,000 rows train at the bench params
    with the categorical keys at their defaults, 30 iterations (the
    fixture's 100 cut for the time limit) in f32 and quantized
    (``stochastic_rounding`` false) through the fused wave and histogram
    kernels, the holdout AUC within 2e-3 (f32) and 3e-3 (quantized) of
    the JAX package's at 30, a category set of 2 or more; f32 at
    ``max_cat_to_onehot`` 256 beside them, no bar;
49. exact-sum gradients on 20,000 of those rows: the grower through the
    fused wave kernel, the ``tpu_wave_kernel=unfused`` grower (both on
    the card) and the CPU grower give equal trees and ``row_leaf``, f32
    and quantized;
50. phase 48's f32 model served as an int16 pack on 65,536 holdout rows
    with unseen categories and NaN: bit for bit a numpy walk, one launch;
    its model text loaded: rows without a rest-bin category within the
    round-trip bar, the rest-bin rows that differ counted;
51. one sorted-categorical iteration's ``torch.profiler`` split (3
    warm-up, 5 profiled): s/iteration beside phase 10's and the
    ``grower/sorted_cat`` ms an iteration; the slice's launches
    (``slice15_launches`` in the kernels line).

Exclusive feature bundling (slice 16) — against
``tests/fixtures/torch_efb_ref.json`` (made on the CPU by
``tools/gen_torch_efb_fixture.py``):

52. ``make_onehot_airline_like(250,000, seed)``: phase 48's four
    categorical columns one-hot encoded (632 columns of 0/1) beside its
    28 higgs-like ones, 660 features; 200,000 rows train at the bench
    params with ``enable_bundle`` at its default; the bundles equal the
    JAX package's (339 columns, their bins, the bundled matrix's
    SHA-256); 50 iterations in f32 and quantized (``stochastic_rounding``
    false) through the fused wave and histogram kernels over the bundled
    uint8 matrix, the holdout AUC within 2e-3 (f32) and 3e-3 (quantized)
    of the JAX package's; the f32 run unbundled beside them, the bundled
    f32 AUC within 1e-3 of it; binning and bundling seconds,
    s/iteration beside phase 10's, peak device memory;
53. exact-sum gradients that follow the label on the first 20,000 rows
    of phase 52's own bundled matrix (its 339 uint8 columns) and on
    ``make_wide_bundle_data``'s rows (a 473-bin
    column: uint16 bundles), ``min_sum_hessian_in_leaf`` 1:
    the bundled grower through the fused wave kernel, the
    ``tpu_wave_kernel=unfused`` bundled grower (both on the card), the
    bundled CPU grower and the unbundled grower give equal trees and
    ``row_leaf``, f32 and quantized;
54. phase 52's f32 model served as an int16 pack on 65,536 holdout rows:
    bit for bit a numpy walk, one launch; one bundled iteration's
    ``torch.profiler`` split (3 warm-up, 5 profiled): the
    ``grower/efb_scan`` ms an iteration; the slice's launches
    (``slice16_launches`` in the kernels line).

The histogram pool and the feature-tiled split scan (slice 17): the
grower's leaf histograms in P slots with LRU eviction, an evicted
parent rebuilt through the histogram kernel and handed to the wave
kernel from its slot; the host scans in feature blocks:

55. phase 10's rows at its params and ``tpu_leaf_batch`` 16, exact-sum
    gradients that follow the label: the grower at
    ``histogram_pool_size`` 0 (33 slots) and the unpooled one, fused f32,
    ``tpu_wave_kernel=unfused`` f32, fused quantized and fused bf16: equal
    trees and ``row_leaf``, misses > 0, one more histogram launch a miss;
56. training at the bench config with ``histogram_pool_size`` 0: f32 100
    iterations, holdout AUC within 1e-3 of genuine LightGBM's,
    s/iteration beside phase 10's, misses and histogram launches per
    iteration; quantized 30 iterations pooled and unpooled give the same
    model text;
57. Epsilon's width (2,000 dense features, max_bin 255, 255 leaves;
    131,072 rows of bins drawn on the card): one tree each unpooled
    untiled, unpooled in 128-wide blocks (16) and pooled at 128 MB at
    auto: equal trees and ``row_leaf``, the pooled peak device memory at
    least 1 GB below the unpooled ones';
58. phase 52's bundled data: 10 iterations at the default (auto, which
    on the card tiles only past ``AUTO_TILE_BYTES``: untiled here) and
    at ``tpu_split_tile`` 128 (6 blocks) give the same model text; peak
    memory both ways, and a profiled run at 128 beside phase 54's at the
    default: the ``grower/efb_scan`` ms an iteration; the slice's
    launches (``slice17_launches`` in the kernels line).

Phase 29's and every other ``wave_agreement`` hold the wave kernel's
child histograms to the float64 sum of the same cells
(``wave_hists_f64``), not to the plain version's float32 atomics.

Each wave timing (phases 14, 18, 23, 31) also gives its three launches'
device times by kernel name under ``torch.profiler`` (``wave_stage_ms``):
stage 1, the combine and the scan.

Each phase prints one JSON line; any mismatch raises, so the process exits
non-zero without the final ``{"ok": true, ...}`` line.  Exits non-zero when
no CUDA device is visible, or when the port's package is not beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12      # H100 SXM non-tensor 32-bit rate (data sheet)
TRAVERSE_REPLACES = ("lightgbm_tpu/ops/pallas_traverse.py:179 "
                     "(fused_traverse_call)")
TRAVERSE_SOURCE = "lightgbm_tpu_torch/ops/csrc/traverse.cu"
HIST_REPLACES = "lightgbm_tpu/ops/pallas_histogram.py:166 (histogram_flat)"
HIST_SOURCE = "lightgbm_tpu_torch/ops/csrc/histogram.cu"
WAVE_REPLACES = "lightgbm_tpu/ops/pallas_wave.py:331 (fused_wave_call)"
WAVE_SOURCE = "lightgbm_tpu_torch/ops/csrc/wave.cu"
#: the traversal's timed request sizes (phase 7), and phase 4's packs of
#: edge-case trees (``edge_case_trees``): trees x leaves
TRAVERSE_TIMING_ROWS = (1, 4096, 65_536, 1_048_576)
EDGE_PACKS = ((21, 255), (3, 5000))
#: int8 mode channel scales: powers of two (every scaled sum exact)
POW2_SCALES = (2.0 ** -6, 2.0 ** -9, 1.0)
BENCH_FIXTURE = os.path.join("tests", "fixtures", "bench_auc.json")
#: the TreeArrays fields the grower phases (49, 53, 55, 57) hold bit for
#: bit
TREE_FIELDS = ("split_feature", "split_bin", "default_left", "is_cat",
               "cat_mask", "left_child", "right_child", "split_gain",
               "internal_value", "internal_count", "leaf_value",
               "leaf_count", "leaf_weight")
#: float32 operations of the split scan: per (child, feature, bin), three
#: cumulative-sum adds and three NaN-bin adds; per NaN direction of it,
#: three right-child subtractions, two child gains (multiply, add, divide
#: each), two adds less the parent's gain and five validity compares
SCAN_OPS_PER_BIN = 6
SCAN_OPS_PER_DIRECTION = 16
#: timing shapes: the bench's training rows and the Higgs row count; a
#: wave of 16 smaller siblings of 12,500 rows
HIST_TIMING_ROWS = (200_000, 10_500_000)
WAVE_TIMING_SIZES = (12_500,) * 16
#: the slice-4 modes of both training kernels (ops/histogram_flat.py::MODES)
NEW_MODES = ("bf16", "f32_packed4", "bf16_packed4", "int8_packed4")
#: histogram kernel vs plain version on random f32 / bf16 values, as in
#: phase 8: f32 sums in two orders (row chunks in chunk order vs
#: index_add_'s atomics), relative to the largest cell; at B = 16 a cell
#: sums 16x the rows it sums at B = 255, and the rounding grows with it
HIST_RTOL = 1e-5
#: phase 24's histogram rows; the four modes whose sums the twin repeats
TWIN_ROWS = (1, 1000, 20_000, 200_000)
TWIN_MODES = ("f32", "bf16", "f32_packed4", "bf16_packed4")
#: a wave's launches, by a part of their kernel names
WAVE_STAGES = (("stage1", "hist_accumulate"), ("combine", "combine"),
               ("scan", "wave_scan"))
#: slice 4's kernel-vs-plain shapes: histogram rows, and waves of smaller
#: siblings (W = 1; W = 16 with slots 5 and 11 inactive)
CHECK_ROWS = (1, 1000, 200_000)
CHECK_WAVES = {"W1": ([100_000], ()),
               "W16": ([1, 2, 7, 100, 1000, 2047, 2048, 4096, 12_500, 30_000,
                        100_000, 3, 50, 500, 5000, 20_000], (5, 11))}


# --------------------------------------------------------------- data, model
def make_higgs_like(n, f, seed=0):
    """bench.py's higgs-like generator (without its disk cache)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f) / np.sqrt(f)
    logits = X @ w + 0.5 * np.sin(X[:, 0] * 2) * X[:, 1]
    p = 1 / (1 + np.exp(-logits))
    y = (rng.rand(n) < p).astype(np.float64)
    return X, y


#: make_airline_like's categorical columns (after the 28 higgs-like
#: ones): (name, categories, Zipf exponent of their frequencies, weight of
#: their hidden set in the logit)
AIRLINE_COLUMNS = (("origin", 300, 1.1, 0.6), ("dest", 300, 1.1, 0.6),
                   ("carrier", 20, 0.8, 0.4), ("month", 12, 0.0, 0.3))


def make_airline_like(n, seed=0):
    """``make_higgs_like(n, 28, seed)``'s rows plus the four categorical
    columns of ``AIRLINE_COLUMNS``, in the manner of the airline data
    LightGBM's documentation shows categorical support on: two airports
    of 300 categories with Zipf-like frequencies (at max_bin 255 the
    rarest 46 share the rest bin), a 20-category carrier, a 12-category
    month.  Category ids are shuffled against their frequency.  The label
    is drawn from the higgs-like logit plus, per column, its weight times
    +-1 by a hidden half of its categories.  Returns (X (n, 32) float64,
    y, the categorical column indices)."""
    rng = np.random.RandomState(seed)
    f = 28
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f) / np.sqrt(f)
    logits = X @ w + 0.5 * np.sin(X[:, 0] * 2) * X[:, 1]
    crng = np.random.RandomState([seed, 15])
    cols = []
    for _name, k, zipf, weight in AIRLINE_COLUMNS:
        p = 1.0 / np.arange(1, k + 1) ** zipf
        ids = crng.permutation(k)
        cat = ids[crng.choice(k, n, p=p / p.sum())]
        hidden = np.where(crng.rand(k) < 0.5, 1.0, -1.0)
        logits = logits + weight * hidden[cat]
        cols.append(cat.astype(np.float64))
    y = (crng.rand(n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    Xc = np.column_stack([X.astype(np.float64)] + cols)
    return Xc, y, list(range(f, f + len(AIRLINE_COLUMNS)))


def make_onehot_airline_like(n, seed=0):
    """``make_airline_like(n, seed)`` with its four categorical columns
    one-hot encoded (300 + 300 + 20 + 12 = 632 columns of 0/1, a column
    per category id in id order) after its 28 higgs-like ones: 660
    features, the one-hot Flight Delay encoding the LightGBM paper shows
    exclusive feature bundling on.  Returns (X (n, 660) float32, y)."""
    X, y, cat_cols = make_airline_like(n, seed)
    parts = [X[:, :cat_cols[0]].astype(np.float32)]
    for j, (_name, k, _zipf, _weight) in zip(cat_cols, AIRLINE_COLUMNS):
        oh = np.zeros((n, k), np.float32)
        oh[np.arange(n), X[:, j].astype(np.int64)] = 1.0
        parts.append(oh)
    return np.concatenate(parts, axis=1), y


def random_tree(rng, num_leaves, num_bins, cat_features, max_bins):
    """One leaf-wise tree: each split takes a random leaf, a random feature
    and a random bin below that feature's bin count (a random left set for
    a categorical feature), a random default_left, leaves from N(0, 0.1)."""
    m = num_leaves - 1
    sf = np.zeros(m, np.int32)
    sb = np.zeros(m, np.int32)
    dl = np.zeros(m, bool)
    ic = np.zeros(m, bool)
    cat_mask = np.zeros((m, max_bins), bool)
    lc = np.zeros(m, np.int32)
    rc = np.zeros(m, np.int32)
    parent, side = [-1], [0]           # per leaf: its parent node and side
    for k in range(m):
        j = rng.randint(k + 1)
        feat = rng.randint(len(num_bins))
        nb = int(num_bins[feat])
        sf[k] = feat
        if feat in cat_features:
            ic[k] = True
            cat_mask[k, :nb] = rng.rand(nb) < 0.5
        else:
            sb[k] = rng.randint(max(nb - 1, 1))
        dl[k] = rng.rand() < 0.5
        if parent[j] >= 0:
            (lc if side[j] == 0 else rc)[parent[j]] = k
        lc[k], rc[k] = ~j, ~(k + 1)
        parent[j], side[j] = k, 0
        parent.append(k)
        side.append(1)
    return {"split_feature": sf, "split_bin": sb, "default_left": dl,
            "is_cat": ic, "cat_mask": cat_mask, "left_child": lc,
            "right_child": rc, "leaf_value": rng.normal(0, 0.1, num_leaves),
            "num_leaves": num_leaves}


def chain_tree(rng, num_leaves, num_bins, max_bins):
    """A tree whose node k sends its left rows to leaf k and its right rows
    to node k + 1: depth num_leaves - 1, the longest a tree of that many
    leaves has.  Numerical splits on random features and bins."""
    m = num_leaves - 1
    sf = rng.randint(len(num_bins), size=m).astype(np.int32)
    sb = np.array([rng.randint(max(int(num_bins[j]) - 1, 1)) for j in sf],
                  np.int32)
    rc = np.arange(1, m + 1, dtype=np.int32)
    rc[-1] = ~m
    return {"split_feature": sf, "split_bin": sb,
            "default_left": rng.rand(m) < 0.5, "is_cat": np.zeros(m, bool),
            "cat_mask": np.zeros((m, max_bins), bool),
            "left_child": ~np.arange(m, dtype=np.int32), "right_child": rc,
            "leaf_value": rng.normal(0, 0.1, num_leaves),
            "num_leaves": num_leaves}


def edge_case_trees(rng, num_bins, max_bins, cat_features, num_trees,
                    num_leaves):
    """Trees that push the traversal kernel, as the port's ``Tree``s:
    leaf-wise random trees with categorical nodes on ``cat_features``,
    and every fifth tree from the second a single leaf (the pack's
    sentinel children), every fifth from the fourth a chain tree
    (``chain_tree``)."""
    from lightgbm_tpu_torch.models.tree import Tree
    trees = []
    for k in range(num_trees):
        if k % 5 == 1:
            z = np.zeros(0, np.int32)
            d = {"split_feature": z, "split_bin": z,
                 "default_left": z.astype(bool), "is_cat": z.astype(bool),
                 "cat_mask": np.zeros((0, max_bins), bool),
                 "left_child": z, "right_child": z,
                 "leaf_value": rng.normal(0, 0.1, 1), "num_leaves": 1}
        elif k % 5 == 3:
            d = chain_tree(rng, num_leaves, num_bins, max_bins)
        else:
            d = random_tree(rng, num_leaves, num_bins, set(cat_features),
                            max_bins)
        trees.append(Tree(**d))
    return trees


def random_model_state(rng, binned, num_trees, num_leaves, cat_features=()):
    from lightgbm_tpu_torch.binning import mappers_to_arrays
    trees = [random_tree(rng, num_leaves, binned.num_bins_per_feature,
                         set(cat_features), binned.max_num_bins)
             for _ in range(num_trees)]
    return {"mappers": mappers_to_arrays(binned.mappers), "trees": [trees],
            "init_scores": np.array([rng.normal(0, 0.5)]), "num_class": 1,
            "objective": "binary", "sigmoid": 1.0, "num_leaves": num_leaves}


def categorical_data(rng, n):
    """6 features; 1 and 4 categorical with vocabularies of about 40."""
    X = rng.randn(n, 6)
    X[:, 1] = rng.randint(0, 40, n)
    X[:, 4] = rng.randint(0, 45, n)
    X[rng.rand(n, 6) < 0.03] = np.nan
    return X


def walk_pack_numpy(pack, bins, nan_bins):
    """Independent vectorized numpy walk of a quantized pack (the algorithm
    of tests/test_serve_quantize.py::_walk_pack_numpy, over all rows at
    once).  Returns (int64 quanta sums, total node visits)."""
    sf = pack["split_feature"].cpu().numpy().astype(np.int64)
    sb = pack["split_bin"].cpu().numpy().astype(np.int64)
    dl = pack["default_left"].cpu().numpy()
    ic = pack["is_cat"].cpu().numpy()
    cb = pack["cat_bits"].cpu().numpy().astype(np.int64)
    lc = pack["left_child"].cpu().numpy().astype(np.int64)
    rc = pack["right_child"].cpu().numpy().astype(np.int64)
    lq = pack["leaf_q"].cpu().numpy().astype(np.int64)
    bins = np.asarray(bins, np.int64)
    nan_bins = np.asarray(nan_bins, np.int64)
    n = bins.shape[0]
    acc = np.zeros(n, np.int64)
    visits = 0
    for ti in range(sf.shape[0]):
        rows = np.arange(n)
        node = np.zeros(n, np.int64)
        while rows.size:
            visits += rows.size
            nd = node
            f = sf[ti, nd]
            col = bins[rows, f]
            go_left = np.where(
                ic[ti, nd], ((cb[ti, nd, col >> 3] >> (col & 7)) & 1) > 0,
                np.where(col == nan_bins[f], dl[ti, nd], col <= sb[ti, nd]))
            nxt = np.where(go_left, lc[ti, nd], rc[ti, nd])
            leaf = nxt < 0
            acc[rows[leaf]] += lq[ti, ~nxt[leaf]]
            rows, node = rows[~leaf], nxt[~leaf]
    return acc, visits


def traverse_bytes(pack, bins):
    """The bytes a traversal launch must move: the rows' int32 bins and the
    walk table read once, the categorical masks of its categorical nodes,
    the (N,) int32 sums written once."""
    n, f = bins.shape
    cats = int(pack["is_cat"].sum()) * pack["cat_bits"].shape[2]
    table = pack["walk_table"]
    return n * f * 4 + table.numel() * 4 + cats + n * 4


def device_binning_rows(binned, X, rng, n):
    """n rows drawn from X, with edge values planted: bound values, +-0.0,
    NaN, tiny values around the zero-as-missing window, and for
    categorical features fractions, negatives, unseen and >= 2^31 values."""
    rows = X[rng.randint(0, X.shape[0], n)].astype(np.float64)
    edge_num = [0.0, -0.0, np.nan, 1e-36, -1e-36, 1e-35, -1e-35, 5e-324,
                -5e-324, 1e300, -1e300]
    edge_cat = [3.7, -0.5, -0.0, -3.0, 777.0, 2.0 ** 31 + 5, 2.0 ** 31 - 1,
                1e300, np.nan, 0.999, 39.0, 40.0]
    for j, m in enumerate(binned.mappers):
        if m.is_categorical:
            pool = np.asarray(edge_cat + list(m.categories[:5]), np.float64)
        else:
            pool = np.asarray(edge_num + list(m.upper_bounds[:-1][:50]),
                              np.float64)
        pick = rng.rand(n) < 0.2
        rows[pick, j] = pool[rng.randint(0, len(pool), int(pick.sum()))]
    return rows


# ------------------------------------------------------------------ helpers
#: the process's start: each phase line's ``t_s`` is the seconds since
_T0 = time.perf_counter()


def emit(obj):
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def cuda_time_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def request_breakdown(pred, X, rng, n=65_536, repeats=5):
    """Host-clock split of one dense request's steps, replayed one by one
    with a device sync after each (median over ``repeats``): the inf scan,
    the bit view and ladder pad, the host-to-device copy, device binning,
    the traversal and dequantization, and the copy back with init scores
    — next to the whole ``Predictor.predict`` call."""
    import torch
    from lightgbm_tpu_torch.models.tree import forest_scores_quantized
    from lightgbm_tpu_torch.serve.device_binning import (bin_rows_device,
                                                         float_bits)
    from lightgbm_tpu_torch.serve.predictor import _reject_inf_rows
    plan = pred.plan
    rows = X[rng.randint(0, X.shape[0], n)]
    steps = {k: [] for k in ("inf_scan", "bits_and_pad", "h2d", "binning",
                             "traverse", "d2h_and_init", "predict_total")}
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        _reject_inf_rows(rows)
        t.append(time.perf_counter())
        bits, _padded = plan._pad(float_bits(rows), n)
        t.append(time.perf_counter())
        dbits = torch.from_numpy(bits).to(plan.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        bins = bin_rows_device(plan._tables, dbits)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        scores = forest_scores_quantized(plan._packs, bins, plan._nan_bins)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        plan._finish(scores, n)
        t.append(time.perf_counter())
        pred.predict(rows)
        t.append(time.perf_counter())
        for k, a, b in zip(steps, t[:-1], t[1:]):
            steps[k].append((b - a) * 1e3)
    return {"rows": n, **{k: float(np.median(v)) for k, v in steps.items()}}


# ------------------------------------------------------- training kernels
def device_bins(gen, n, f, b, dev, nan_frac=0.05):
    """(n, f) bins on the card, uint8 (uint16 above 256 bins, made in
    int32: torch has no uint16 ``where`` there); every other feature has a
    NaN bin (b - 1) that ``nan_frac`` of its rows fall in."""
    import torch
    wide = b > 256
    bins = torch.randint(0, b - 1, (n, f), generator=gen, device=dev,
                         dtype=torch.int32 if wide else torch.uint8)
    nan = (torch.rand(n, f, generator=gen, device=dev) < nan_frac)
    nan[:, 1::2] = False
    bins = torch.where(nan, torch.full_like(bins, b - 1), bins)
    return bins.to(torch.uint16) if wide else bins


def device_vals(gen, n, dev, exact):
    """(n, 3) float32 [grad, hess, 1]: exact sums (+-0.5, 0.25) or random."""
    import torch
    if exact:
        g = torch.randint(0, 2, (n,), generator=gen, device=dev).float() - 0.5
        h = torch.full((n,), 0.25, device=dev)
    else:
        g = torch.randn(n, generator=gen, device=dev)
        h = torch.rand(n, generator=gen, device=dev) + 0.05
    return torch.stack([g, h, torch.ones(n, device=dev)], dim=1).contiguous()


def device_levels(gen, n, dev):
    """(n, 3) int8 levels as quantized training makes them: grad in +-127
    (a fifth of them zero), hess in 0..127, in-bag 0/1 (nine in ten)."""
    import torch
    g = torch.randint(-127, 128, (n,), generator=gen, device=dev)
    g = torch.where(torch.rand(n, generator=gen, device=dev) < 0.2, 0, g)
    h = torch.randint(0, 128, (n,), generator=gen, device=dev)
    c = (torch.rand(n, generator=gen, device=dev) < 0.9).long()
    return torch.stack([g, h, c], dim=1).to(torch.int8).contiguous()


def hist_bound_ms(n, f, b, val_bytes=12, bin_bytes=None):
    """Histogram bound: bins (``bin_bytes`` a row: F, or ceil(F/2) packed)
    and values (``val_bytes`` a row: 12 for f32, 6 for bf16, 3 for int8
    levels) read once, the (F, B, 3) result written once, over the memory
    rate; the N*F*3 adds a histogram needs over the scalar rate (the f32
    kernel's one-hot design spends N*F*B compares on top: that is its
    cost, not the function's).  Returns (bytes_ms, ops_ms)."""
    bin_bytes = f if bin_bytes is None else bin_bytes
    nbytes = n * bin_bytes + n * val_bytes + f * b * 12
    return nbytes / HBM_BYTES_PER_S * 1e3, n * f * 3 / SCALAR_OPS_PER_S * 1e3


def wave_case(gen, dev, sizes, exact, f=28, b=255, inactive=(),
              scales=None, mode="f32", edit=None, row_mask=None):
    """One wave over a random permutation on the card: slot w's parent is
    the next 2 * sizes[w] perm positions, its smaller sibling the first
    (even w) or last (odd w) sizes[w] of them.  Feature 3 is a one-hot
    categorical of 4 bins; the last feature is masked out.  With
    ``scales`` (3 channel scales) the wave is in int8 mode: int8 levels,
    int32 parents, stats from the scaled sums.  A ``mode`` starting with
    bf16 passes the values rounded to bf16 (parents and stats from the
    rounded values); one ending in packed4 packs the bins (b <= 16).
    ``edit(bins, perm)`` (int64 copies) returns other bins for the wave,
    drawn after the permutation (``lane_pattern``).  ``row_mask`` (an
    (N,) f32 mask) makes f32 values a sampled iteration's (``masked``)."""
    import torch
    from lightgbm_tpu_torch.ops import wave as WV
    from lightgbm_tpu_torch.ops.histogram import histogram_segment, pack_bins4
    n = sum(2 * s for s in sizes)
    bins = device_bins(gen, n, f, b, dev)
    if scales is None:
        vals = device_vals(gen, n, dev, exact)
        if row_mask is not None:
            vals = masked(vals, row_mask)
        if mode.startswith("bf16"):
            vals = vals.to(torch.bfloat16)
        sums = lambda v: v.float().sum(dim=0)
    else:
        vals = device_levels(gen, n, dev)
        scale3 = torch.tensor(scales, dtype=torch.float32, device=dev)
        sums = lambda v: v.long().sum(dim=0).float() * scale3
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    if edit is not None:
        bins = edit(bins.long(), perm.long()).to(bins.dtype)
    bins[:, 3] = (bins[:, 3].long() % 4).to(bins.dtype)
    starts, cnts, parents, stats = [], [], [], []
    pos = 0
    for j, s in enumerate(sizes):
        rows = perm[pos:pos + 2 * s].long()
        parents.append(histogram_segment(bins.index_select(0, rows),
                                         vals[rows], num_bins=b))
        small_left = j % 2 == 0
        starts.append(pos if small_left else pos + s)
        cnts.append(s)
        left = sums(vals[perm[pos:pos + s].long()])
        right = sums(vals[rows]) - left
        act = 0.0 if j in inactive else 1.0
        stats.append(torch.stack([torch.stack([
            c[0], c[1], c[2], -c[0] / (c[1] + 1e-15),
            torch.tensor(float(small_left), device=dev),
            torch.tensor(act, device=dev), torch.zeros((), device=dev),
            torch.zeros((), device=dev)]) for c in (left, right)]))
        pos += 2 * s
    nbpf = torch.full((f,), b, dtype=torch.int32, device=dev)
    nbpf[3] = 4
    nanb = torch.full((f,), b, dtype=torch.int32, device=dev)
    nanb[0::2] = b - 1
    nanb[3] = b
    is_cat = torch.zeros(f, dtype=torch.bool, device=dev)
    is_cat[3] = True
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    fmask[-1] = False
    packed4 = mode.endswith("packed4")
    inp = dict(bins=pack_bins4(bins) if packed4 else bins, vals=vals,
               perm=perm, small_start=starts, small_cnt=cnts,
               parent=torch.stack(parents),
               stats=torch.stack(stats).contiguous(),
               meta=WV.wave_meta(nbpf, nanb, is_cat, fmask), num_bins=b,
               packed4=packed4)
    if scales is not None:
        inp["scale3"] = scale3
    return inp


def wave_bound_ms(inp):
    """Wave bound for the inputs of one wave (``wave_case``): each smaller
    sibling's rows (bin bytes as stored: F, ceil(F/2) packed, 2F uint16;
    values: 12 bytes f32, 6 bf16, 3 int8; the perm index) and the W parent
    histograms read once, 2W child histograms and payloads written once,
    over the memory rate; over the scalar rate, the operations the
    function needs on this run's data: the siblings' R*F*3 adds, the
    W*F*B*3 subtractions, and per active child the scan of every in-feature
    bin of every live feature (SCAN_OPS_PER_BIN) in each of its NaN
    directions (SCAN_OPS_PER_DIRECTION), plus in int8 mode the rescaling
    multiply of every scanned cell.  Returns (bytes_ms, ops_ms)."""
    from lightgbm_tpu_torch.ops.wave import PAYLOAD_SCALARS
    meta = inp["meta"].cpu().long()
    b = inp["num_bins"]
    f = meta.shape[0]
    r, w = sum(inp["small_cnt"]), len(inp["small_cnt"])
    hist = f * b * 12
    val_bytes = 3 * inp["vals"].element_size()
    bin_bytes = inp["bins"].shape[1] * inp["bins"].element_size()
    nbytes = (r * (bin_bytes + val_bytes + 4) + 3 * w * hist
              + 2 * w * (PAYLOAD_SCALARS + b) * 4)
    live = meta[:, 3] > 0
    dirs = 1 + ((meta[:, 2] == 0) & (meta[:, 1] < b)).long()
    cells = int(meta[live, 0].sum())
    cands = int((meta[:, 0] * dirs)[live].sum())
    children = 2 * int((inp["stats"][:, 0, 5] > 0.5).sum())
    per_bin = SCAN_OPS_PER_BIN + (3 if "scale3" in inp else 0)
    ops = (r * f * 3 + w * f * b * 3
           + children * (cells * per_bin + cands * SCAN_OPS_PER_DIRECTION))
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3


def wave_gain_bound(pay, hist, rtol=1e-5):
    """Per child of a wave, how far float32 rounding may move the winner's
    gain between the kernel and its plain version: ``rtol`` of the gain,
    plus the scans' share.  Each child sum is a scan over B bins (the
    kernel's sequential, the plain version's parallel), within B * 2^-24
    of the absolute sum it runs over (the winning feature's |G| bins, the
    parent's hessian) for each of the two; a side's gain moves by
    2|G|/H per unit of G and (G/H)^2 per unit of H.  ``pay`` (2W, P),
    ``hist`` (2W, F, B, 3)."""
    import torch
    b = hist.shape[-2]
    feat = pay[:, 1].round().long().clamp(0, hist.shape[1] - 1)
    abs_g = hist[torch.arange(pay.shape[0]), feat, :, 0].abs().sum(-1)
    tot_h = pay[:, 6] + pay[:, 9]
    c = 2 * b * 2.0 ** -24
    bound = rtol * pay[:, 0].abs()
    for gi, hi in ((5, 6), (8, 9)):
        g, hh = pay[:, gi], pay[:, hi].abs().clamp_min(1e-30)
        bound = bound + c * (2 * g.abs() / hh * abs_g + (g / hh) ** 2 * tot_h)
    return bound


def wave_hists_f64(inp):
    """The (W, 2, F, B, 3) child histograms of one wave (``wave_case``'s
    inputs) summed in float64 on the inputs' device: each smaller
    sibling's cells by one float64 ``index_add_`` over its perm rows
    (``histogram_segment``; int8 levels times the channel scales), the
    larger one as the parent (scaled, in int8 mode) minus it, the pair in
    (left, right) order.  Its own rounding is ~1e-16 of a cell, so a
    check against it sees the kernel's float32 rounding alone."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import histogram_segment
    scale = inp.get("scale3")
    scale = (torch.ones(3, dtype=torch.float64, device=inp["vals"].device)
             if scale is None else scale.double())
    vals = inp["vals"].double() * scale
    parent = inp["parent"].double() * scale
    small = []
    for s0, cnt in zip(inp["small_start"], inp["small_cnt"]):
        rows = inp["perm"][int(s0):int(s0) + int(cnt)].long()
        small.append(histogram_segment(
            inp["bins"].index_select(0, rows), vals[rows],
            num_bins=inp["num_bins"], packed4=inp.get("packed4", False),
            features=parent.shape[1]))
    small = torch.stack(small)
    big = parent - small
    left = (inp["stats"][:, 0, 4] > 0.5)[:, None, None, None]
    return torch.stack([torch.where(left, small, big),
                        torch.where(left, big, small)], dim=1)


def wave_agreement(h, p, hp, pp, inp, rtol=1e-5):
    """Hold the wave kernel's ``(h, p)`` to its plain version's
    ``(hp, pp)`` on the wave's inputs ``inp`` where the two may round
    differently (random values; int8 mode: ``h`` and ``hp`` scaled).
    Child histograms: gradient and hessian channels within ``rtol`` of
    the channel's largest value of the float64 sum of the same cells
    (``wave_hists_f64``: the plain version sums through float32
    ``index_add_`` atomics, whose rounding varies run to run), counts
    equal the plain version's.  Per child: gains -inf in the same
    children, and within ``wave_gain_bound`` of each other; with the same
    winner (feature, bin, NaN direction, kind), equal counts and
    categorical lanes and sums within ``rtol`` of the wave's largest plain
    sum.  Raises on a breach; returns the measured errors (``plain_*``:
    the plain version's against the float64 sum, not held)."""
    import torch
    from lightgbm_tpu_torch.ops.wave import PAYLOAD_SCALARS
    ref = wave_hists_f64(inp)
    hist_err, plain_err = [], []
    for c in (0, 1):
        scale = max(float(ref[..., c].abs().max()), 1e-30)
        err = float((h[..., c].double() - ref[..., c]).abs().max())
        require(err <= rtol * scale, f"wave child histogram channel {c} off "
                f"by {err} from its float64 sum (scale {scale})")
        hist_err.append(err / scale)
        plain_err.append(float((hp[..., c].double() - ref[..., c]).abs()
                               .max()) / scale)
    require(torch.equal(h[..., 2], hp[..., 2]),
            "wave child histogram counts != plain version")
    k, q = p.reshape(-1, p.shape[-1]), pp.reshape(-1, pp.shape[-1])
    kids = hp.reshape(-1, *hp.shape[-3:])
    fin = torch.isfinite(q[:, 0])
    require(torch.equal(fin, torch.isfinite(k[:, 0])),
            "wave kernel and plain version disagree on which children split")
    bound = torch.maximum(wave_gain_bound(k, kids, rtol),
                          wave_gain_bound(q, kids, rtol))[fin]
    gain_err = (k[fin, 0] - q[fin, 0]).abs()
    if not bool((gain_err <= bound).all()):
        worst = int(torch.argmax(gain_err / bound))
        raise AssertionError(f"wave gains off by {float(gain_err[worst])} "
                             f"(bound {float(bound[worst])})")
    same = fin & (k[:, 1:5] == q[:, 1:5]).all(dim=1)
    require(torch.equal(k[same][:, [7, 10]], q[same][:, [7, 10]]),
            "wave winner counts != plain version")
    require(torch.equal(k[same][:, PAYLOAD_SCALARS:],
                        q[same][:, PAYLOAD_SCALARS:]),
            "wave winner categorical lanes != plain version")
    sums = [5, 6, 8, 9]
    sum_scale = float(q[fin][:, sums].abs().max()) if bool(fin.any()) else 0.0
    sum_err = float((k[same][:, sums] - q[same][:, sums]).abs().max()) if bool(
        same.any()) else 0.0
    require(sum_err <= rtol * sum_scale, f"wave winner sums off by {sum_err} "
            f"(scale {sum_scale})")
    some = bool(fin.any())
    return {"hist_rel_err": max(hist_err),
            "plain_hist_rel_err": max(plain_err),
            "gain_abs_err": float(gain_err.max()) if some else 0.0,
            "gain_rel_err": float((gain_err / q[fin, 0].abs()).max())
            if some else 0.0,
            "gain_err_over_bound": float((gain_err / bound).max())
            if some else 0.0,
            "sum_rel_err": sum_err / max(sum_scale, 1e-30),
            "splitting_children": int(fin.sum()),
            "other_winner": int((fin & ~same).sum())}


def wave_stage_ms(fn, iters=10):
    """Device milliseconds of each of a wave's launches (stage 1, the
    combine, the scan; ``other``: the segment table's copy and the int8
    mode's memset, per call), from the kernel names ``torch.profiler``
    records over ``iters`` calls of ``fn`` after one warm-up call."""
    out = kernel_stage_ms(fn, iters)
    require(out["stage1"] > 0 and out["scan"] > 0,
            "the profiler saw no wave kernel")
    return out


def kernel_stage_ms(fn, iters=10, attempts=3):
    """``wave_stage_ms`` for any call: device ms per launch by the
    ``WAVE_STAGES`` part of each kernel's name (a histogram: stage 1 and
    the combine), the mean over the launches ``torch.profiler`` recorded
    in ``iters`` calls (each call launches each stage once); ``other``:
    the device ms per call of the other events.  A session on that card
    at times records none, or another number, of the launches made (seen
    after another session, and at 10.5M rows): ``profiler_launches``
    gives each stage's count, and a session that recorded no stage-1
    launch is profiled again, up to ``attempts`` times
    (``profiler_sessions``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    stages = [k for k, _ in WAVE_STAGES]
    fn()
    torch.cuda.synchronize()
    for session in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = dict.fromkeys(stages + ["other"], 0.0)
        count = dict.fromkeys(stages + ["other"], 0)
        for name, on_device, start, end in profiler_events(prof):
            if not on_device:
                continue
            key = next((k for k, part in WAVE_STAGES if part in name),
                       "other")
            total[key] += end - start
            count[key] += 1
        if count["stage1"]:
            break
    out = {k: total[k] / count[k] / 1e3 if count[k] else 0.0
           for k in stages}
    return {**out, "other": total["other"] / 1e3 / iters,
            "profiler_sessions": session,
            "profiler_launches": {k: count[k] for k in stages}}


def named_kernel_ms(fn, part, iters=10):
    """Device ms per launch of the kernels whose name holds ``part``, and
    their launches, over ``iters`` calls of ``fn`` under
    ``torch.profiler`` after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for name, on_device, start, end in profiler_events(prof):
        if on_device and part in name:
            total += end - start
            count += 1
    return {"ms": total / count / 1e3 if count else 0.0, "launches": count}


def profiler_events(prof):
    """(name, on the device, start us, end us) of every event a
    ``torch.profiler`` session recorded, read from its raw kineto events:
    ``prof.events()`` builds a Python tree of them first (seconds for the
    hundreds of thousands of events of a profiled iteration).
    Times count from the trace's start, as ``prof.events()``' do;
    ``tools/torch_profile_readers.py`` reads one profile both ways."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    return [(ev.name(), "cuda" in str(ev.device_type()).lower(),
             (ev.start_ns() - t0) / 1e3,
             (ev.start_ns() + ev.duration_ns() - t0) / 1e3)
            for ev in res.events()]


def profile_phase(params, ds, dev, warmup=3, iters=5):
    """13. Train ``warmup`` iterations of a fresh booster, then ``iters``
    more under ``torch.profiler``, read by :func:`read_profile`."""
    prof, wall = profile_training(params, ds, dev, warmup, iters)
    return read_profile(profiler_events(prof), wall, warmup, iters)


def profile_training(params, ds, dev, warmup, iters):
    """The profiler session of :func:`profile_phase` and its wall
    seconds."""
    import torch
    import lightgbm_tpu_torch as lgt
    from torch.profiler import ProfilerActivity, profile
    bst = lgt.Booster(params, ds, device=dev)
    for _ in range(warmup):
        bst.update()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            bst.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def read_profile(events, wall, warmup, iters):
    """Host time per iteration in each of the port's ranges (``grower/*``
    nest inside ``gbdt/grow``; the rest of it is the grower's host
    bookkeeping), and the device's busy time: the union of its kernel and
    copy intervals over the window from the first one's start to the
    last one's end.  ``events`` as :func:`profiler_events` gives them."""
    ranges, spans, kernels = {}, [], {}
    for name, on_device, start, end in events:
        is_range = name.startswith(("gbdt/", "grower/"))
        if on_device:
            if not is_range:       # the ranges' own device-side copies
                spans.append((start, end))
                kernels[name] = kernels.get(name, 0.0) + end - start
        elif is_range:
            ranges[name] = ranges.get(name, 0.0) + end - start
    per_iter = {k: v / 1e3 / iters for k, v in sorted(ranges.items())}
    if "gbdt/grow" in per_iter:
        per_iter["grower bookkeeping (rest of gbdt/grow)"] = (
            per_iter["gbdt/grow"] - sum(v for k, v in per_iter.items()
                                        if k.startswith("grower/")))
    busy = window = 0.0
    if spans:
        spans.sort()
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = spans[-1][1] - spans[0][0]
    require(busy > 0, "the profiler saw no device time in training")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"phase": "train_profile", "warmup_iterations": warmup,
            "iterations": iters, "wall_ms_per_iteration": wall * 1e3 / iters,
            "range_host_ms_per_iteration": per_iter,
            "device_busy_ms_per_iteration": busy / 1e3 / iters,
            "device_busy_share": busy / window,
            "device_idle_share": 1.0 - busy / window,
            "top_kernels_ms_per_iteration": [
                {"kernel": k[:100], "ms": v / 1e3 / iters} for k, v in top]}


def load_bench_fixture(root):
    with open(os.path.join(root, BENCH_FIXTURE)) as fh:
        return json.load(fh)


def histogram_phase(gen, dev):
    """8. The histogram kernel against its plain version."""
    import torch
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops.histogram import histogram_segment
    cases, err_200k = [], None
    for n in (1, 1000, 200_000):
        bins = device_bins(gen, n, 28, 255, dev)
        ve = device_vals(gen, n, dev, exact=True)
        got = HF.histogram_flat(bins, ve, num_bins=255)
        want = histogram_segment(bins, ve, num_bins=255)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"histogram kernel != plain version on exact sums, N={n}")
        vr = device_vals(gen, n, dev, exact=False)
        a = HF.histogram_flat(bins, vr, num_bins=255)
        b = HF.histogram_flat(bins, vr, num_bins=255)
        plain = histogram_segment(bins, vr, num_bins=255)
        torch.cuda.synchronize()
        require(torch.equal(a, b), f"histogram kernel not run-to-run "
                f"bitwise, N={n}")
        err = float((a - plain).abs().max())
        scale = float(plain.abs().max())
        require(err <= 1e-5 * scale, f"histogram kernel off by {err} "
                f"(scale {scale}) at N={n}")
        cases.append({"rows": n, "exact_bitwise": True,
                      "run_to_run_bitwise": True, "max_abs_err": err,
                      "rel_err": err / scale})
        if n == 200_000:
            err_200k = err
    emit({"phase": "histogram_vs_plain", "features": 28, "bins": 255,
          "cases": cases})
    return err_200k


def wave_phase(gen, dev):
    """9. The wave kernel against its plain version."""
    import torch
    from lightgbm_tpu_torch.ops import wave as WV
    from lightgbm_tpu_torch.ops.split import SplitConfig
    cfg = SplitConfig(min_data_in_leaf=0, min_sum_hessian_in_leaf=1.0,
                      lambda_l2=0.5, max_cat_to_onehot=4)
    waves = {"W1": ([100_000], ()),
             "W16": ([1, 2, 7, 100, 1000, 2047, 2048, 4096, 12_500, 30_000,
                      100_000, 3, 50, 500, 5000, 20_000], (5, 11))}
    out = {}
    for name, (sizes, inactive) in waves.items():
        for exact in (True, False):
            inp = wave_case(gen, dev, sizes, exact, inactive=inactive)
            h1, p1 = WV.fused_wave_call(cfg=cfg, **inp)
            h2, p2 = WV.fused_wave_call(cfg=cfg, **inp)
            hp, pp = WV.wave_plain(cfg=cfg, **inp)
            torch.cuda.synchronize()
            require(torch.equal(h1, h2) and torch.equal(p1, p2),
                    f"wave kernel not run-to-run bitwise ({name})")
            gains = p1[:, :, 0]
            for j in inactive:
                require(bool(torch.isinf(gains[j]).all()),
                        f"inactive slot {j} has a finite gain")
            if exact:
                require(torch.equal(h1, hp),
                        f"wave child histograms != plain version ({name})")
                require(torch.equal(p1, pp),
                        f"wave payload != plain version ({name})")
            out[f"{name}/{'exact' if exact else 'random'}"] = {
                "slots": len(sizes), "rows": sum(sizes),
                "hist_max_abs_err": float((h1 - hp).abs().max()),
                "payload_equal": bool(torch.equal(p1, pp)),
                **wave_agreement(h1, p1, hp, pp, inp)}
    emit({"phase": "wave_vs_plain", "features": 28, "bins": 255,
          "cases": out})


def histogram_int8_phase(gen, dev):
    """15. The int8 histogram kernel against its plain version (int32 sums
    are exact in any order: bitwise)."""
    import torch
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops.histogram import histogram_segment
    cases = []
    for n in (1, 1000, 200_000):
        bins = device_bins(gen, n, 28, 255, dev)
        levels = device_levels(gen, n, dev)
        got = HF.histogram_flat(bins, levels, num_bins=255)
        again = HF.histogram_flat(bins, levels, num_bins=255)
        want = histogram_segment(bins, levels, num_bins=255)
        torch.cuda.synchronize()
        require(got.dtype == torch.int32 and torch.equal(got, want)
                and torch.equal(got, again),
                f"int8 histogram kernel != plain version, N={n}")
        cases.append({"rows": n, "bitwise": True,
                      "max_abs_err": int((got - want).abs().max())})
    hot = {**int8_hot_histograms(gen, dev, "int8", 255),
           **int8_hot_histograms(gen, dev, "int8_packed4", 16)}
    emit({"phase": "histogram_int8_vs_plain", "features": 28, "bins": 255,
          "cases": cases, "hot_bins": hot})
    return cases[-1]["max_abs_err"]


def wave_int8_phase(gen, dev):
    """16. The int8 wave kernel against its plain version."""
    import torch
    from lightgbm_tpu_torch.ops import wave as WV
    from lightgbm_tpu_torch.ops.split import SplitConfig
    cfg = SplitConfig(min_data_in_leaf=0, min_sum_hessian_in_leaf=1.0,
                      lambda_l2=0.5, max_cat_to_onehot=4)
    waves = {"W1": ([100_000], ()),
             "W16": ([1, 2, 7, 100, 1000, 2047, 2048, 4096, 12_500, 30_000,
                      100_000, 3, 50, 500, 5000, 20_000], (5, 11))}
    rand = torch.rand(2, generator=gen, device=dev) * 0.02 + 1e-3
    random_scales = (float(rand[0]), float(rand[1]), 1.0)
    out = {}
    for name, (sizes, inactive) in waves.items():
        for kind, scales in (("pow2", POW2_SCALES),
                             ("random", random_scales)):
            inp = wave_case(gen, dev, sizes, True, inactive=inactive,
                            scales=scales)
            h1, p1 = WV.fused_wave_call(cfg=cfg, **inp)
            h2, p2 = WV.fused_wave_call(cfg=cfg, **inp)
            hp, pp = WV.wave_plain(cfg=cfg, **inp)
            torch.cuda.synchronize()
            require(torch.equal(h1, h2) and torch.equal(p1, p2),
                    f"int8 wave kernel not run-to-run bitwise ({name})")
            require(h1.dtype == torch.int32 and torch.equal(h1, hp),
                    f"int8 wave child histograms != plain version ({name})")
            for j in inactive:
                require(bool(torch.isinf(p1[j, :, 0]).all()),
                        f"inactive slot {j} has a finite gain")
            if kind == "pow2":
                require(torch.equal(p1, pp),
                        f"int8 wave payload != plain version ({name})")
            sh = WV.scale_hist(h1, inp["scale3"])
            out[f"{name}/{kind}"] = {
                "slots": len(sizes), "rows": sum(sizes), "scales": scales,
                "hist_bitwise": True,
                "payload_equal": bool(torch.equal(p1, pp)),
                **wave_agreement(sh, p1, sh, pp, inp)}
    out.update(int8_wave_checks(gen, dev, "int8", 255, cfg))
    out.update(int8_wave_checks(gen, dev, "int8_packed4", 16, cfg))
    emit({"phase": "wave_int8_vs_plain", "features": 28, "bins": 255,
          "cases": out})


def _zero_launches():
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops import wave as WV
    for counts in (HF.launches, WV.launches):
        for mode in counts:
            counts[mode] = 0


def _read_launches():
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops import wave as WV
    return {"histogram": dict(HF.launches), "wave": dict(WV.launches)}


def bench_rows(fix):
    """The fixture's rows: make_higgs_like(n_train + n_valid, F, seed)."""
    d = fix["data"]
    return make_higgs_like(d["n_train"] + d["n_valid"], d["n_features"],
                           seed=d["seed"])


def bench_dataset(fix, rows, max_bin):
    """The training rows binned once at ``max_bin``; (Dataset, seconds)."""
    import lightgbm_tpu_torch as lgt
    X, y = rows
    nt = fix["data"]["n_train"]
    params = dict(fix["params"], max_bin=max_bin)
    params.pop("num_iterations")
    t0 = time.perf_counter()
    ds = lgt.Dataset(X[:nt], label=y[:nt])
    ds.construct(params)
    return ds, time.perf_counter() - t0


def drop_param(text, line):
    """Model text without one ``[key: value]`` parameter line: the line
    that records the one option two compared runs differ in."""
    require(text.count(f"\n{line}\n") == 1, f"no {line} line in model text")
    return text.replace(f"\n{line}\n", "\n")


def train_phase(dev, fix, rows, name, extra, ds, hist_mode, wave_mode,
                iters=None, ref=None):
    """Training at full width through the entry points: the fixture's
    params plus tpu_leaf_batch 16 and ``extra``, on the binned ``ds``
    (the first n_train of ``rows`` train, the rest are held out), for
    ``iters`` iterations (default the fixture's).  The launch counts are
    zeroed just before and read just after: the histogram kernel must have
    run in ``hist_mode`` only and the wave kernel in ``wave_mode`` only
    (None: not at all).  With ``ref`` = (auc, tol) the holdout AUC must be
    within tol of auc.  Returns (booster, params, record)."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.metrics import auc
    X, y = rows
    nt = fix["data"]["n_train"]
    params = dict(fix["params"])
    fix_iters = params.pop("num_iterations")
    iters = fix_iters if iters is None else iters
    params["tpu_leaf_batch"] = 16
    params.update(extra)
    _zero_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bst = lgt.train(params, ds, iters, device=dev)
    torch.cuda.synchronize()
    boost_s = time.perf_counter() - t1
    launches = _read_launches()
    for kernel, mode in (("histogram", hist_mode), ("wave", wave_mode)):
        ran = {k for k, v in launches[kernel].items() if v}
        require(ran == ({mode} if mode else set()),
                f"{name}: {kernel} kernel launched {launches[kernel]}, "
                f"expected mode {mode} only")
    hist_launches = launches["histogram"][hist_mode]
    wave_launches = launches["wave"][wave_mode] if wave_mode else 0
    require(bst.num_trees() == iters, f"{bst.num_trees()} trees")
    Xv, yv = X[nt:], y[nt:]
    t2 = time.perf_counter()
    raw = bst.predict(Xv, raw_score=True)
    predict_s = time.perf_counter() - t2
    require(raw.shape == (len(yv),) and np.isfinite(raw).all(),
            "holdout raw scores not finite")
    holdout_auc = auc(yv, raw)
    rec = {"phase": name, "rows": nt, "holdout_rows": len(yv),
           "features": X.shape[1], "params": params, "iterations": iters,
           "boosting_s": boost_s, "s_per_iteration": boost_s / iters,
           "predict_holdout_s": predict_s,
           "histogram_mode": hist_mode, "wave_mode": wave_mode,
           "histogram_launches": hist_launches,
           "wave_launches": wave_launches,
           "histogram_launches_per_iteration": hist_launches / iters,
           "wave_launches_per_iteration": wave_launches / iters,
           "leaves_per_tree": float(np.mean(
               [t.num_leaves for t in bst._gbdt.models[0]])),
           "packed4": bool(bst._gbdt.grower_cfg.packed4),
           "bins_device_shape": list(bst._gbdt.bins_dev.shape),
           "holdout_auc": holdout_auc}
    if ref is not None:
        ref_auc, tol = ref
        require(abs(holdout_auc - ref_auc) < tol,
                f"{name}: holdout AUC {holdout_auc} not within {tol} of "
                f"genuine LightGBM's {ref_auc}")
        rec.update(ref_auc=ref_auc, auc_gap=holdout_auc - ref_auc,
                   auc_tolerance=tol)
    emit(rec)
    return bst, params, rec


def training_phases(seed, dev, smi):
    """Phases 8-58; returns the histogram and wave entries of the kernels
    line, every mode, phase 35's serving record and phases 46's, 50's and
    54's traversal launches."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.models.tree import quantize_error_bound
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops import traverse
    from lightgbm_tpu_torch.ops import wave as WV
    from lightgbm_tpu_torch.ops.histogram import histogram_segment
    from lightgbm_tpu_torch.ops.split import SplitConfig
    root = os.path.dirname(os.path.abspath(__file__))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    hist_err = histogram_phase(gen, dev)
    wave_phase(gen, dev)
    hist8_err = histogram_int8_phase(gen, dev)
    wave_int8_phase(gen, dev)
    new_hist_err = new_mode_histogram_phase(gen, dev)
    new_mode_wave_phase(gen, dev)
    twin_histogram_phase(gen, dev)
    twin_wave_phase(gen, dev)
    u16_err = uint16_histogram_phase(gen, dev)
    u16_wave_err = uint16_wave_phase(gen, dev)
    fix = load_bench_fixture(root)
    rows = bench_rows(fix)
    Xv = rows[0][fix["data"]["n_train"]:]
    ds, binning_s = bench_dataset(fix, rows, fix["params"]["max_bin"])
    emit({"phase": "binning", "max_bin": fix["params"]["max_bin"],
          "rows": fix["data"]["n_train"], "seconds": binning_s})
    bst, params, rec = train_phase(dev, fix, rows, "train", {}, ds, "f32",
                                   "f32", ref=(fix["ref_auc"], 1e-3))
    _qbst, qparams, qrec = train_phase(
        dev, fix, rows, "train_quantized", {"use_quantized_grad": True}, ds,
        "int8", "int8", ref=(fix["ref_auc_quantized"], 3e-3))

    # 11. determinism (f32 and quantized)
    for name, prm in (("f32", params), ("quantized", qparams)):
        t0 = time.perf_counter()
        m1 = lgt.train(prm, ds, 10, device=dev).model_to_string()
        m2 = lgt.train(prm, ds, 10, device=dev).model_to_string()
        require(m1 == m2, f"two 10-iteration {name} runs gave different "
                "model text")
        emit({"phase": "determinism", "training": name, "iterations": 10,
              "equal": True, "model_bytes": len(m1),
              "seconds": time.perf_counter() - t0})

    # 12. serving the trained model
    rng = np.random.RandomState(seed)
    rows_s = Xv[rng.randint(0, Xv.shape[0], 65_536)]
    pred = bst.serving_predictor(quantize="int16", raw_score=True)
    traverse.launches = 0
    served = pred.predict(rows_s)
    torch.cuda.synchronize()
    launches = traverse.launches
    want = bst.predict(rows_s, raw_score=True)
    bound = quantize_error_bound(pred.plan._packs[0])
    # the fp32 pack sums T leaf values in float32: allow its rounding too
    slack = bst.num_trees() * 2.0 ** -23 * float(np.abs(want).max())
    err = float(np.abs(served - want).max())
    require(launches == 1, f"{launches} traversal launches for 1 request")
    require(err <= bound + slack, f"served int16 scores off by {err} "
            f"(bound {bound} + {slack})")
    emit({"phase": "serve_trained", "rows": 65_536, "launches": launches,
          "max_abs_err": err, "quantize_error_bound": bound,
          "f32_slack": slack})

    # 13. where a training iteration's time goes (f32, then quantized)
    emit(profile_phase(params, ds, dev))
    emit({**profile_phase(qparams, ds, dev), "training": "quantized"})

    # 14. timing
    timing = {}
    for n in HIST_TIMING_ROWS:
        bins = torch.randint(0, 255, (n, 28), generator=gen, device=dev,
                             dtype=torch.uint8)
        vals = device_vals(gen, n, dev, exact=False)
        small = n <= 200_000
        entry = {"kernel_ms": cuda_time_ms(
            lambda: HF.histogram_flat(bins, vals, num_bins=255),
            iters=20 if small else 5)}
        flat = (bins.long() + torch.arange(28, device=dev)[None, :]
                * 255).reshape(-1)
        src = vals[:, None, :].expand(n, 28, 3).reshape(-1, 3)
        acc = torch.zeros(28 * 255, 3, device=dev)
        entry["library_ms"] = cuda_time_ms(
            lambda: acc.index_add_(0, flat, src), iters=20 if small else 5)
        del flat, src
        if small:
            entry["plain_ms"] = cuda_time_ms(
                lambda: histogram_segment(bins, vals, num_bins=255), iters=20)
        entry["bytes_ms"], entry["ops_ms"] = hist_bound_ms(n, 28, 255)
        timing[f"histogram/{n}"] = entry
        del bins, vals
    torch.cuda.empty_cache()
    sizes = list(WAVE_TIMING_SIZES)
    inp = wave_case(gen, dev, sizes, exact=False)
    cfg = SplitConfig(min_data_in_leaf=0, min_sum_hessian_in_leaf=100.0,
                      max_cat_to_onehot=4)
    w_entry = {
        "kernel_ms": cuda_time_ms(lambda: WV.fused_wave_call(cfg=cfg, **inp),
                                  iters=20),
        "plain_ms": cuda_time_ms(lambda: WV.wave_plain(cfg=cfg, **inp),
                                 iters=3, warmup=1)}
    h1, p1 = WV.fused_wave_call(cfg=cfg, **inp)
    hp, pp = WV.wave_plain(cfg=cfg, **inp)
    w_entry["max_abs_err"] = float((h1 - hp).abs().max())
    w_entry["agreement"] = wave_agreement(h1, p1, hp, pp, inp)
    w_entry["bytes_ms"], w_entry["ops_ms"] = wave_bound_ms(inp)
    w_entry["stage_ms"] = wave_stage_ms(
        lambda: WV.fused_wave_call(cfg=cfg, **inp))
    timing[f"wave/{len(sizes)}x{sizes[0]}"] = w_entry
    emit({"phase": "training_timing", "nvidia_smi": smi, "shapes": timing})
    del inp, h1, p1, hp, pp
    timing8 = int8_timing(gen, dev, smi)

    # 21-22. packed4 and bf16 training; 23. their kernel times
    runs4 = slice4_training(dev, fix, rows, ds)
    timing4 = new_mode_timing(gen, dev, smi)

    # 27-28. max_bin 1023 training on the unfused wave through the uint16
    # histogram modes; their times
    runs16, ds_w, unfused16 = wide_training(dev, fix, rows, ds)
    timing16 = uint16_timing(gen, dev, smi)
    # 30-31. max_bin 1023 training through the fused uint16 wave; its times
    fused16 = wide_fused_training(dev, fix, rows, ds_w, rec, unfused16)
    del ds_w
    timing16w = uint16_wave_timing(gen, dev, smi, fused16)
    # 32-37. the regression and multiclass objectives, valid sets, metrics
    # and early stopping (slice 11)
    obj_launches, obj_serve = objective_phases(dev, fix, rows, ds, binning_s,
                                               seed)
    # 38-42. text-file input, model text, continued training and
    # per-feature bins (slice 12)
    s12_launches = slice12_phases(dev, fix, rows, ds, bst, rec)
    # 43-47. sampling, the kernels under masks, cv and learning to rank
    # (slice 13)
    s13_launches = slice13_phases(gen, dev, fix, rows, ds)
    # 48-51. sorted many-vs-many categorical splits (slice 15)
    s15_launches = slice15_phases(dev, fix, rec, seed)
    # 52-54. exclusive feature bundling (slice 16)
    s16_launches, s16 = slice16_phases(dev, fix, rec, seed)
    # 55-58. the histogram pool and the tiled scan (slice 17)
    s17_launches = slice17_phases(gen, dev, fix, rows, ds, rec, s16)
    del s16

    h = timing[f"histogram/{HIST_TIMING_ROWS[0]}"]
    h8 = timing8[f"histogram_int8/{HIST_TIMING_ROWS[0]}"]
    wave_key = f"{len(sizes)}x{sizes[0]}"
    w8 = timing8[f"wave_int8/{wave_key}"]
    rows0 = HIST_TIMING_ROWS[0]
    table = [("histogram", HIST_SOURCE, HIST_REPLACES, h,
              rec["histogram_launches"], hist_err, rows0),
             ("histogram_int8", HIST_SOURCE, HIST_REPLACES, h8,
              qrec["histogram_launches"], hist8_err, rows0),
             ("wave", WAVE_SOURCE, WAVE_REPLACES, w_entry,
              rec["wave_launches"], w_entry["max_abs_err"], sum(sizes)),
             ("wave_int8", WAVE_SOURCE, WAVE_REPLACES, w8,
              qrec["wave_launches"], w8["max_abs_err"], sum(sizes))]
    for mode in NEW_MODES:
        th = timing4[f"histogram_{mode}/{rows0}"]
        tw = timing4[f"wave_{mode}/{wave_key}"]
        table += [(f"histogram_{mode}", HIST_SOURCE, HIST_REPLACES, th,
                   runs4["histogram"][mode], new_hist_err[mode], rows0),
                  (f"wave_{mode}", WAVE_SOURCE, WAVE_REPLACES, tw,
                   runs4["wave"][mode], tw["max_abs_err"], sum(sizes))]
    for mode in U16_MODES:
        # launches: phase 27's unfused runs and phase 30's fused ones
        table += [(f"histogram_{mode}", HIST_SOURCE, HIST_REPLACES,
                   timing16[f"histogram_{mode}/{rows0}"],
                   runs16[mode] + fused16[mode][0], u16_err[mode], rows0),
                  (f"wave_{mode}", WAVE_SOURCE, WAVE_REPLACES,
                   timing16w[f"wave_{mode}/B={WIDE_MAX_BIN}/{wave_key}"],
                   fused16[mode][1], u16_wave_err[mode], sum(sizes))]
    entries = []
    s13_modes = {"histogram": ("f32", "histogram"), "wave": ("f32", "wave"),
                 "histogram_int8": ("int8", "histogram"),
                 "wave_int8": ("int8", "wave")}
    obj_modes = {"histogram": "f32", "histogram_int8": "int8", "wave": "f32",
                 "wave_int8": "int8"}
    s16_modes = dict(s13_modes, **{
        f"{kernel}_{mode}": (mode, kernel) for kernel in ("histogram", "wave")
        for mode in ("f32_uint16", "int8_uint16")})
    s17_modes = dict(s13_modes, histogram_bf16=("bf16", "histogram"),
                     wave_bf16=("bf16", "wave"))
    s12_modes = {"histogram": ("f32", "histogram"), "wave": ("f32", "wave"),
                 "histogram_f32_uint16": ("f32_uint16", "histogram"),
                 "wave_f32_uint16": ("f32_uint16", "wave")}
    for name, src_, rep, t, launches_, err_, nrows in table:
        require(launches_ > 0, f"{name}: no launch on its training path")
        extra = {}
        if name in s12_modes:
            # launches on phases 38-42's paths (files, continued training,
            # per-feature bins)
            mode, kernel = s12_modes[name]
            extra["slice12_launches"] = s12_launches[mode][kernel]
            require(extra["slice12_launches"] > 0,
                    f"{name}: no launch on the slice-12 paths")
        if name in s13_modes:
            # launches on phases 43-47's paths (sampling, cv, ranking)
            mode, kernel = s13_modes[name]
            extra["slice13_launches"] = s13_launches[mode][kernel]
            require(extra["slice13_launches"] > 0,
                    f"{name}: no launch on the slice-13 paths")
        if name in s13_modes:
            # launches on phases 48-51's paths (sorted categorical splits)
            mode, kernel = s13_modes[name]
            extra["slice15_launches"] = s15_launches[mode][kernel]
            require(extra["slice15_launches"] > 0,
                    f"{name}: no launch on the slice-15 paths")
        if name in s16_modes:
            # launches on phases 52-54's paths (EFB bundling)
            mode, kernel = s16_modes[name]
            extra["slice16_launches"] = s16_launches[mode][kernel]
            require(extra["slice16_launches"] > 0,
                    f"{name}: no launch on the slice-16 paths")
        if name in s17_modes:
            # launches on phases 55-58's paths (the pool, tiled scans)
            mode, kernel = s17_modes[name]
            extra["slice17_launches"] = s17_launches.get(mode, {}).get(
                kernel, 0)
            require(extra["slice17_launches"] > 0,
                    f"{name}: no launch on the slice-17 paths")
        if name in obj_modes:
            # launches on phases 32-37's paths (objectives, valid sets)
            kernel = name.split("_")[0]
            extra["objective_launches"] = obj_launches[kernel].get(
                obj_modes[name], 0)
            require(extra["objective_launches"] > 0,
                    f"{name}: no launch on the objectives' paths")
        entries.append({
            "name": name, "route": "cuda", "source": src_, "replaces": rep,
            "matches_plain": True, "launches": launches_,
            "max_abs_err": err_, "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": max(t["bytes_ms"], t["ops_ms"]),
            "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                         else "operations"),
            "library_ms": t.get("library_ms"), "rows": nrows, **extra,
            **({"stage_ms": t["stage_ms"]} if "stage_ms" in t else {})})
    return entries, obj_serve, s13_launches["traverse"], \
        s15_launches["traverse"], s16_launches["traverse"]


def int8_timing(gen, dev, smi):
    """18. The int8 modes' times at the timing shapes, their plain
    versions, the int32 ``index_add_`` yardstick and the bounds."""
    import torch
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops import wave as WV
    from lightgbm_tpu_torch.ops.histogram import histogram_segment
    from lightgbm_tpu_torch.ops.split import SplitConfig
    timing = {}
    for n in HIST_TIMING_ROWS:
        bins = torch.randint(0, 255, (n, 28), generator=gen, device=dev,
                             dtype=torch.uint8)
        levels = device_levels(gen, n, dev)
        small = n <= 200_000
        iters = 20 if small else 5
        entry = {"kernel_ms": cuda_time_ms(
            lambda: HF.histogram_flat(bins, levels, num_bins=255),
            iters=iters)}
        flat = (bins.long() + torch.arange(28, device=dev)[None, :]
                * 255).reshape(-1)
        src = levels.int()[:, None, :].expand(n, 28, 3).reshape(-1, 3)
        acc = torch.zeros(28 * 255, 3, dtype=torch.int32, device=dev)
        entry["library_ms"] = cuda_time_ms(
            lambda: acc.index_add_(0, flat, src), iters=iters)
        del flat, src
        if small:
            entry["plain_ms"] = cuda_time_ms(
                lambda: histogram_segment(bins, levels, num_bins=255),
                iters=20)
            entry["stage_ms"] = kernel_stage_ms(
                lambda: HF.histogram_flat(bins, levels, num_bins=255))
        entry["bytes_ms"], entry["ops_ms"] = hist_bound_ms(n, 28, 255,
                                                           val_bytes=3)
        timing[f"histogram_int8/{n}"] = entry
        del bins, levels
    # slice 10: every row of a feature in one bin (the first int8 design's
    # lanes met 32-fold on each cell)
    n = HIST_TIMING_ROWS[0]
    bins = hot_bins(device_bins(gen, n, 28, 255, dev), "one_bin", 255)
    levels = device_levels(gen, n, dev)
    fn = lambda: HF.histogram_flat(bins, levels, num_bins=255)
    timing[f"histogram_int8/{n}/one_bin"] = {
        "kernel_ms": cuda_time_ms(fn, iters=20),
        "stage_ms": kernel_stage_ms(fn)}
    del bins, levels
    torch.cuda.empty_cache()
    cfg8 = SplitConfig(min_data_in_leaf=0, min_sum_hessian_in_leaf=100.0,
                       max_cat_to_onehot=4)
    rand = torch.rand(2, generator=gen, device=dev) * 0.02 + 1e-3
    for sizes, pattern in ([(list(s), None) for s in I8_SMALL_WAVES]
                           + [(list(WAVE_TIMING_SIZES), "one_bin")]):
        inp = wave_case(gen, dev, sizes, True,
                        scales=(float(rand[0]), float(rand[1]), 1.0),
                        edit=lane_pattern(pattern, 255) if pattern else None)
        fn = lambda: WV.fused_wave_call(cfg=cfg8, **inp)
        entry = {"kernel_ms": cuda_time_ms(fn, iters=20),
                 "stage_ms": wave_stage_ms(fn)}
        entry["bytes_ms"], entry["ops_ms"] = wave_bound_ms(inp)
        timing[f"wave_int8/{len(sizes)}x{sizes[0]}"
               + (f"/{pattern}" if pattern else "")] = entry
        del inp
    sizes = list(WAVE_TIMING_SIZES)
    rand = torch.rand(2, generator=gen, device=dev) * 0.02 + 1e-3
    inp = wave_case(gen, dev, sizes, True,
                    scales=(float(rand[0]), float(rand[1]), 1.0))
    cfg = SplitConfig(min_data_in_leaf=0, min_sum_hessian_in_leaf=100.0,
                      max_cat_to_onehot=4)
    w_entry = {
        "kernel_ms": cuda_time_ms(lambda: WV.fused_wave_call(cfg=cfg, **inp),
                                  iters=20),
        "plain_ms": cuda_time_ms(lambda: WV.wave_plain(cfg=cfg, **inp),
                                 iters=3, warmup=1)}
    h1, p1 = WV.fused_wave_call(cfg=cfg, **inp)
    hp, pp = WV.wave_plain(cfg=cfg, **inp)
    require(torch.equal(h1, hp), "int8 timing wave histograms != plain")
    sh = WV.scale_hist(hp, inp["scale3"])
    w_entry["max_abs_err"] = float((WV.scale_hist(h1, inp["scale3"])
                                    - sh).abs().max())
    w_entry["agreement"] = wave_agreement(sh, p1, sh, pp, inp)
    w_entry["bytes_ms"], w_entry["ops_ms"] = wave_bound_ms(inp)
    w_entry["stage_ms"] = wave_stage_ms(
        lambda: WV.fused_wave_call(cfg=cfg, **inp))
    timing[f"wave_int8/{len(sizes)}x{sizes[0]}"] = w_entry
    emit({"phase": "training_timing_int8", "nvidia_smi": smi,
          "shapes": timing})
    return timing


# ------------------------------------------ slice 4: bf16 and 4-bit bins
def mode_bins(gen, n, f, mode, dev):
    """Bins for a mode's kernel-vs-plain check: 255 bins (16, packed into
    nibble pairs, for a packed4 mode) with NaN bins; (bins, num_bins)."""
    from lightgbm_tpu_torch.ops.histogram import pack_bins4
    packed4 = mode.endswith("packed4")
    b = 16 if packed4 else 255
    bins = device_bins(gen, n, f, b, dev)
    return (pack_bins4(bins) if packed4 else bins), b


def mode_vals(gen, n, mode, dev, exact):
    """Values for a mode: int8 levels, or f32 (exact sums or random),
    rounded to bf16 for a bf16 mode."""
    import torch
    if mode.startswith("int8"):
        return device_levels(gen, n, dev)
    vals = device_vals(gen, n, dev, exact)
    return vals.to(torch.bfloat16) if mode.startswith("bf16") else vals


def base_launch_inputs(bins, vals, f, mode):
    """The kernel's unpacked / f32 counterpart inputs of a mode's launch:
    unpacked bins, and the bf16 values widened to f32 (exact)."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import unpack_bins4
    if mode.endswith("packed4"):
        bins = unpack_bins4(bins, f).contiguous()
    if vals.dtype == torch.bfloat16:
        vals = vals.float()
    return bins, vals


def new_mode_histogram_phase(gen, dev):
    """19. The histogram kernel's bf16 and packed4 modes against their
    plain versions at F = 28 and 27: bitwise on exact sums, within
    HIST_RTOL relative on random values (bitwise for int8 levels),
    run-to-run bitwise, and bitwise equal to the kernel's own unpacked /
    f32 launch on the same rows and the bf16-rounded values.  Returns
    each mode's largest error at the most random rows, F = 28."""
    import torch
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops.histogram import histogram_segment
    out, err_200k = {}, {}
    for mode in NEW_MODES:
        packed4 = mode.endswith("packed4")
        for f in (28, 27):
            for n in CHECK_ROWS:
                for exact in (True, False):
                    bins, b = mode_bins(gen, n, f, mode, dev)
                    vals = mode_vals(gen, n, mode, dev, exact)
                    kw = dict(num_bins=b, packed4=packed4,
                              features=f if packed4 else 0)
                    got = HF.histogram_flat(bins, vals, **kw)
                    again = HF.histogram_flat(bins, vals, **kw)
                    bb, bv = base_launch_inputs(bins, vals, f, mode)
                    base = HF.histogram_flat(bb, bv, num_bins=b)
                    plain = histogram_segment(bins, vals, **kw)
                    torch.cuda.synchronize()
                    tag = f"{mode} F={f} N={n} {'exact' if exact else 'random'}"
                    require(torch.equal(got, again),
                            f"histogram {tag}: not run-to-run bitwise")
                    require(torch.equal(got, base), f"histogram {tag} != "
                            "the kernel's unpacked / f32 launch")
                    err = float((got - plain).abs().max())
                    scale = float(plain.abs().max())
                    if exact or mode.startswith("int8"):
                        require(torch.equal(got, plain),
                                f"histogram {tag} != plain version")
                    else:
                        require(err <= HIST_RTOL * scale,
                                f"histogram {tag} off by {err} (scale "
                                f"{scale})")
                    out[tag] = {"max_abs_err": err,
                                "rel_err": err / max(scale, 1e-30)}
                    if f == 28 and n == CHECK_ROWS[-1] and not exact:
                        err_200k[mode] = err
    emit({"phase": "histogram_new_modes_vs_plain", "rtol": HIST_RTOL,
          "bitwise_vs_base_launch": True, "cases": out})
    return err_200k


def new_mode_wave_phase(gen, dev):
    """20. The wave kernel's bf16 and packed4 modes against their plain
    versions at F = 28 and 27, W = 1 and W = 16 with inactive slots:
    bitwise on exact sums (int8: histograms always, payloads on
    power-of-two scales), ``wave_agreement`` on random values,
    run-to-run bitwise, and bitwise equal to the kernel's own unpacked /
    f32 launch."""
    import torch
    from lightgbm_tpu_torch.ops import wave as WV
    from lightgbm_tpu_torch.ops.split import SplitConfig
    cfg = SplitConfig(min_data_in_leaf=0, min_sum_hessian_in_leaf=1.0,
                      lambda_l2=0.5, max_cat_to_onehot=4)
    rand = torch.rand(2, generator=gen, device=dev) * 0.02 + 1e-3
    random_scales = (float(rand[0]), float(rand[1]), 1.0)
    out = {}
    for mode in NEW_MODES:
        packed4 = mode.endswith("packed4")
        int8 = mode.startswith("int8")
        kinds = ((("pow2", True, POW2_SCALES),
                  ("random_scales", True, random_scales)) if int8
                 else (("exact", True, None), ("random", False, None)))
        for f in (28, 27):
            for name, (sizes, inactive) in CHECK_WAVES.items():
                for kind, exact, scales in kinds:
                    inp = wave_case(gen, dev, sizes, exact, f=f,
                                    b=16 if packed4 else 255,
                                    inactive=inactive, scales=scales,
                                    mode=mode)
                    h1, p1 = WV.fused_wave_call(cfg=cfg, **inp)
                    h2, p2 = WV.fused_wave_call(cfg=cfg, **inp)
                    bb, bv = base_launch_inputs(inp["bins"], inp["vals"], f,
                                                mode)
                    hb, pb = WV.fused_wave_call(
                        cfg=cfg, **dict(inp, bins=bb, vals=bv,
                                        packed4=False))
                    hp, pp = WV.wave_plain(cfg=cfg, **inp)
                    torch.cuda.synchronize()
                    tag = f"{mode} F={f} {name} {kind}"
                    require(torch.equal(h1, h2) and torch.equal(p1, p2),
                            f"wave {tag}: not run-to-run bitwise")
                    require(torch.equal(h1, hb) and torch.equal(p1, pb),
                            f"wave {tag} != the kernel's unpacked / f32 "
                            "launch")
                    for j in inactive:
                        require(bool(torch.isinf(p1[j, :, 0]).all()),
                                f"wave {tag}: inactive slot {j} has a "
                                "finite gain")
                    if exact:
                        require(torch.equal(h1, hp),
                                f"wave {tag}: histograms != plain version")
                    if exact and kind != "random_scales":
                        require(torch.equal(p1, pp),
                                f"wave {tag}: payload != plain version")
                    if int8:
                        sh = WV.scale_hist(hp, inp["scale3"])
                        agree = wave_agreement(sh, p1, sh, pp, inp)
                    else:
                        agree = wave_agreement(h1, p1, hp, pp, inp)
                    out[tag] = {"slots": len(sizes), "rows": sum(sizes),
                                "payload_equal": bool(torch.equal(p1, pp)),
                                **agree}
    emit({"phase": "wave_new_modes_vs_plain", "bitwise_vs_base_launch": True,
          "cases": out})


def twin_histogram_phase(gen, dev):
    """24. The f32 / bf16 histogram modes against the plain twin of their
    summation order, bit for bit on random values."""
    import torch
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops.histogram import histogram_chunked, pack_bins4
    out = {}

    def check(tag, bins, vals, b, packed4, f):
        kw = dict(num_bins=b, packed4=packed4, features=f if packed4 else 0)
        got = HF.histogram_flat(bins, vals, **kw)
        want = histogram_chunked(bins, vals, **kw)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"histogram {tag} != its chunk-"
                f"ordered twin (off by {float((got - want).abs().max())})")
        out[tag] = {"bitwise": True, "rows": int(bins.shape[0]),
                    "bins": b, "features": f}

    for mode in TWIN_MODES:
        packed4 = mode.endswith("packed4")
        for f in (28, 27) if packed4 else (28,):
            for n in TWIN_ROWS:
                bins, b = mode_bins(gen, n, f, mode, dev)
                check(f"{mode} F={f} N={n}", bins,
                      mode_vals(gen, n, mode, dev, exact=False), b, packed4,
                      f)
        # every row in bin 0: each step's 32 lanes are one group
        bins, b = mode_bins(gen, 20_000, 28, mode, dev)
        check(f"{mode} one bin", torch.zeros_like(bins),
              mode_vals(gen, 20_000, mode, dev, exact=False), b, packed4, 28)
    for b in (1, 256):
        bins = torch.randint(0, b, (20_000, 28), generator=gen, device=dev,
                             dtype=torch.uint8)
        check(f"f32 B={b}", bins, device_vals(gen, 20_000, dev, False), b,
              False, 28)
    for f in (1, 3):
        bins = pack_bins4(device_bins(gen, 20_000, f, 16, dev))
        check(f"f32_packed4 F={f}", bins, device_vals(gen, 20_000, dev,
                                                        False), 16, True, f)
    emit({"phase": "histogram_vs_chunked_twin", "random_values": True,
          "cases": out})


def twin_wave_phase(gen, dev):
    """25. The f32 / bf16 wave modes' child histograms against the twin of
    their summation order, bit for bit on random values; and a wave with
    no valid split, whose payload (key 0's) equals the plain version's."""
    import torch
    from lightgbm_tpu_torch.ops import wave as WV
    from lightgbm_tpu_torch.ops.split import SplitConfig
    cfg = SplitConfig(min_data_in_leaf=0, min_sum_hessian_in_leaf=1.0,
                      lambda_l2=0.5, max_cat_to_onehot=4)
    out = {}
    for mode in TWIN_MODES:
        packed4 = mode.endswith("packed4")
        for name, (sizes, inactive) in CHECK_WAVES.items():
            inp = wave_case(gen, dev, sizes, False, b=16 if packed4 else 255,
                            inactive=inactive, mode=mode)
            h, p = WV.fused_wave_call(cfg=cfg, **inp)
            want = WV.wave_hists_chunked(
                inp["bins"], inp["vals"], inp["perm"], inp["small_start"],
                inp["small_cnt"], inp["parent"], inp["stats"],
                inp["num_bins"], packed4=packed4)
            hp, pp = WV.wave_plain(cfg=cfg, **inp)
            torch.cuda.synchronize()
            tag = f"{mode} {name}"
            require(torch.equal(h, want), f"wave {tag}: child histograms != "
                    "their chunk-ordered twin (off by "
                    f"{float((h - want).abs().max())})")
            out[tag] = {"hist_bitwise": True, "slots": len(sizes),
                        **wave_agreement(h, p, hp, pp, inp)}
    none = SplitConfig(min_data_in_leaf=10 ** 9, min_sum_hessian_in_leaf=1.0,
                       lambda_l2=0.5, max_cat_to_onehot=4)
    sizes, inactive = CHECK_WAVES["W16"]
    inp = wave_case(gen, dev, sizes, True, inactive=inactive)
    h, p = WV.fused_wave_call(cfg=none, **inp)
    hp, pp = WV.wave_plain(cfg=none, **inp)
    torch.cuda.synchronize()
    require(bool(torch.isinf(p[:, :, 0]).all()), "a child split under "
            "min_data_in_leaf = 1e9")
    require(torch.equal(h, hp) and torch.equal(p, pp),
            "all -inf wave != plain version")
    require(not bool(p[:, :, 1:3].any()), "all -inf children did not "
            "select key 0")
    out["no valid split"] = {"payload_bitwise": True, "slots": len(sizes)}
    emit({"phase": "wave_vs_chunked_twin", "random_values": True,
          "cases": out})


#: depths of phases 21 and 22's comparison runs, cut in slice 13 to make
#: room for phases 43-47 (widths unchanged)
PACKED4_ITERS = 50
BF16_UNFUSED_ITERS = 10


def resident_bins(bst):
    b = bst._gbdt.bins_dev
    return {"shape": list(b.shape), "dtype": str(b.dtype),
            "bytes": b.numel() * b.element_size()}


def slice4_training(dev, fix, rows, ds):
    """21. packed4 training at max_bin 15 (f32, quantized, bf16), each
    with model text equal to the same run with tpu_4bit_bins=false but for
    the parameter line that records it; 22. bf16 training at the bench
    config, fused (AUC gate) and unfused (every smaller sibling through
    the bf16 histogram), and its determinism.  Returns the launches of
    each new mode on its training path."""
    import torch
    import lightgbm_tpu_torch as lgt
    main = {"histogram": {}, "wave": {}}

    # 21. packed4 at max_bin 15: the rows binned once
    ds15, binning_s = bench_dataset(fix, rows, 15)
    b15 = ds15.construct()
    emit({"phase": "binning", "max_bin": 15, "rows": fix["data"]["n_train"],
          "max_num_bins": int(b15.binned.max_num_bins), "seconds": binning_s})
    nt, f = fix["data"]["n_train"], fix["data"]["n_features"]
    for name, extra, mode, base in (
            ("f32", {}, "f32_packed4", "f32"),
            ("quantized", {"use_quantized_grad": True}, "int8_packed4",
             "int8"),
            ("bf16", {"tpu_histogram_impl": "flat_bf16",
                      "tpu_wave_kernel": "fused"}, "bf16_packed4", "bf16")):
        extra = dict(extra, max_bin=15)
        bst, _, rec = train_phase(dev, fix, rows, f"train_packed4_{name}",
                                  extra, ds15, mode, mode,
                                  iters=PACKED4_ITERS)
        require(bst._gbdt.grower_cfg.packed4, "max_bin 15 did not pack")
        dbins = bst._gbdt.bins_dev
        require(tuple(dbins.shape) == (nt, (f + 1) // 2)
                and dbins.dtype == torch.uint8,
                f"packed device bins {tuple(dbins.shape)} {dbins.dtype}")
        packed = resident_bins(bst)
        text = bst.model_to_string()
        main["histogram"][mode] = rec["histogram_launches"]
        main["wave"][mode] = rec["wave_launches"]
        del bst
        off, _, rec_off = train_phase(
            dev, fix, rows, f"train_unpacked_{name}",
            dict(extra, tpu_4bit_bins=False), ds15, base, base,
            iters=PACKED4_ITERS)
        require(not off._gbdt.grower_cfg.packed4, "tpu_4bit_bins=false packed")
        same = drop_param(off.model_to_string(),
                          "[tpu_4bit_bins: False]") == text
        require(same, f"packed4 {name} model text != unpacked run's")
        emit({"phase": "packed4_equals_unpacked", "training": name,
              "iterations": rec["iterations"], "model_text_equal": True,
              "model_bytes": len(text),
              "resident_bins_packed": packed,
              "resident_bins_unpacked": resident_bins(off),
              "s_per_iteration_packed": rec["s_per_iteration"],
              "s_per_iteration_unpacked": rec_off["s_per_iteration"],
              "holdout_auc": rec["holdout_auc"]})
        del off
    del ds15, b15
    torch.cuda.empty_cache()

    # 22. bf16 at the bench config
    bf16 = {"tpu_histogram_impl": "flat_bf16"}
    fused = dict(bf16, tpu_wave_kernel="fused")
    _b, params_f, rec_f = train_phase(
        dev, fix, rows, "train_bf16_fused", fused, ds, "bf16", "bf16",
        ref=(fix["ref_auc"], 3e-3))
    del _b
    unf, _, rec_u = train_phase(dev, fix, rows, "train_bf16_unfused", bf16,
                                ds, "bf16", None, iters=BF16_UNFUSED_ITERS)
    leaves = sum(t.num_leaves for t in unf._gbdt.models[0])
    require(rec_u["histogram_launches"] == leaves,
            f"unfused bf16: {rec_u['histogram_launches']} histogram "
            f"launches for {leaves} leaves (one per root and per smaller "
            "sibling)")
    main["histogram"]["bf16"] = (rec_f["histogram_launches"]
                                 + rec_u["histogram_launches"])
    main["wave"]["bf16"] = rec_f["wave_launches"]
    del unf
    t0 = time.perf_counter()
    m1 = lgt.train(params_f, ds, 10, device=dev).model_to_string()
    m2 = lgt.train(params_f, ds, 10, device=dev).model_to_string()
    require(m1 == m2, "two 10-iteration bf16 runs gave different model text")
    emit({"phase": "determinism", "training": "bf16_fused", "iterations": 10,
          "equal": True, "model_bytes": len(m1),
          "seconds": time.perf_counter() - t0,
          "unfused_histogram_launches": rec_u["histogram_launches"],
          "unfused_leaves": leaves})
    return main


def new_mode_timing(gen, dev, smi):
    """23. The bf16 and packed4 modes' times at the timing shapes (B = 255
    for bf16, 16 for packed4), their plain versions, the bounds, and the
    library yardstick where one PyTorch call computes the function: for
    bf16, ``index_add_`` over the bf16-rounded values in f32 (the rounding
    not timed); for packed4, no single call unpacks the nibbles."""
    import torch
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops import wave as WV
    from lightgbm_tpu_torch.ops.histogram import histogram_segment
    from lightgbm_tpu_torch.ops.split import SplitConfig
    timing = {}
    f = 28
    for mode in NEW_MODES:
        packed4 = mode.endswith("packed4")
        val_bytes = {"bf16": 6, "int8": 3}.get(mode.split("_")[0], 12)
        for n in HIST_TIMING_ROWS:
            bins, b = mode_bins(gen, n, f, mode, dev)
            vals = mode_vals(gen, n, mode, dev, exact=False)
            kw = dict(num_bins=b, packed4=packed4,
                      features=f if packed4 else 0)
            small = n <= 200_000
            iters = 20 if small else 5
            entry = {"kernel_ms": cuda_time_ms(
                lambda: HF.histogram_flat(bins, vals, **kw), iters=iters),
                     "resident_bin_bytes": bins.numel()}
            if mode == "bf16":
                flat = (bins.long() + torch.arange(f, device=dev)[None, :]
                        * b).reshape(-1)
                src = vals.float()[:, None, :].expand(n, f, 3).reshape(-1, 3)
                acc = torch.zeros(f * b, 3, device=dev)
                entry["library_ms"] = cuda_time_ms(
                    lambda: acc.index_add_(0, flat, src), iters=iters)
                del flat, src
            else:
                entry["library_ms"] = None
            if small:
                entry["plain_ms"] = cuda_time_ms(
                    lambda: histogram_segment(bins, vals, **kw), iters=20)
            entry["bytes_ms"], entry["ops_ms"] = hist_bound_ms(
                n, f, b, val_bytes=val_bytes, bin_bytes=bins.shape[1])
            timing[f"histogram_{mode}/{n}"] = entry
            del bins, vals
        torch.cuda.empty_cache()
        sizes = list(WAVE_TIMING_SIZES)
        scales = None
        if mode.startswith("int8"):
            rand = torch.rand(2, generator=gen, device=dev) * 0.02 + 1e-3
            scales = (float(rand[0]), float(rand[1]), 1.0)
        inp = wave_case(gen, dev, sizes, exact=scales is not None,
                        b=16 if packed4 else 255, scales=scales, mode=mode)
        cfg = SplitConfig(min_data_in_leaf=0, min_sum_hessian_in_leaf=100.0,
                          max_cat_to_onehot=4)
        w_entry = {
            "kernel_ms": cuda_time_ms(
                lambda: WV.fused_wave_call(cfg=cfg, **inp), iters=20),
            "plain_ms": cuda_time_ms(lambda: WV.wave_plain(cfg=cfg, **inp),
                                     iters=3, warmup=1),
            "library_ms": None}
        h1, p1 = WV.fused_wave_call(cfg=cfg, **inp)
        hp, pp = WV.wave_plain(cfg=cfg, **inp)
        if scales is not None:
            require(torch.equal(h1, hp), f"{mode} timing wave histograms "
                    "!= plain")
            h1 = WV.scale_hist(h1, inp["scale3"])
            hp = WV.scale_hist(hp, inp["scale3"])
        w_entry["max_abs_err"] = float((h1 - hp).abs().max())
        w_entry["agreement"] = wave_agreement(h1, p1, hp, pp, inp)
        w_entry["bytes_ms"], w_entry["ops_ms"] = wave_bound_ms(inp)
        w_entry["stage_ms"] = wave_stage_ms(
            lambda: WV.fused_wave_call(cfg=cfg, **inp))
        timing[f"wave_{mode}/{len(sizes)}x{sizes[0]}"] = w_entry
        del inp, h1, p1, hp, pp
        torch.cuda.empty_cache()
    emit({"phase": "training_timing_new_modes", "nvidia_smi": smi,
          "shapes": timing})
    return timing


# --------------------------------- slice 7: uint16 bins (max_bin above 255)
#: the histogram kernel's uint16 modes (ops/histogram_flat.py::MODES)
U16_MODES = ("f32_uint16", "bf16_uint16", "int8_uint16")
#: phase 26's bin counts (65,536: eight bin tiles of 8,192) and rows; B =
#: 65,536 only at N <= 1,000 (its 28 x 65,536-cell twin is large); and
#: the Higgs row count at B = 1,023
U16_BINS = (257, 511, 1023, 4095, 65536)
U16_ROWS = (1, 1000, 200_000)
U16_LARGE = (10_500_000, 1023)
#: phase 27's training (the unfused wave): the max_bin, and the
#: iterations of each run (f32 at 10, where phase 30's fused run is held
#: to its AUC)
WIDE_MAX_BIN = 1023
WIDE_ITERS = {"f32": 10, "quantized": 5, "bf16": 3, "repeat": 2}
#: phase 29's uint16 waves: the bin counts (the scan tiled from 2,047 at
#: F = 28), and B = 65,536 at W = 1 over a few hundred rows (stage 1 in
#: eight bin tiles, the scan in 48)
U16_WAVE_BINS = (257, 511, 1023, 2047, 4095)
U16_WAVE_LARGE = ([300], 65536)
#: phase 30's fused runs: iterations (their s/iteration and AUC are
#: reported, not held to a bar; cut from 100 to keep the smoke within its
#: time limit), and the iterations at which fused and unfused runs are
#: held to one AUC (within FUSED_AUC_TOL) and two runs to one model text
FUSED_ITERS = 30
FUSED_CHECK_ITERS = 10
FUSED_AUC_TOL = 1e-3
#: phase 29's waves whose bins push the uint16 kernels: lane patterns of
#: the accumulation's grouping at B = 1,023 (``lane_pattern``), and an
#: exact gain tie between features 1 and 25, which the scan puts in
#: different blocks, at B = 257 and 1,023
U16_LANE_PATTERNS = ("one_bin", "runs_of_32", "pairs")
#: the int8 accumulation's hot-bin patterns (slice 10: one 64-bit shared
#: atomic a row-feature, so lanes on one cell serialize): lane_pattern's,
#: and half the rows in the NaN bin
I8_HOT_PATTERNS = ("one_bin", "runs_of_32", "nan_half")
#: slice 10's int8 waves: W = 1 and 4 smaller siblings of 12,500 rows
#: (where the first int8 design put 7 and 28 blocks on the card)
I8_SMALL_WAVES = ((12_500,), (12_500,) * 4)
U16_TIE = ((1, 25), (257, 1023))
#: phase 31's timed uint16 waves (F = 28): mode, B and slots (W = 16 x
#: 12,500, and W = 1 and 4 at B = 1,023 in f32, the scan's fewest blocks,
#: and in int8, the int8 stage 1's)
U16_WAVE_TIMING = (("f32_uint16", 1023, 16), ("bf16_uint16", 1023, 16),
                   ("int8_uint16", 1023, 16), ("f32_uint16", 511, 16),
                   ("int8_uint16", 2047, 16), ("f32_uint16", 1023, 4),
                   ("f32_uint16", 1023, 1), ("int8_uint16", 1023, 4),
                   ("int8_uint16", 1023, 1))


def lane_pattern(pattern, b, tie=(1, 25)):
    """A ``wave_case`` edit: bins that push the uint16 kernels.  Along the
    permutation (the order the wave's stage 1 reads rows in): ``one_bin``
    every row of a feature in one bin (each step's 32 lanes one group),
    ``runs_of_32`` each 32 rows on one bin, ``pairs`` rows 2k and 2k + 1
    on one bin (16 groups of two a step), ``nan_half`` every other row in
    bin b - 1 (the NaN bin of ``device_bins``) in every feature; ``tie``
    features ``tie`` hold the same bins and every other feature bin 0 (no
    valid split), so their gains tie exactly.  ``hot_bins`` applies one
    to rows in storage order."""
    import torch

    def edit(bins, perm):
        n, f = bins.shape
        if pattern == "nan_half":
            out = bins.clone()
            out[perm[::2]] = b - 1
            return out
        if pattern == "tie":
            a, z = tie
            keep = bins[:, a].clone()
            bins.zero_()
            bins[:, a] = keep
            bins[:, z] = keep
            return bins
        if pattern == "one_bin":
            return ((torch.arange(f, device=bins.device) * 37 + b // 2)
                    % b).expand(n, f).contiguous()
        run = {"runs_of_32": 32, "pairs": 2}[pattern]
        out = torch.empty_like(bins)
        out[perm] = bins[perm[::run]].repeat_interleave(run, dim=0)[:n]
        return out
    return edit


def hot_bins(bins, pattern, b):
    """``bins`` (on the card, uint8 or uint16) with ``lane_pattern``'s
    ``pattern`` applied to the rows in storage order."""
    import torch
    n = bins.shape[0]
    out = lane_pattern(pattern, b)(bins.long(), torch.arange(
        n, device=bins.device))
    return out.to(bins.dtype).contiguous()


def int8_hot_histograms(gen, dev, mode, b, n=200_000):
    """The int8 accumulation (slice 10) of ``mode`` at B = ``b`` against
    the plain int32 histogram on hot-bin rows (I8_HOT_PATTERNS), in
    storage order and permuted, bit for bit.  Returns the cases."""
    import torch
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops.histogram import (histogram_segment,
                                                  pack_bins4)
    packed4 = mode.endswith("packed4")
    cases = {}
    for pattern in I8_HOT_PATTERNS:
        bins = hot_bins(device_bins(gen, n, 28, b, dev), pattern, b)
        vals = device_levels(gen, n, dev)
        perm = torch.randperm(n, generator=gen, device=dev)
        for order, bb, vv in (("storage", bins, vals),
                              ("permuted", bins.index_select(0, perm),
                               vals[perm])):
            want = histogram_segment(bb, vv, num_bins=b)
            got = HF.histogram_flat(pack_bins4(bb) if packed4 else bb, vv,
                                    num_bins=b, packed4=packed4,
                                    features=28 if packed4 else 0)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"{mode} histogram on {pattern} "
                    f"rows ({order}) != plain version")
        cases[f"{mode} {pattern}"] = {"rows": n, "bins": b, "bitwise": True}
        del bins, vals, perm
    return cases


def int8_wave_checks(gen, dev, mode, b, cfg):
    """The int8 wave (slice 10's stage 1) of ``mode`` at B = ``b`` against
    ``wave_plain`` at W = 1 and 4 (I8_SMALL_WAVES) and on hot-bin rows
    along the permutation at W = 16 x 12,500 (``lane_pattern`` of each
    I8_HOT_PATTERNS), power-of-two scales: child histograms and payloads
    bit for bit.  Returns the cases."""
    import torch
    from lightgbm_tpu_torch.ops import wave as WV
    kind = "int8" if mode.endswith("uint16") else mode
    waves = [(f"W{len(s)}", list(s), None) for s in I8_SMALL_WAVES]
    waves += [(f"W16 {p}", list(WAVE_TIMING_SIZES), lane_pattern(p, b))
              for p in I8_HOT_PATTERNS]
    cases = {}
    for name, sizes, edit in waves:
        inp = wave_case(gen, dev, sizes, True, b=b, scales=POW2_SCALES,
                        mode=kind, edit=edit)
        h, p = WV.fused_wave_call(cfg=cfg, **inp)
        hp, pp = WV.wave_plain(cfg=cfg, **inp)
        torch.cuda.synchronize()
        require(torch.equal(h, hp) and torch.equal(p, pp),
                f"{mode} wave {name} B={b} != plain version")
        cases[f"{mode} {name}"] = {"slots": len(sizes), "rows": sum(sizes),
                                   "bins": b, "bitwise": True}
        del inp, h, p, hp, pp
    return cases


def hist_twin(bins, vals, *, num_bins, dtype="f32", packed4=False,
              features=0, max_level=127):
    """``histogram_flat``'s plain twin, call for call: f32 / bf16 values
    (bf16 rounded first, as the wrapper rounds them) through
    ``histogram_chunked``, the kernel's summation order; int8 levels
    through ``histogram_segment`` (exact int32 sums)."""
    import torch
    from lightgbm_tpu_torch.ops.histogram import (histogram_chunked,
                                                  histogram_segment)
    kw = dict(num_bins=num_bins, packed4=packed4, features=features)
    if vals.dtype == torch.int8:
        return histogram_segment(bins, vals, **kw)
    if dtype == "bf16":
        vals = vals.to(torch.bfloat16)
    return histogram_chunked(bins, vals, **kw)


def uint16_histogram_phase(gen, dev):
    """26. The histogram kernel's uint16 modes against their twins
    (``hist_twin``), bit for bit on random values: at every B of
    U16_BINS and N of U16_ROWS, and 10.5M rows at B = 1,023; rows in
    storage order, rows gathered through a permutation, and the unfused
    wave step's 16 smaller siblings (``wave_plain`` with the kernel and
    with the twin: child histograms and payloads bit for bit).  Returns
    each mode's largest error at 200,000 rows, B = 1,023."""
    import torch
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops import wave as WV
    from lightgbm_tpu_torch.ops.split import SplitConfig
    cfg = SplitConfig(min_data_in_leaf=0, min_sum_hessian_in_leaf=1.0,
                      lambda_l2=0.5, max_cat_to_onehot=4)
    out, err_200k = {}, {}

    def check(tag, bins, vals, b):
        got = HF.histogram_flat(bins, vals, num_bins=b)
        want = hist_twin(bins, vals, num_bins=b)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        require(torch.equal(got, want), f"histogram {tag} != its twin (off "
                f"by {err})")
        out[tag] = {"bitwise": True, "rows": int(bins.shape[0]), "bins": b}
        return err

    for mode in U16_MODES:
        for b in U16_BINS:
            for n in U16_ROWS:
                if b == 65536 and n > 1000:
                    continue
                bins = device_bins(gen, n, 28, b, dev)
                vals = mode_vals(gen, n, mode, dev, exact=False)
                err = check(f"{mode} B={b} N={n}", bins, vals, b)
                if n == U16_ROWS[-1]:
                    perm = torch.randperm(n, generator=gen, device=dev)
                    check(f"{mode} B={b} N={n} permuted",
                          bins.index_select(0, perm), vals[perm], b)
                    if b == WIDE_MAX_BIN:
                        err_200k[mode] = err
        n, b = U16_LARGE
        bins = device_bins(gen, n, 28, b, dev)
        check(f"{mode} B={b} N={n}", bins,
              mode_vals(gen, n, mode, dev, exact=False), b)
        del bins
        torch.cuda.empty_cache()
        sizes, inactive = CHECK_WAVES["W16"]
        inp = wave_case(gen, dev, sizes, False, b=WIDE_MAX_BIN,
                        inactive=inactive, mode=mode,
                        scales=POW2_SCALES if mode.startswith("int8")
                        else None)
        runs = [WV.wave_plain(cfg=cfg, histogram=lambda bb, vv, fn=fn: fn(
                    bb, vv, num_bins=WIDE_MAX_BIN), **inp)
                for fn in (HF.histogram_flat, hist_twin)]
        torch.cuda.synchronize()
        (hk, pk), (ht, pt) = runs
        require(torch.equal(hk, ht) and torch.equal(pk, pt),
                f"unfused wave over {mode} bins: the kernel's child "
                "histograms or payloads != the twin's")
        out[f"{mode} unfused wave W16"] = {
            "hist_bitwise": True, "payload_bitwise": True,
            "slots": len(sizes), "rows": sum(sizes), "bins": WIDE_MAX_BIN}
    out.update(int8_hot_histograms(gen, dev, "int8_uint16", WIDE_MAX_BIN))
    out.update(int8_hot_histograms(gen, dev, "int8_uint16", 65536,
                                   n=20_000))
    emit({"phase": "histogram_uint16_vs_twin", "random_values": True,
          "features": 28, "cases": out})
    return err_200k


def wide_training(dev, fix, rows, ds):
    """27. Training at max_bin 1023 on the bench rows, binned once: f32,
    quantized and bf16 with ``tpu_wave_kernel=unfused`` (the uint16
    histogram per root and per smaller sibling, no wave kernel); two f32
    runs give equal model text, and so do runs with ``histogram_flat``
    swapped for its twin (f32 and quantized); the f32 model served
    through ``Predictor`` (int16 pack) equals the numpy walk bit for bit.
    The holdout AUC stands beside the 255-bin run's at the same iteration
    count (no genuine-LightGBM number exists at 1,023 bins: no gate).
    Returns the launches of each uint16 histogram mode on its training
    path, the binned rows and each run's record."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops import traverse
    ds_w, binning_s = bench_dataset(fix, rows, WIDE_MAX_BIN)
    binned = ds_w.construct().binned
    nt, f = fix["data"]["n_train"], fix["data"]["n_features"]
    emit({"phase": "binning", "max_bin": WIDE_MAX_BIN, "rows": nt,
          "max_num_bins": int(binned.max_num_bins),
          "bins_dtype": str(binned.bins.dtype), "seconds": binning_s})
    require(binned.bins.dtype == np.uint16, "max_bin 1023 did not bin to "
            "uint16")
    wide = {"max_bin": WIDE_MAX_BIN, "tpu_wave_kernel": "unfused"}
    launches = {}
    runs = {}
    for name, extra, mode in (
            ("f32", {}, "f32_uint16"),
            ("quantized", {"use_quantized_grad": True}, "int8_uint16"),
            ("bf16", {"tpu_histogram_impl": "flat_bf16"}, "bf16_uint16")):
        bst, params, rec = train_phase(
            dev, fix, rows, f"train_max_bin_{WIDE_MAX_BIN}_{name}",
            dict(wide, **extra), ds_w, mode, None, iters=WIDE_ITERS[name])
        dbins = bst._gbdt.bins_dev
        require(tuple(dbins.shape) == (nt, f)
                and dbins.dtype == torch.uint16,
                f"device bins {tuple(dbins.shape)} {dbins.dtype}")
        launches[mode] = rec["histogram_launches"]
        runs[name] = (bst, params, rec)
    _b, _p, rec255 = train_phase(dev, fix, rows, "train_max_bin_255_f32",
                                 {}, ds, "f32", "f32",
                                 iters=WIDE_ITERS["f32"])
    emit({"phase": "auc_by_max_bin", "iterations": WIDE_ITERS["f32"],
          f"holdout_auc_max_bin_{WIDE_MAX_BIN}": runs["f32"][2][
              "holdout_auc"],
          "holdout_auc_max_bin_255": rec255["holdout_auc"],
          "s_per_iteration_max_bin_255": rec255["s_per_iteration"]})
    del _b

    # two runs repeat; the twin gives the kernel's model text
    reps = WIDE_ITERS["repeat"]
    texts = {}
    for name in ("f32", "quantized"):
        prm = runs[name][1]
        t0 = time.perf_counter()
        texts[name] = lgt.train(prm, ds_w, reps, device=dev).model_to_string()
        if name == "f32":
            again = lgt.train(prm, ds_w, reps, device=dev).model_to_string()
            require(again == texts[name], f"two {reps}-iteration max_bin "
                    f"{WIDE_MAX_BIN} runs gave different model text")
        kernel_s = time.perf_counter() - t0
        saved = HF.histogram_flat
        HF.histogram_flat = hist_twin
        try:
            t0 = time.perf_counter()
            twin = lgt.train(prm, ds_w, reps, device=dev).model_to_string()
            twin_s = time.perf_counter() - t0
        finally:
            HF.histogram_flat = saved
        require(twin == texts[name], f"max_bin {WIDE_MAX_BIN} {name}: the "
                "twin's model text != the kernel's")
        emit({"phase": "determinism", "training": f"max_bin_{WIDE_MAX_BIN}_"
              f"{name}", "iterations": reps, "repeat_equal": name == "f32",
              "twin_equal": True, "model_bytes": len(texts[name]),
              "kernel_seconds": kernel_s, "twin_seconds": twin_s})

    # serving the f32 model through the int16 pack
    bst = runs["f32"][0]
    rng = np.random.RandomState(7)
    Xv = rows[0][nt:]
    rows_s = Xv[rng.randint(0, Xv.shape[0], 4096)].astype(np.float64)
    pred = bst.serving_predictor(quantize="int16", raw_score=True)
    pack = pred.plan._packs[0]
    traverse.launches = 0
    served = pred.predict(rows_s)
    torch.cuda.synchronize()
    require(traverse.launches == 1, f"{traverse.launches} traversal "
            "launches for 1 request")
    acc, _ = walk_pack_numpy(pack, binned.apply(rows_s), binned.nan_bins)
    want = (acc.astype(np.int32).astype(np.float32)
            * np.float32(pack["scale"])).astype(np.float64) + \
        bst._gbdt.init_scores[0]
    require(np.array_equal(served, want), "served max_bin "
            f"{WIDE_MAX_BIN} raw scores != the numpy walk")
    emit({"phase": "serve_max_bin_1023", "rows": rows_s.shape[0],
          "launches": 1, "raw_bitwise": True,
          "split_bin_max": int(pack["split_bin"].max())})
    return launches, ds_w, {k: v[2] for k, v in runs.items()}


def uint16_timing(gen, dev, smi):
    """28. The uint16 modes at B = 1,023 and N = 200,000 and 10,500,000:
    kernel (CUDA events), ``index_add_`` (f32; over the bf16-rounded
    values for bf16; int32 for int8) and the bounds (2 bin bytes a
    feature); at 200,000 rows also the plain version and the device ms
    of the kernel's launches by name (at 10.5M rows the profiler recorded
    none of them)."""
    import torch
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops.histogram import histogram_segment
    b, f = WIDE_MAX_BIN, 28
    timing = {}
    for mode in U16_MODES:
        val_bytes = {"bf16": 6, "int8": 3}.get(mode.split("_")[0], 12)
        for n in HIST_TIMING_ROWS:
            bins = device_bins(gen, n, f, b, dev)
            vals = mode_vals(gen, n, mode, dev, exact=False)
            small = n <= 200_000
            iters = 20 if small else 5
            fn = lambda: HF.histogram_flat(bins, vals, num_bins=b)
            entry = {"kernel_ms": cuda_time_ms(fn, iters=iters)}
            flat = (bins.long() + torch.arange(f, device=dev)[None, :]
                    * b).reshape(-1)
            int8 = vals.dtype == torch.int8
            src = (vals.int() if int8 else vals.float())[:, None, :].expand(
                n, f, 3).reshape(-1, 3)
            acc = torch.zeros(f * b, 3, device=dev,
                              dtype=torch.int32 if int8 else torch.float32)
            entry["library_ms"] = cuda_time_ms(
                lambda: acc.index_add_(0, flat, src), iters=iters)
            del flat, src
            if small:
                entry["plain_ms"] = cuda_time_ms(
                    lambda: histogram_segment(bins, vals, num_bins=b),
                    iters=20)
                entry["stage_ms"] = kernel_stage_ms(fn, iters=iters)
            entry["bytes_ms"], entry["ops_ms"] = hist_bound_ms(
                n, f, b, val_bytes=val_bytes, bin_bytes=2 * f)
            timing[f"histogram_{mode}/{n}"] = entry
            del bins, vals
        torch.cuda.empty_cache()
    # slice 10: the int8 accumulation with every row of a feature in one bin
    n = HIST_TIMING_ROWS[0]
    bins = hot_bins(device_bins(gen, n, f, b, dev), "one_bin", b)
    vals = device_levels(gen, n, dev)
    fn = lambda: HF.histogram_flat(bins, vals, num_bins=b)
    timing[f"histogram_int8_uint16/{n}/one_bin"] = {
        "kernel_ms": cuda_time_ms(fn, iters=20),
        "stage_ms": kernel_stage_ms(fn)}
    del bins, vals
    emit({"phase": "training_timing_uint16", "nvidia_smi": smi, "bins": b,
          "shapes": timing})
    return timing


# ------------------------ slice 8: the fused wave over uint16 bins (B2e)
def uint16_wave_phase(gen, dev):
    """29. The wave kernel's uint16 modes (f32, bf16, int8) against their
    plain version ``wave_plain`` and the chunked twin
    ``wave_hists_chunked``: at every B of U16_WAVE_BINS, F = 28 and 27, W
    = 1 and W = 16 with inactive slots, and B = 65,536 at W = 1.  On
    exact sums (int8: power-of-two scales) child histograms and payloads
    bit for bit the plain version's; on random values (int8: random
    scales) child histograms bit for bit the twin's (int8: the plain
    version's) and payloads within ``wave_agreement``; run-to-run
    bitwise.  Waves whose bins push the kernels at B = 1,023, W = 16
    (``lane_pattern``: every row of a feature in one bin, runs of 32 rows
    and pairs on one bin, along the permutation) the same way, and an
    exact gain tie between features 1 and 25 (different scan blocks) at B
    = 257 and 1,023 that must select feature 1, bit for bit the plain
    version.  Then a wave with no valid split (all gains -inf: key 0's
    payload) at B = 2,047.  Returns each mode's largest child-histogram
    error against the plain version at B = 1,023, F = 28, W = 16, random
    values."""
    import torch
    from lightgbm_tpu_torch.ops import wave as WV
    from lightgbm_tpu_torch.ops.split import SplitConfig
    cfg = SplitConfig(min_data_in_leaf=0, min_sum_hessian_in_leaf=1.0,
                      lambda_l2=0.5, max_cat_to_onehot=4)
    rand = torch.rand(2, generator=gen, device=dev) * 0.02 + 1e-3
    random_scales = (float(rand[0]), float(rand[1]), 1.0)
    out, err = {}, {}

    def check(mode, b, f, name, sizes, inactive, exact, scan_cfg=cfg,
              edit=None):
        kind = mode.split("_")[0]
        int8 = kind == "int8"
        scales = (POW2_SCALES if exact else random_scales) if int8 else None
        inp = wave_case(gen, dev, sizes, exact or int8, f=f, b=b,
                        inactive=inactive, scales=scales, mode=kind,
                        edit=edit)
        require(inp["bins"].dtype == torch.uint16, "uint16 wave case "
                f"holds {inp['bins'].dtype} bins")
        h1, p1 = WV.fused_wave_call(cfg=scan_cfg, **inp)
        h2, p2 = WV.fused_wave_call(cfg=scan_cfg, **inp)
        hp, pp = WV.wave_plain(cfg=scan_cfg, **inp)
        torch.cuda.synchronize()
        tag = f"{mode} B={b} F={f} {name} {'exact' if exact else 'random'}"
        require(torch.equal(h1, h2) and torch.equal(p1, p2),
                f"wave {tag}: not run-to-run bitwise")
        for j in inactive:
            require(bool(torch.isinf(p1[j, :, 0]).all()),
                    f"wave {tag}: inactive slot {j} has a finite gain")
        if exact:
            require(torch.equal(h1, hp) and torch.equal(p1, pp),
                    f"wave {tag} != plain version")
        if int8:
            require(torch.equal(h1, hp), f"wave {tag}: histograms != plain "
                    "version")
            h1 = WV.scale_hist(h1, inp["scale3"])
            hp = WV.scale_hist(hp, inp["scale3"])
        elif not exact:
            want = WV.wave_hists_chunked(
                inp["bins"], inp["vals"], inp["perm"], inp["small_start"],
                inp["small_cnt"], inp["parent"], inp["stats"], b)
            torch.cuda.synchronize()
            require(torch.equal(h1, want), f"wave {tag}: child histograms "
                    "!= their chunk-ordered twin (off by "
                    f"{float((h1 - want).abs().max())})")
        out[tag] = {"slots": len(sizes), "rows": sum(sizes),
                    "payload_equal": bool(torch.equal(p1, pp)),
                    **wave_agreement(h1, p1, hp, pp, inp)}
        return float((h1 - hp).abs().max()), p1

    for mode in U16_MODES:
        for b in U16_WAVE_BINS:
            for f in (28, 27):
                for name, (sizes, inactive) in CHECK_WAVES.items():
                    for exact in (True, False):
                        e, _ = check(mode, b, f, name, sizes, inactive,
                                     exact)
                        if (b, f, name, exact) == (WIDE_MAX_BIN, 28, "W16",
                                                   False):
                            err[mode] = e
        sizes, b = U16_WAVE_LARGE
        for exact in (True, False):
            check(mode, b, 28, "W1", sizes, (), exact)
        sizes, inactive = CHECK_WAVES["W16"]
        for pattern in U16_LANE_PATTERNS:
            for exact in (True, False):
                check(mode, WIDE_MAX_BIN, 28, f"W16 {pattern}", sizes,
                      inactive, exact, edit=lane_pattern(pattern,
                                                         WIDE_MAX_BIN))
        pair, tie_bins = U16_TIE
        for b in tie_bins:
            _e, p = check(mode, b, 28, f"W16 tie {pair}", sizes, inactive,
                          True, edit=lane_pattern("tie", b, pair))
            fin = torch.isfinite(p[..., 0])
            require(bool(fin.any()) and bool((p[..., 1][fin] ==
                                              pair[0]).all()),
                    f"{mode} B={b}: an exact gain tie between features "
                    f"{pair} did not select feature {pair[0]}")
    none = SplitConfig(min_data_in_leaf=10 ** 9, min_sum_hessian_in_leaf=1.0,
                       lambda_l2=0.5, max_cat_to_onehot=4)
    sizes, inactive = CHECK_WAVES["W16"]
    for mode in ("f32_uint16", "int8_uint16"):
        _e, p = check(mode, 2047, 28, "W16 no valid split", sizes, inactive,
                      True, scan_cfg=none)
        require(bool(torch.isinf(p[:, :, 0]).all()), "a uint16 child split "
                "under min_data_in_leaf = 1e9")
        require(not bool(p[:, :, 1:3].any()), "all -inf uint16 children did "
                "not select key 0")
    out.update(int8_wave_checks(gen, dev, "int8_uint16", WIDE_MAX_BIN, cfg))
    emit({"phase": "wave_uint16_vs_plain_and_twin", "cases": out})
    return err


def wide_fused_training(dev, fix, rows, ds_w, rec255, unfused):
    """30. Fused training at max_bin 1023 on phase 27's binned rows,
    FUSED_ITERS iterations: f32 and quantized under ``auto``, bf16 with
    ``tpu_histogram_impl=flat_bf16, tpu_wave_kernel=fused`` (``auto``
    keeps flat_bf16 unfused, as the JAX package does).  Each launches only
    its ``<mode>_uint16`` wave and one uint16 histogram a tree (the
    root).  s/iteration and holdout AUC stand beside phase 27's unfused
    runs (``unfused``: their records) and the 255-bin f32 run's
    (``rec255``, phase 10); two FUSED_CHECK_ITERS-iteration runs give
    equal model text (f32, quantized), and the f32 one's holdout AUC is
    within FUSED_AUC_TOL of the unfused f32 run's at the same iterations.
    Then phase 13's ``torch.profiler`` split of the fused f32 run.
    Returns each mode's (histogram, wave) launches."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.metrics import auc
    nt = fix["data"]["n_train"]
    Xv, yv = rows[0][nt:], rows[1][nt:]
    launches, runs = {}, {}
    for name, extra, mode in (
            ("f32", {}, "f32_uint16"),
            ("quantized", {"use_quantized_grad": True}, "int8_uint16"),
            ("bf16", {"tpu_histogram_impl": "flat_bf16",
                      "tpu_wave_kernel": "fused"}, "bf16_uint16")):
        bst, params, rec = train_phase(
            dev, fix, rows, f"train_max_bin_{WIDE_MAX_BIN}_fused_{name}",
            dict(extra, max_bin=WIDE_MAX_BIN), ds_w, mode, mode,
            iters=FUSED_ITERS)
        del bst
        require(rec["histogram_launches"] == FUSED_ITERS,
                f"fused {name}: {rec['histogram_launches']} histogram "
                f"launches in {FUSED_ITERS} iterations (one root a tree)")
        launches[mode] = (rec["histogram_launches"], rec["wave_launches"])
        runs[name] = (params, rec)
    checks = {}
    for name in ("f32", "quantized"):
        prm = runs[name][0]
        t0 = time.perf_counter()
        b1 = lgt.train(prm, ds_w, FUSED_CHECK_ITERS, device=dev)
        text = b1.model_to_string()
        again = lgt.train(prm, ds_w, FUSED_CHECK_ITERS,
                          device=dev).model_to_string()
        require(again == text, f"two {FUSED_CHECK_ITERS}-iteration fused "
                f"max_bin {WIDE_MAX_BIN} {name} runs gave different model "
                "text")
        checks[name] = {"repeat_equal": True, "model_bytes": len(text),
                        "seconds": time.perf_counter() - t0,
                        "holdout_auc": auc(yv, b1.predict(Xv,
                                                          raw_score=True))}
    gap = checks["f32"]["holdout_auc"] - unfused["f32"]["holdout_auc"]
    require(unfused["f32"]["iterations"] == FUSED_CHECK_ITERS
            and abs(gap) <= FUSED_AUC_TOL,
            f"fused f32 holdout AUC {checks['f32']['holdout_auc']} not "
            f"within {FUSED_AUC_TOL} of the unfused run's "
            f"{unfused['f32']['holdout_auc']}")
    emit({"phase": "fused_max_bin_1023", "iterations": FUSED_ITERS,
          "s_per_iteration": {k: v[1]["s_per_iteration"]
                              for k, v in runs.items()},
          "s_per_iteration_unfused": {
              k: {"iterations": v["iterations"],
                  "s": v["s_per_iteration"]} for k, v in unfused.items()},
          "s_per_iteration_max_bin_255_f32": rec255["s_per_iteration"],
          "holdout_auc": {k: v[1]["holdout_auc"] for k, v in runs.items()},
          "holdout_auc_max_bin_255_f32": rec255["holdout_auc"],
          "iterations_max_bin_255": rec255["iterations"],
          "check_iterations": FUSED_CHECK_ITERS, "checks": checks,
          "holdout_auc_unfused_f32": unfused["f32"]["holdout_auc"],
          "fused_minus_unfused_auc_f32": gap, "auc_tolerance": FUSED_AUC_TOL,
          "launches": launches})
    emit({**profile_phase(runs["f32"][0], ds_w, dev),
          "training": f"max_bin_{WIDE_MAX_BIN}_fused_f32"})
    return launches


def uint16_wave_timing(gen, dev, smi, launches):
    """31. The uint16 wave modes at W = 16 x 12,500, F = 28
    (U16_WAVE_TIMING: B = 1,023 in each mode, f32 at 511, int8 at 2,047,
    and f32 at B = 1,023 over W = 4 and 1 siblings of 12,500 rows):
    kernel ms (CUDA events), the device ms of its launches by name
    (``wave_stage_ms``), the plain version, the bound (``wave_bound_ms``)
    and, at B = 1,023, the launches per iteration of phase 30's run.  No
    single PyTorch call computes a wave."""
    import torch
    from lightgbm_tpu_torch.ops import wave as WV
    from lightgbm_tpu_torch.ops.split import SplitConfig
    cfg = SplitConfig(min_data_in_leaf=0, min_sum_hessian_in_leaf=100.0,
                      max_cat_to_onehot=4)
    timing = {}
    for mode, b, w in U16_WAVE_TIMING:
        sizes = [WAVE_TIMING_SIZES[0]] * w
        kind = mode.split("_")[0]
        scales = None
        if kind == "int8":
            rand = torch.rand(2, generator=gen, device=dev) * 0.02 + 1e-3
            scales = (float(rand[0]), float(rand[1]), 1.0)
        inp = wave_case(gen, dev, sizes, exact=scales is not None, b=b,
                        scales=scales, mode=kind)
        fn = lambda: WV.fused_wave_call(cfg=cfg, **inp)
        entry = {"bins": b,
                 "kernel_ms": cuda_time_ms(fn, iters=20),
                 "plain_ms": cuda_time_ms(
                     lambda: WV.wave_plain(cfg=cfg, **inp), iters=3,
                     warmup=1),
                 "library_ms": None}
        h1, p1 = fn()
        hp, pp = WV.wave_plain(cfg=cfg, **inp)
        if scales is not None:
            require(torch.equal(h1, hp), f"{mode} timing wave histograms "
                    "!= plain")
            h1 = WV.scale_hist(h1, inp["scale3"])
            hp = WV.scale_hist(hp, inp["scale3"])
        entry["max_abs_err"] = float((h1 - hp).abs().max())
        entry["agreement"] = wave_agreement(h1, p1, hp, pp, inp)
        entry["bytes_ms"], entry["ops_ms"] = wave_bound_ms(inp)
        entry["stage_ms"] = wave_stage_ms(fn)
        if b == WIDE_MAX_BIN and w == len(WAVE_TIMING_SIZES):
            entry["launches_per_iteration"] = launches[mode][1] / FUSED_ITERS
        timing[f"wave_{mode}/B={b}/{len(sizes)}x{sizes[0]}"] = entry
        del inp, h1, p1, hp, pp
        torch.cuda.empty_cache()
    emit({"phase": "training_timing_uint16_wave", "nvidia_smi": smi,
          "shapes": timing})
    return timing


# --------------------------------------------- objectives (slice 11)
OBJ_FIXTURE = os.path.join("tests", "fixtures", "torch_objectives_ref.json")
#: holdout-metric bars against the JAX package's fixture: relative, but
#: multi_error absolute
OBJ_BARS = {"l2": 5e-3, "l2_quantized": 1e-2, "l1": 5e-3,
            "multiclass": 5e-3, "other": 1e-2, "multi_error": 5e-3}
OBJ_REPEAT_ITERS = {"l2": 10, "multiclass": 5}
#: iterations of the long fixture runs (100 in the fixture), cut to keep
#: the smoke within its time limit: held to the fixture's recorded holdout
#: metrics at that iteration
OBJ_ITERS = {"l2": 50, "l2_quantized": 50, "multiclass": 25}
#: iterations of phase 37's repeat runs (each trains the objective twice)
OTHER_REPEAT_ITERS = 5
OBJ_SERVE_ROWS = 65_536
ES_ROUNDS, ES_PATIENCE, ES_LEARNING_RATE = 300, 5, 0.5
#: phase 37's runs, in the fixture's names
OTHER_OBJECTIVES = ("huber", "fair", "poisson", "quantile", "mape", "gamma",
                    "tweedie", "multiclassova", "cross_entropy",
                    "cross_entropy_lambda")


def objective_data(n, f, seed=0):
    """tools/gen_torch_objectives_fixture.py::objective_data (keep the two
    in step): make_higgs_like(n, f, seed)'s X, and labels from its logit
    ``t`` and uniform draw ``u`` by family."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f) / np.sqrt(f)
    t = X @ w + 0.5 * np.sin(X[:, 0] * 2) * X[:, 1]
    u = rng.rand(n)
    uc = np.clip(u, 1e-12, 1 - 1e-12)
    e = -np.log1p(-uc)
    scale = np.exp(t)
    labels = {
        "regression": t + u - 0.5,
        "multiclass": np.digitize(t - np.log(uc / (1 - uc)),
                                  [-1.0, 0.0, 1.0]).astype(np.float64),
        "gamma": scale * e,
        "count": np.floor(scale * e),
        "probability": 1.0 / (1.0 + np.exp(-t)),
    }
    return X, labels


def _launch_modes(launches):
    return {kernel: {m: v for m, v in counts.items() if v}
            for kernel, counts in launches.items()}


def objective_run(dev, ds, dv, ref_run, name, iters=None, extra=None,
                  hist_mode="f32", wave_mode="f32"):
    """One training run of the fixture's ``ref_run`` params (plus
    ``extra``) on the bench rows binned once (``ds``, with the run's
    labels set) with ``dv`` (the holdout, binned with the training
    mappers) as its valid set, through ``train``.  The launch counts are
    zeroed just before and read just after: the histogram kernel must
    have run in ``hist_mode`` only and the wave kernel in ``wave_mode``
    only.  Host seconds in the objective's leaf renewal are summed.
    Returns (booster, eval history, record)."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.models import gbdt as GB
    params = dict(ref_run["params"], **(extra or {}))
    iters = ref_run["iterations"] if iters is None else iters
    renew = [0.0, 0]
    orig = GB.GBDT._renew_and_shrink

    def timed(self, *args):
        t0 = time.perf_counter()
        out = orig(self, *args)
        renew[0] += time.perf_counter() - t0
        renew[1] += 1
        return out

    hist = {}
    GB.GBDT._renew_and_shrink = timed
    try:
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lgt.train(params, ds, iters, valid_sets=[dv],
                        valid_names=["holdout"], device=dev,
                        callbacks=[lgt.record_evaluation(hist)])
        torch.cuda.synchronize()
        boost_s = time.perf_counter() - t0
        launches = _read_launches()
    finally:
        GB.GBDT._renew_and_shrink = orig
    ran = _launch_modes(launches)
    require(set(ran["histogram"]) == {hist_mode}
            and set(ran["wave"]) == {wave_mode},
            f"{name}: kernels launched {ran}, expected histogram "
            f"{hist_mode} and wave {wave_mode} only")
    done = bst.current_iteration
    k = bst.num_model_per_iteration()
    require(bst.num_trees() == done * k, f"{name}: {bst.num_trees()} trees "
            f"in {done} iterations of {k}")
    require(launches["histogram"][hist_mode] == done * k,
            f"{name}: {launches['histogram'][hist_mode]} histogram "
            f"launches for {done * k} trees (one root a tree)")
    rec = {"phase": f"objective_{name}", "objective": params["objective"],
           "iterations": done, "trees_per_iteration": k,
           "boosting_s": boost_s, "s_per_iteration": boost_s / done,
           "histogram_mode": hist_mode, "wave_mode": wave_mode,
           "histogram_launches": launches["histogram"][hist_mode],
           "wave_launches": launches["wave"][wave_mode],
           "histogram_launches_per_iteration":
               launches["histogram"][hist_mode] / done,
           "wave_launches_per_iteration":
               launches["wave"][wave_mode] / done,
           "leaves_per_tree": float(np.mean(
               [t.num_leaves for m in bst._gbdt.models for t in m])),
           "holdout": {m: v[-1] for m, v in hist["holdout"].items()}}
    if renew[1]:
        rec["renew_s_per_iteration"] = renew[0] / done
        rec["renew_calls"] = renew[1]
    return bst, hist["holdout"], rec


def poisson_constant(label):
    """The label-only term the ``poisson`` metric leaves out of the
    negative log-likelihood: mean(log(y!))."""
    import math
    return float(np.mean([math.lgamma(v + 1.0) for v in label]))


def check_against_fixture(rec, ref_run, bar, label=None):
    """The run's last recorded holdout metrics against the fixture's at
    the same iteration (its ``history``): relative ``bar`` (multi_error: absolute OBJ_BARS["multi_error"]).
    ``poisson`` is relative to the whole negative log-likelihood: the
    metric drops the label-only mean(log(y!)) (``label``: the holdout
    labels), which leaves a near-zero value (-0.011 here) that no relative
    bar can hold."""
    gaps = {}
    for m in ref_run["holdout"]:
        got = rec["holdout"][m]
        want = ref_run["history"][m][rec["iterations"] - 1]
        require(np.isfinite(got), f"{rec['phase']}: {m} = {got}")
        entry = {"port": got, "jax_fixture": want}
        if m == "multi_error":
            gap, tol = abs(got - want), OBJ_BARS["multi_error"]
        elif m == "poisson":
            const = poisson_constant(label)
            gap, tol = abs(got - want) / abs(want + const), bar
            entry.update(nll_constant=const,
                         gap_of_metric=abs(got - want) / abs(want))
        else:
            gap, tol = abs(got - want) / abs(want), bar
        require(gap <= tol, f"{rec['phase']}: holdout {m} {got} not within "
                f"{tol} of the JAX fixture's {want}")
        gaps[m] = dict(entry, gap=gap, tolerance=tol)
    rec["vs_fixture"] = gaps


def repeat_check(dev, ds, params, iters, what):
    """Two ``iters``-iteration runs give equal model text."""
    import lightgbm_tpu_torch as lgt
    t0 = time.perf_counter()
    m1 = lgt.train(params, ds, iters, device=dev).model_to_string()
    m2 = lgt.train(params, ds, iters, device=dev).model_to_string()
    require(m1 == m2, f"two {iters}-iteration {what} runs gave different "
            "model text")
    return {"iterations": iters, "equal": True, "model_bytes": len(m1),
            "seconds": time.perf_counter() - t0}


def serve_multiclass(bst, Xv, binned, seed):
    """The trained K-class model served through ``serving_predictor``
    (int16 packs, the traversal kernel) on OBJ_SERVE_ROWS holdout rows:
    the (N, K) raw scores equal a numpy walk of each class's pack bit for
    bit, with one traversal launch per class pack a request; the
    transformed request is the float32 softmax of the served raw scores
    within 1e-6; the fp32 pack's probabilities equal ``Booster.predict``
    bit for bit, and the int16 ones stand beside them."""
    import torch
    from lightgbm_tpu_torch.ops import traverse
    rng = np.random.RandomState(seed)
    rows_s = Xv[rng.randint(0, Xv.shape[0], OBJ_SERVE_ROWS)].astype(
        np.float64)
    g = bst._gbdt
    k = g.num_class
    pred = bst.serving_predictor(quantize="int16", raw_score=True)
    pred_p = bst.serving_predictor(quantize="int16")
    traverse.launches = 0
    t0 = time.perf_counter()
    served = pred.predict(rows_s)
    raw_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    raw_launches = traverse.launches
    traverse.launches = 0
    prob = pred_p.predict(rows_s)
    torch.cuda.synchronize()
    prob_launches = traverse.launches
    require(raw_launches == prob_launches == k,
            f"{raw_launches} / {prob_launches} traversal launches for one "
            f"request of a {k}-class model (one per class pack)")
    bins = binned.apply(rows_s)
    want = np.zeros((rows_s.shape[0], k))
    for c, pack in enumerate(pred.plan._packs):
        acc, _ = walk_pack_numpy(pack, bins, binned.nan_bins)
        want[:, c] = (acc.astype(np.int32).astype(np.float32)
                      * np.float32(pack["scale"])).astype(np.float64) \
            + g.init_scores[c]
    require(served.shape == want.shape and np.array_equal(served, want),
            "served multiclass raw scores != the numpy walk")
    raw32 = served.astype(np.float32).astype(np.float64)
    e = np.exp(raw32 - raw32.max(axis=1, keepdims=True))
    want_p = e / e.sum(axis=1, keepdims=True)
    err_p = float(np.abs(prob - want_p).max())
    require(err_p <= 1e-6, f"served multiclass probabilities off by {err_p}")
    exact = bst.predict(rows_s)
    fp32 = bst.serving_predictor(quantize="off").predict(rows_s)
    require(np.array_equal(fp32, exact), "fp32-pack probabilities != "
            "Booster.predict")
    return {"phase": "serve_multiclass", "rows": OBJ_SERVE_ROWS,
            "classes": k, "trees": bst.num_trees(),
            "launches_per_request": raw_launches, "raw_bitwise": True,
            "raw_request_ms": raw_ms, "prob_max_abs_err": err_p,
            "int16_vs_predict_prob_max_abs_diff": float(
                np.abs(prob - exact).max()),
            "fp32_pack_equals_predict": True}


def objective_phases(dev, fix, rows, ds, binning_s, seed):
    """32-37: the regression and multiclass objectives with a valid set,
    metrics and early stopping, at full bench width, against the JAX
    package's fixture.  The bench rows are binned once (phase 10's
    ``ds``; each run sets its labels) and the holdout once with the
    training mappers.  Returns the launches of each kernel mode on these
    paths."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.metrics import create_metric
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, OBJ_FIXTURE)) as fh:
        ref = json.load(fh)
    d = ref["data"]
    nt = d["n_train"]
    X, labels = objective_data(nt + d["n_valid"], d["n_features"], d["seed"])
    require(np.array_equal(X, rows[0]), "objective rows != the bench rows")
    del X
    Xv = rows[0][nt:]
    runs = ref["runs"]
    t0 = time.perf_counter()
    dv = lgt.Dataset(Xv, label=labels["regression"][nt:], reference=ds)
    dv.construct()
    valid_binning_s = time.perf_counter() - t0

    def use(family):
        y = labels[family]
        ds.set_label(y[:nt])
        dv.set_label(y[nt:])
        return y[nt:]

    totals = {"histogram": {}, "wave": {}}

    def count(rec):
        for kernel, mode in (("histogram", rec["histogram_mode"]),
                             ("wave", rec["wave_mode"])):
            totals[kernel][mode] = (totals[kernel].get(mode, 0)
                                    + rec[f"{kernel}_launches"])

    # 32. L2, f32, with the holdout as a valid set
    yv = use("regression")
    bst, hist, rec = objective_run(dev, ds, dv, runs["l2"], "l2",
                                   iters=OBJ_ITERS["l2"])
    check_against_fixture(rec, runs["l2"], OBJ_BARS["l2"])
    raw = bst.predict(Xv, raw_score=True)
    (l2,) = create_metric("l2", bst.cfg)
    host_l2 = l2(yv, raw)
    require(abs(host_l2 - hist["l2"][-1]) <= 1e-6, f"recorded valid l2 "
            f"{hist['l2'][-1]} != host recompute {host_l2}")
    rec.update(binning_s=binning_s, valid_binning_s=valid_binning_s,
               host_recompute_l2=host_l2,
               repeat=repeat_check(dev, ds, runs["l2"]["params"],
                                   OBJ_REPEAT_ITERS["l2"], "L2"))
    emit(rec)
    count(rec)
    del bst

    # 33. L2, quantized
    _b, _h, rec = objective_run(dev, ds, dv, runs["l2_quantized"],
                                "l2_quantized",
                                iters=OBJ_ITERS["l2_quantized"],
                                hist_mode="int8", wave_mode="int8")
    check_against_fixture(rec, runs["l2_quantized"],
                          OBJ_BARS["l2_quantized"])
    emit(rec)
    count(rec)
    del _b

    # 34. regression_l1: the percentile leaf renewal
    _b, _h, rec = objective_run(dev, ds, dv, runs["l1"], "l1")
    check_against_fixture(rec, runs["l1"], OBJ_BARS["l1"])
    require(rec.get("renew_calls") == rec["iterations"],
            "l1: the leaf renewal did not run once a tree")
    emit(rec)
    count(rec)
    del _b
    emit({**profile_phase(runs["l1"]["params"], ds, dev),
          "training": "regression_l1"})

    # 35. 4-class multiclass: K trees an iteration; served through the
    # traversal kernel
    use("multiclass")
    bst, _h, rec = objective_run(dev, ds, dv, runs["multiclass"],
                                 "multiclass", iters=OBJ_ITERS["multiclass"])
    check_against_fixture(rec, runs["multiclass"], OBJ_BARS["multiclass"])
    rec["repeat"] = repeat_check(dev, ds, runs["multiclass"]["params"],
                                 OBJ_REPEAT_ITERS["multiclass"],
                                 "multiclass")
    emit(rec)
    count(rec)
    serve = serve_multiclass(bst, Xv, ds.construct().binned, seed)
    emit(serve)
    del bst
    emit({**profile_phase(runs["multiclass"]["params"], ds, dev),
          "training": "multiclass"})

    # 36. early stopping: L2 at a high learning rate, patience in params
    use("regression")
    es = {"learning_rate": ES_LEARNING_RATE,
          "early_stopping_round": ES_PATIENCE}
    bst, hist, rec = objective_run(dev, ds, dv, runs["l2"], "early_stop",
                                   iters=ES_ROUNDS, extra=es)
    best = bst.best_iteration
    require(rec["iterations"] < ES_ROUNDS, "early stopping never stopped")
    require(best == 1 + int(np.argmin(hist["l2"])), f"best_iteration {best}"
            f" != 1 + argmin of the recorded l2")
    require(rec["iterations"] == best + ES_PATIENCE, f"stopped at "
            f"{rec['iterations']}, best {best}, patience {ES_PATIENCE}")
    p1 = bst.predict(Xv)
    require(np.array_equal(p1, bst.predict(Xv, num_iteration=best)),
            "predict != predict(num_iteration=best_iteration)")
    rec.update(best_iteration=best, best_l2=min(hist["l2"]),
               max_rounds=ES_ROUNDS, patience=ES_PATIENCE)
    emit(rec)
    count(rec)
    del bst

    # 37. every other non-ranking objective, 10 iterations
    others = {}
    for name in OTHER_OBJECTIVES:
        run = runs[name]
        yv = use(run["label"])
        _b, _h, rec = objective_run(dev, ds, dv, run, name)
        check_against_fixture(rec, run, OBJ_BARS["other"], yv)
        rec["repeat"] = repeat_check(dev, ds, run["params"],
                                     OTHER_REPEAT_ITERS, name)
        emit(rec)
        count(rec)
        others[name] = rec["vs_fixture"]
        del _b
    emit({"phase": "objectives_summary", "fixture": OBJ_FIXTURE,
          "fixture_jax_commit": ref["jax_commit"],
          "fixture_cpu": ref["cpu"], "others": others,
          "launches": totals, "traverse_launches": serve[
              "launches_per_request"] * 2})
    ds.set_label(rows[1][:nt])
    return totals, serve


# ------------------------------------------ slice 12: files, model text
FILE_ITERS = 10
CONTINUE_BASE_ITERS = 50
CONTINUE_ITERS = 50
CONTINUE_AUC_TOL = 1e-3
#: a loaded model's raw scores (float64 walk) against a trained booster's
#: (its fp32 pack summed in float32): 1e-6 plus the fp32 sum's own
#: rounding bound, ``fp32_sum_bound``
LOAD_RAW_TOL = 1e-6
BY_FEATURE_CYCLE = (15, 63, 255, 1023)
BY_FEATURE_ITERS = 10
#: forced bounds on two features (feature 0's budget is 15, 5's is 63)
FORCED_BINS = [{"feature": 0, "bin_upper_bound": [-1.0, -0.25, 1.0]},
               {"feature": 5, "bin_upper_bound": [-0.5, 0.5]}]
REF_MODEL = os.path.join("tests", "fixtures", "ref_model.txt")
REF_ROWS = os.path.join("tests", "fixtures", "ref_rows.tsv")
REF_PREDS = os.path.join("tests", "fixtures", "ref_preds_50.txt")


def tree_blocks(text):
    """The ``Tree=`` blocks of model text, in order."""
    body = text.split("end of trees")[0]
    return ["Tree=" + b for b in body.split("Tree=")[1:]]


def drop_unloaded_lines(block):
    """A tree block without the lines a loaded tree does not keep
    (``leaf_weight``, ``leaf_count``: the JAX package's loader and the
    port's drop them), so it compares with the block written back."""
    return "\n".join(ln for ln in block.split("\n")
                     if not ln.startswith(("leaf_weight=", "leaf_count=")))


def fp32_sum_bound(trees, raw):
    """The rounding bound of summing ``trees`` leaf values in float32 to
    scores of at most ``max|raw|``: half an ulp an add."""
    return trees * 2.0 ** -24 * float(np.abs(raw).max())


def timed(name):
    """Seconds the port's ``utils/timer`` spans of ``name`` took."""
    from lightgbm_tpu_torch.utils.timer import global_timer
    return global_timer.durations.get(name, 0.0)


def file_input_phase(dev, fix, rows, ds, text100, tmp):
    """38. The bench training rows written as TSV (label in column 0,
    ``%.17g``: the text round trip is exact), read by ``Dataset(path)``
    at the bench params: mappers and bins byte for byte phase 10's array
    dataset's; 10 iterations through the fused wave give the first 10
    ``Tree=`` blocks of phase 10's model byte for byte.  Returns the
    dataset's launches of each kernel mode."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.binning import mappers_to_arrays
    from lightgbm_tpu_torch.utils.timer import global_timer
    X, y = rows
    nt = fix["data"]["n_train"]
    path = os.path.join(tmp, "bench_train.tsv")
    t0 = time.perf_counter()
    np.savetxt(path, np.column_stack([y[:nt], X[:nt]]), delimiter="\t",
               fmt="%.17g")
    write_s = time.perf_counter() - t0
    params = dict(fix["params"])
    params.pop("num_iterations")
    global_timer.reset()
    dsf = lgt.Dataset(path)
    tdf = dsf.construct(params)
    parse_s, bin_s = timed("io/parse"), timed("dataset/bin")
    want = ds.construct()
    a, b = (mappers_to_arrays(tdf.binned.mappers),
            mappers_to_arrays(want.binned.mappers))
    same = all(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
               for k in b)
    require(same and a.keys() == b.keys(), "file input: mappers != the "
            "array dataset's")
    require(tdf.binned.bins.dtype == want.binned.bins.dtype
            and np.array_equal(tdf.binned.bins, want.binned.bins),
            "file input: bins != the array dataset's")
    require(np.array_equal(dsf.get_label(), y[:nt]), "file input: labels")
    bst, _p, rec = train_phase(dev, fix, rows, "train_file_input", {}, dsf,
                               "f32", "f32", iters=FILE_ITERS)
    got = tree_blocks(bst.model_to_string())
    require(got == tree_blocks(text100)[:FILE_ITERS],
            f"file input: the {FILE_ITERS} trees != phase 10's first "
            f"{FILE_ITERS}")
    emit({"phase": "file_input", "rows": nt, "features": X.shape[1],
          "file_bytes": os.path.getsize(path), "write_s": write_s,
          "parse_s": parse_s, "binning_s": bin_s,
          "mappers_bitwise": True, "bins_bitwise": True,
          "iterations": FILE_ITERS, "trees_equal_phase_10": True,
          "s_per_iteration": rec["s_per_iteration"]})
    os.remove(path)
    return {"histogram": rec["histogram_launches"],
            "wave": rec["wave_launches"]}


def genuine_model_phase(dev, root):
    """39. Genuine LightGBM's model text (``tests/fixtures/ref_model.txt``)
    loaded on the card: its predictions on ``ref_rows.tsv`` within 1e-6
    of the genuine binary's own, and the re-serialized text loads to the
    same raw scores bit for bit."""
    import torch
    import lightgbm_tpu_torch as lgt
    t0 = time.perf_counter()
    ref = lgt.Booster(model_file=os.path.join(root, REF_MODEL), device=dev)
    load_s = time.perf_counter() - t0
    data = np.loadtxt(os.path.join(root, REF_ROWS), delimiter="\t")
    Xr = data[:, 1:]
    want = np.loadtxt(os.path.join(root, REF_PREDS))
    prob = ref.predict(Xr)
    err = float(np.abs(prob - want).max())
    require(err <= 1e-6, f"genuine model: predictions off by {err}")
    raw = ref.predict(Xr, raw_score=True)
    again = lgt.Booster(model_str=ref.model_to_string(), device=dev)
    require(np.array_equal(again.predict(Xr, raw_score=True), raw),
            "genuine model: the re-serialized text predicts other bits")
    torch.cuda.synchronize()
    emit({"phase": "genuine_model", "trees": ref.num_trees(),
          "features": ref.num_feature(), "rows": Xr.shape[0],
          "max_abs_err_vs_genuine": err, "reload_bitwise": True,
          "load_s": load_s})


def round_trip_phase(dev, fix, rows, bst, rec, tmp):
    """40. Phase 10's 100 x 255-leaf model saved and loaded in the port:
    holdout raw scores within LOAD_RAW_TOL plus ``fp32_sum_bound`` of the
    trained booster's (the loaded walk compares float64 thresholds and
    sums in float64; the trained booster sums its fp32 pack in float32)
    and the same holdout AUC within 1e-6; load seconds and the
    50,000-row predict's milliseconds."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.metrics import auc
    X, y = rows
    nt = fix["data"]["n_train"]
    Xv, yv = X[nt:], y[nt:]
    path = os.path.join(tmp, "model_100.txt")
    bst.save_model(path)
    t0 = time.perf_counter()
    loaded = lgt.Booster(model_file=path, device=dev)
    load_s = time.perf_counter() - t0
    loaded.predict(Xv[:1000], raw_score=True)     # builds the tree stack
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = loaded.predict(Xv, raw_score=True)
    predict_ms = (time.perf_counter() - t0) * 1e3
    want = bst.predict(Xv, raw_score=True)
    err = float(np.abs(raw - want).max())
    bar = LOAD_RAW_TOL + fp32_sum_bound(bst.num_trees(), want)
    require(err <= bar, f"loaded model: holdout raw scores off by {err} "
            f"(bar {bar})")
    got_auc = auc(yv, raw)
    require(abs(got_auc - rec["holdout_auc"]) <= 1e-6, f"loaded model: "
            f"holdout AUC {got_auc} != the trained {rec['holdout_auc']}")
    emit({"phase": "model_round_trip", "trees": loaded.num_trees(),
          "leaves": 255, "model_bytes": os.path.getsize(path),
          "load_s": load_s, "predict_rows": len(yv),
          "predict_ms": predict_ms, "max_abs_err": err, "bar": bar,
          "within_1e-6": err <= LOAD_RAW_TOL, "holdout_auc": got_auc, "trained_holdout_auc": rec["holdout_auc"]})
    os.remove(path)


def continuation_phase(dev, fix, rows, ds, bst, rec, tmp):
    """41. Phase 10's model cut to 50 iterations (``model_to_string(
    num_iteration=50)``) continued 50 iterations with ``init_model=`` at
    the bench params on phase 10's binned rows (their bins kept): only
    the f32 histogram (one root a tree) and wave kernels launch; holdout
    AUC within 1e-3 of phase 10's and of genuine LightGBM's; the saved
    text's first 50 ``Tree=`` blocks are the base text's (but for the
    lines a loaded tree does not keep), and it reloads to the combined
    booster's raw scores within LOAD_RAW_TOL.  Returns the launches."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.metrics import auc
    from lightgbm_tpu_torch.utils.timer import global_timer
    X, y = rows
    nt = fix["data"]["n_train"]
    Xv, yv = X[nt:], y[nt:]
    base_text = bst.model_to_string(num_iteration=CONTINUE_BASE_ITERS)
    base_path = os.path.join(tmp, "base_50.txt")
    with open(base_path, "w") as fh:
        fh.write(base_text)
    params = dict(fix["params"])
    params.pop("num_iterations")
    params["tpu_leaf_batch"] = 16
    global_timer.reset()
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cont = lgt.train(params, ds, CONTINUE_ITERS, init_model=base_path,
                     device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _read_launches()
    fold_s = timed("train/fold_init_score")
    for kernel in ("histogram", "wave"):
        ran = {k for k, v in launches[kernel].items() if v}
        require(ran == {"f32"}, f"continuation: {kernel} kernel launched "
                f"{launches[kernel]}, expected f32 only")
    hist_n, wave_n = launches["histogram"]["f32"], launches["wave"]["f32"]
    require(hist_n == CONTINUE_ITERS, f"continuation: {hist_n} histogram "
            f"launches in {CONTINUE_ITERS} iterations (one root a tree)")
    total = CONTINUE_BASE_ITERS + CONTINUE_ITERS
    require(cont.num_trees() == total and cont.current_iteration == total,
            f"continuation: {cont.num_trees()} trees")
    require(ds.init_score is None, "continuation changed the caller's "
            "init score")
    raw = cont.predict(Xv, raw_score=True)
    require(np.isfinite(raw).all(), "continuation: raw scores not finite")
    got_auc = auc(yv, raw)
    for what, ref_auc in (("phase 10", rec["holdout_auc"]),
                          ("genuine LightGBM", fix["ref_auc"])):
        require(abs(got_auc - ref_auc) <= CONTINUE_AUC_TOL, f"continuation:"
                f" holdout AUC {got_auc} not within {CONTINUE_AUC_TOL} of "
                f"{what}'s {ref_auc}")
    text = cont.model_to_string()
    base_blocks = [drop_unloaded_lines(b) for b in tree_blocks(base_text)]
    require(tree_blocks(text)[:CONTINUE_BASE_ITERS] == base_blocks,
            "continuation: the saved base trees != the base text's")
    reloaded = lgt.Booster(model_str=text, device=dev)
    err = float(np.abs(reloaded.predict(Xv, raw_score=True) - raw).max())
    bar = LOAD_RAW_TOL + fp32_sum_bound(CONTINUE_ITERS, raw)
    require(err <= bar, f"continuation: the reloaded text's raw scores off "
            f"by {err} (bar {bar})")
    emit({"phase": "continued_training", "base_iterations":
          CONTINUE_BASE_ITERS, "iterations": CONTINUE_ITERS,
          "fold_s": fold_s, "boosting_s": total_s - fold_s,
          "s_per_iteration": (total_s - fold_s) / CONTINUE_ITERS,
          "histogram_launches": hist_n, "wave_launches": wave_n,
          "wave_launches_per_iteration": wave_n / CONTINUE_ITERS,
          "holdout_auc": got_auc, "phase_10_holdout_auc": rec["holdout_auc"],
          "ref_auc": fix["ref_auc"], "base_trees_equal": True,
          "reload_max_abs_err": err, "reload_bar": bar,
          "reload_within_1e-6": err <= LOAD_RAW_TOL})
    os.remove(base_path)
    return {"histogram": hist_n, "wave": wave_n}


def plain_wave(*args, scale3=None, packed4=False, max_level=127, **kw):
    """``fused_wave_call``'s plain version, call for call."""
    from lightgbm_tpu_torch.ops import wave as WV
    return WV.wave_plain(*args, scale3=scale3, packed4=packed4, **kw)


def by_feature_phase(dev, fix, rows, tmp):
    """42. ``max_bin_by_feature`` cycling 15, 63, 255 and 1,023 over the
    28 features with a forced-bins file on two of them: the bench rows
    binned (uint16 bins, each feature within its budget, the forced
    bounds in the mappers), 10 iterations through the fused wave's
    uint16 mode (holdout AUC recorded: no genuine number exists for this
    config); one exact-sum iteration (``boost_from_average=false``) on
    the kernels gives the model text of the same run on their plain
    versions.  Returns the kernels' launches in the 10 iterations."""
    import lightgbm_tpu_torch as lgt
    import lightgbm_tpu_torch.models.grower as G
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    X, y = rows
    nt, f = fix["data"]["n_train"], fix["data"]["n_features"]
    budgets = [BY_FEATURE_CYCLE[j % len(BY_FEATURE_CYCLE)] for j in range(f)]
    forced_path = os.path.join(tmp, "forced_bins.json")
    with open(forced_path, "w") as fh:
        json.dump(FORCED_BINS, fh)
    extra = {"max_bin_by_feature": budgets, "forcedbins_filename": forced_path}
    params = dict(fix["params"], **extra)
    params.pop("num_iterations")
    t0 = time.perf_counter()
    dsb = lgt.Dataset(X[:nt], label=y[:nt])
    binned = dsb.construct(params).binned
    binning_s = time.perf_counter() - t0
    nb = binned.num_bins_per_feature
    require(binned.bins.dtype == np.uint16, "by-feature bins not uint16")
    require(all(int(n) <= b for n, b in zip(nb, budgets)), f"by-feature: "
            f"bins {nb.tolist()} over budgets {budgets}")
    for spec in FORCED_BINS:
        ub = binned.mappers[spec["feature"]].upper_bounds.tolist()
        require(set(spec["bin_upper_bound"]) <= set(ub), f"forced bounds "
                f"{spec} not in feature {spec['feature']}'s mapper")
    _b, prm, rec = train_phase(dev, fix, rows, "train_max_bin_by_feature",
                               extra, dsb, "f32_uint16", "f32_uint16",
                               iters=BY_FEATURE_ITERS)
    del _b
    exact = dict(prm, boost_from_average=False)
    _zero_launches()
    kernel_text = lgt.train(exact, dsb, 1, device=dev).model_to_string()
    kernel_launches = _read_launches()
    saved = HF.histogram_flat, G.fused_wave_call
    HF.histogram_flat, G.fused_wave_call = hist_twin, plain_wave
    try:
        _zero_launches()
        plain_text = lgt.train(exact, dsb, 1, device=dev).model_to_string()
        plain_launches = _read_launches()
    finally:
        HF.histogram_flat, G.fused_wave_call = saved
    require(kernel_launches["wave"]["f32_uint16"] > 0, "by-feature exact "
            "iteration: no wave launch")
    require(not any(v for c in plain_launches.values() for v in c.values()),
            "by-feature: the plain run launched a kernel")
    require(kernel_text == plain_text, "by-feature: the kernels' model text "
            "!= the plain versions'")
    emit({"phase": "max_bin_by_feature", "budgets": budgets,
          "num_bins_per_feature": nb.tolist(), "forced_bins": FORCED_BINS,
          "binning_s": binning_s, "iterations": BY_FEATURE_ITERS,
          "holdout_auc": rec["holdout_auc"],
          "s_per_iteration": rec["s_per_iteration"],
          "exact_iteration_equals_plain": True,
          "exact_iteration_wave_launches":
              kernel_launches["wave"]["f32_uint16"]})
    os.remove(forced_path)
    return {"histogram": rec["histogram_launches"],
            "wave": rec["wave_launches"]}


def slice12_phases(dev, fix, rows, ds, bst, rec):
    """38-42: text-file input, genuine and round-tripped model text,
    continued training and per-feature bins, at the bench width; data
    files go to a temporary directory.  Returns the launches of each
    kernel mode on these paths."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    text100 = bst.model_to_string()
    with tempfile.TemporaryDirectory() as tmp:
        file_l = file_input_phase(dev, fix, rows, ds, text100, tmp)
        genuine_model_phase(dev, root)
        round_trip_phase(dev, fix, rows, bst, rec, tmp)
        cont_l = continuation_phase(dev, fix, rows, ds, bst, rec, tmp)
        wide_l = by_feature_phase(dev, fix, rows, tmp)
    return {"f32": {k: file_l[k] + cont_l[k] for k in file_l},
            "f32_uint16": wide_l}


# ------------------------------------------------------------ slice 13
SAMPLING_FIXTURE = os.path.join("tests", "fixtures",
                                "torch_sampling_ref.json")
#: (fixture run, extra params, kernel mode, holdout AUC bar): the bar is
#: 1e-3 where the masks are the JAX package's draw for draw, 3e-3 where
#: the draws come from another generator (device GOSS, stochastic
#: rounding)
SAMPLING_RUNS = (
    ("bagging_ff", {"bagging_fraction": 0.7, "bagging_freq": 1,
                    "feature_fraction": 0.8}, "f32", 1e-3),
    ("goss_device", {"data_sample_strategy": "goss",
                     "tpu_device_goss": "auto"}, "f32", 3e-3),
    ("goss_host", {"data_sample_strategy": "goss",
                   "tpu_device_goss": "off"}, "f32", 1e-3),
    ("goss_quantized", {"data_sample_strategy": "goss",
                        "use_quantized_grad": True}, "int8", 3e-3))
SAMPLING_REPEAT_ITERS = 10
CV_MEAN_TOL, CV_STDV_TOL = 1e-3, 2e-3
#: holdout ndcg@k bars against the fixture: lambdarank's gradients are
#: the JAX package's to float32 rounding, XE-NDCG's gammas another
#: generator's
NDCG_BARS = {"lambdarank": 5e-3, "rank_xendcg": 1e-2}
LTR_RUNG_ROWS = 2_270_000          # bench.py's LTR_ROWS (the MS-LTR scale)
LTR_GRAD_ITERS = 10


def make_msltr_like(n, f, group, seed=0):
    """bench.py's MS-LTR-like generator (without its disk cache):
    fixed-size query groups, graded relevance 0-4 skewed to low grades."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f) / np.sqrt(f)
    util = X @ w + 0.3 * rng.randn(n)
    cuts = np.quantile(util, [0.60, 0.80, 0.90, 0.97])
    y = np.searchsorted(cuts, util).astype(np.float64)
    groups = np.full(n // group, group, np.int64)
    rem = n - groups.sum()
    if rem:
        groups = np.concatenate([groups, [rem]])
    return X, y, groups


def masked(vals, mask):
    """(N, 3) values of one sampled iteration: gradient and hessian times
    the row mask (0 out of bag, GOSS's amplification), count 1 in bag."""
    import torch
    if vals.dtype == torch.int8:
        keep = (mask > 0).to(torch.int8)[:, None]
        return (vals * keep).contiguous()
    return torch.cat([vals[:, :2] * mask[:, None],
                      (mask > 0).float()[:, None]], dim=1).contiguous()


def sampling_phase(dev, fix, rows, ds, ref):
    """43. The bench config under bagging + feature_fraction and GOSS on
    the card, GOSS on the host and quantized GOSS, 100 iterations each
    through the histogram and fused-wave kernels, held to the JAX
    package's holdout AUC (``ref``); two device-GOSS runs give one model
    text.  Returns the launches of each mode."""
    import lightgbm_tpu_torch as lgt
    out = {"f32": {"histogram": 0, "wave": 0},
           "int8": {"histogram": 0, "wave": 0}}
    goss_params = None
    for name, extra, mode, bar in SAMPLING_RUNS:
        want = ref["sampling"][name]
        require(all(want["params"].get(k) == v for k, v in extra.items()),
                f"{name}: the fixture's params differ from {extra}")
        seeds = want.get("seeds", [None])
        aucs, secs = [], []
        for seed in seeds:
            run = extra if seed is None else dict(
                extra, bagging_seed=seed, feature_fraction_seed=seed)
            tag = f"train_{name}" + ("" if seed is None else f"_seed{seed}")
            bst, params, rec = train_phase(
                dev, fix, rows, tag, run, ds, mode, mode,
                iters=want["iterations"],
                ref=(want["holdout_auc"], bar) if seed is None else None)
            on_dev = bst._gbdt.goss_on_device()
            require(on_dev == (name in ("goss_device", "goss_quantized")),
                    f"{name}: GOSS on the device is {on_dev}")
            out[mode]["histogram"] += rec["histogram_launches"]
            out[mode]["wave"] += rec["wave_launches"]
            aucs.append(rec["holdout_auc"])
            secs.append(rec["s_per_iteration"])
            if name == "goss_device":
                goss_params = params
            del bst
        if seeds != [None]:
            # one run's AUC moves ~1e-3 with the float32 summation order
            # alone: the card is held to the mean over the seeds
            gap = float(np.mean(aucs)) - want["holdout_auc_mean"]
            require(abs(gap) <= bar, f"{name}: mean holdout AUC over seeds "
                    f"{seeds} {np.mean(aucs)} not within {bar} of the JAX "
                    f"package's {want['holdout_auc_mean']}")
            emit({"phase": f"sampling_{name}", "seeds": seeds,
                  "holdout_auc_by_seed": aucs,
                  "ref_holdout_auc_by_seed": want["holdout_auc_by_seed"],
                  "gap_by_seed": [a - b for a, b in zip(
                      aucs, want["holdout_auc_by_seed"])],
                  "holdout_auc_mean": float(np.mean(aucs)),
                  "ref_holdout_auc_mean": want["holdout_auc_mean"],
                  "mean_gap": gap, "bar": bar,
                  "s_per_iteration_mean": float(np.mean(secs))})
    t0 = time.perf_counter()
    texts = [lgt.train(goss_params, ds, SAMPLING_REPEAT_ITERS,
                       device=dev).model_to_string() for _ in range(2)]
    require(texts[0] == texts[1], "two device-GOSS runs gave different "
            "model text")
    emit({"phase": "determinism", "training": "goss_device",
          "iterations": SAMPLING_REPEAT_ITERS, "equal": True,
          "seconds": time.perf_counter() - t0})
    return out


def masked_kernel_phase(gen, dev, fix, ds):
    """44. Both training kernels on sampled iterations' values: the bench
    bins (phase 10's dataset) under one bagging mask and one GOSS mask
    (``sampling.SampleStrategy`` at the bench size: out-of-bag rows at
    count 0, GOSS's rest rows amplified by 8) against their plain
    versions, bit for bit on exact sums and on int8 levels, bit for bit
    their chunk-ordered twins on random values; the wave the same on
    bagging- and GOSS-shaped masks at W = 1 and 16."""
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import histogram_flat as HF
    from lightgbm_tpu_torch.ops import wave as WV
    from lightgbm_tpu_torch.ops.histogram import (histogram_chunked,
                                                  histogram_segment)
    from lightgbm_tpu_torch.ops.split import SplitConfig
    from lightgbm_tpu_torch.sampling import SampleStrategy
    bins = ds.construct().bins_device(dev)
    n = bins.shape[0]
    base = dict(fix["params"])
    base.pop("num_iterations")
    bag = SampleStrategy(Config(dict(base, bagging_fraction=0.7,
                                     bagging_freq=1)), n).mask(0)
    rng = np.random.RandomState(int(torch.randint(0, 2 ** 31, (1,),
                                                  generator=gen, device=dev)))
    goss = SampleStrategy(Config(dict(base, data_sample_strategy="goss")),
                          n).mask(0, rng.randn(n).astype(np.float32),
                                  rng.rand(n).astype(np.float32))
    cases = {}
    for mname, mask_np in (("bagging", bag), ("goss", goss)):
        m = torch.from_numpy(mask_np).to(dev)
        in_bag = int((m > 0).sum())
        ve = masked(device_vals(gen, n, dev, exact=True), m)
        got = HF.histogram_flat(bins, ve, num_bins=255)
        want = histogram_segment(bins, ve, num_bins=255)
        vr = masked(device_vals(gen, n, dev, exact=False), m)
        a = HF.histogram_flat(bins, vr, num_bins=255)
        b = HF.histogram_flat(bins, vr, num_bins=255)
        twin = histogram_chunked(bins, vr, num_bins=255)
        plain = histogram_segment(bins, vr, num_bins=255)
        lv = masked(device_levels(gen, n, dev), m)
        g8 = HF.histogram_flat(bins, lv, num_bins=255)
        w8 = histogram_segment(bins, lv, num_bins=255)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"{mname}: histogram kernel != "
                "plain version on exact sums")
        require(int(got[..., 2].sum()) == in_bag * bins.shape[1],
                f"{mname}: out-of-bag rows counted")
        require(torch.equal(a, b) and torch.equal(a, twin),
                f"{mname}: histogram kernel != its chunk-ordered twin on "
                "random values")
        require(torch.equal(g8, w8), f"{mname}: int8 histogram kernel != "
                "plain version")
        cases[f"histogram/{mname}"] = {
            "rows": n, "in_bag": in_bag,
            "amplified": int((m > 1).sum()), "exact_bitwise": True,
            "random_twin_bitwise": True, "int8_bitwise": True,
            "random_max_abs_err_vs_plain": float((a - plain).abs().max())}
    cfg = SplitConfig(min_data_in_leaf=0, min_sum_hessian_in_leaf=1.0,
                      lambda_l2=0.5, max_cat_to_onehot=4)
    shapes = {"bagging": lambda u: (u < 0.7).float(),
              "goss": lambda u: torch.where(
                  u < 0.2, 1.0, torch.where(u < 0.3, 8.0, 0.0))}
    for mname, shape in shapes.items():
        for wname, (sizes, inactive) in CHECK_WAVES.items():
            n_w = sum(2 * s for s in sizes)
            m = shape(torch.rand(n_w, generator=gen, device=dev))
            for exact in (True, False):
                inp = wave_case(gen, dev, sizes, exact, inactive=inactive,
                                row_mask=m)
                h, p = WV.fused_wave_call(cfg=cfg, **inp)
                hp, pp = WV.wave_plain(cfg=cfg, **inp)
                tag = f"wave/{mname}/{wname}/{'exact' if exact else 'random'}"
                if exact:
                    torch.cuda.synchronize()
                    require(torch.equal(h, hp) and torch.equal(p, pp),
                            f"{tag}: wave kernel != plain version")
                    cases[tag] = {"bitwise": True}
                    continue
                twin = WV.wave_hists_chunked(
                    inp["bins"], inp["vals"], inp["perm"],
                    inp["small_start"], inp["small_cnt"], inp["parent"],
                    inp["stats"], inp["num_bins"])
                torch.cuda.synchronize()
                require(torch.equal(h, twin), f"{tag}: child histograms "
                        "!= their chunk-ordered twin")
                cases[tag] = {"hist_twin_bitwise": True,
                              **wave_agreement(h, p, hp, pp, inp)}
    emit({"phase": "kernels_under_masks", "features": int(bins.shape[1]),
          "bins": 255, "cases": cases})


def cv_phase(dev, fix, rows, ref):
    """45. ``lightgbm_tpu_torch.cv`` at the bench config: 5 stratified
    folds x 20 rounds on the 200,000 training rows (each fold binned
    anew), the last round's ``valid auc-mean`` / ``-stdv`` held to the JAX
    package's; seconds a fold, peak device memory, and the memory left
    after ``cv`` returns (no fold booster kept).  Returns the f32
    launches."""
    import torch
    import lightgbm_tpu_torch as lgt
    want = ref["cv"]
    X, y = rows
    nt = fix["data"]["n_train"]
    params = dict(want["params"])
    starts = []

    def fold_clock(env):
        if env.iteration == 0:
            torch.cuda.synchronize()
            starts.append(time.perf_counter())

    fold_clock.before_iteration = True
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    res = lgt.cv(params, lgt.Dataset(X[:nt], label=y[:nt]), want["rounds"],
                 nfold=want["nfold"], stratified=want["stratified"],
                 seed=want["seed"], callbacks=[fold_clock], device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    after = torch.cuda.memory_allocated()
    ran = _launch_modes(launches)
    trees = want["nfold"] * want["rounds"]
    require(set(ran["histogram"]) == {"f32"} and set(ran["wave"]) == {"f32"},
            f"cv: kernels launched {ran}")
    require(launches["histogram"]["f32"] == trees,
            f"cv: {launches['histogram']['f32']} root histograms for "
            f"{trees} trees")
    mean, stdv = res["valid auc-mean"], res["valid auc-stdv"]
    require(len(mean) == want["rounds"], f"cv: {len(mean)} rounds")
    d_mean = mean[-1] - want["auc_mean"][-1]
    d_stdv = stdv[-1] - want["auc_stdv"][-1]
    require(abs(d_mean) <= CV_MEAN_TOL, f"cv: auc-mean {mean[-1]} vs the "
            f"JAX package's {want['auc_mean'][-1]}")
    require(abs(d_stdv) <= CV_STDV_TOL, f"cv: auc-stdv {stdv[-1]} vs the "
            f"JAX package's {want['auc_stdv'][-1]}")
    ends = starts[1:] + [t0 + total]
    emit({"phase": "cv", "rows": nt, "nfold": want["nfold"],
          "rounds": want["rounds"], "stratified": True,
          "auc_mean": mean[-1], "auc_stdv": stdv[-1],
          "ref_auc_mean": want["auc_mean"][-1],
          "ref_auc_stdv": want["auc_stdv"][-1], "mean_gap": d_mean,
          "stdv_gap": d_stdv, "seconds": total,
          "fold_seconds": [e - s for s, e in zip(starts, ends)],
          "peak_device_bytes": peak, "device_bytes_before": before,
          "device_bytes_after": after,
          "histogram_launches": launches["histogram"]["f32"],
          "wave_launches": launches["wave"]["f32"]})
    return {"histogram": launches["histogram"]["f32"],
            "wave": launches["wave"]["f32"]}


def ltr_phase(dev, ref):
    """46. Learning to rank at the repo's MS-LTR width (137 features,
    queries of 120 documents): lambdarank 15 iterations and rank_xendcg
    10 at bench.py's rung params, the holdout ndcg@1,3,5 held to the JAX
    package's; the gradient step's device ms; two lambdarank runs give one
    model text; the ranker served through ``serving_predictor(quantize=
    "int16")`` equals a numpy walk of its pack bit for bit, one traversal
    launch a request.  Returns the launches."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import traverse
    d = ref["ltr_data"]
    nq, vq, grp = d["queries"], d["valid_queries"], d["group"]
    X, y, groups = make_msltr_like((nq + vq) * grp, d["n_features"], grp,
                                   seed=d["seed"])
    nt = int(groups[:nq].sum())
    require(nt == d["n_train"], "ltr rows != the fixture's")
    emit({"phase": "ltr_data", "rows": int(X.shape[0]), "train_rows": nt,
          "holdout_rows": int(X.shape[0]) - nt, "queries": nq,
          "holdout_queries": vq, "documents_per_query": grp,
          "features": int(X.shape[1]), "cut_from_rows": LTR_RUNG_ROWS})
    out = {"histogram": 0, "wave": 0}
    t0 = time.perf_counter()
    ds = lgt.Dataset(X[:nt], label=y[:nt], group=groups[:nq])
    ds.construct(ref["ranking"]["lambdarank"]["params"])
    dv = lgt.Dataset(X[nt:], label=y[nt:], group=groups[nq:], reference=ds)
    dv.construct()
    emit({"phase": "ltr_binning", "rows": int(X.shape[0]),
          "features": int(X.shape[1]), "seconds": time.perf_counter() - t0})
    ranker = None
    for name in ("lambdarank", "rank_xendcg"):
        want = ref["ranking"][name]
        bst, _h, rec = objective_run(dev, ds, dv, want, name)
        ndcg = rec["holdout"]
        rec["phase"] = f"ltr_{name}"
        out["histogram"] += rec["histogram_launches"]
        out["wave"] += rec["wave_launches"]
        gaps = {k: ndcg[k] - want["holdout"][k] for k in want["holdout"]}
        bar = NDCG_BARS[name]
        require(all(abs(v) <= bar for v in gaps.values()),
                f"{name}: holdout {ndcg} vs the JAX package's "
                f"{want['holdout']} (bar {bar})")
        g = bst._gbdt
        rec.update(ref_holdout=want["holdout"], gaps=gaps, bar=bar)
        if name == "lambdarank":
            rec["gradient_ms"] = cuda_time_ms(
                lambda: g.objective.get_gradients(g.scores),
                iters=LTR_GRAD_ITERS)
            again, _h, rec2 = objective_run(dev, ds, dv, want, name)
            require(again.model_to_string() == bst.model_to_string(),
                    "two lambdarank runs gave different model text")
            out["histogram"] += rec2["histogram_launches"]
            out["wave"] += rec2["wave_launches"]
            rec["repeat_equal"] = True
            del again
            ranker = bst
        emit(rec)
    bst = ranker
    binned = ds.construct().binned
    pred = bst.serving_predictor(quantize="int16", raw_score=True)
    rows_s = X[nt:].astype(np.float64)
    traverse.launches = 0
    t0 = time.perf_counter()
    served = pred.predict(rows_s)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches = traverse.launches
    require(launches == 1, f"{launches} traversal launches for one ranker "
            "request")
    pack = pred.plan._packs[0]
    acc, _ = walk_pack_numpy(pack, binned.apply(rows_s), binned.nan_bins)
    want = (acc.astype(np.int32).astype(np.float32)
            * np.float32(pack["scale"])).astype(np.float64) \
        + bst._gbdt.init_scores[0]
    require(served.shape == want.shape and np.array_equal(served, want),
            "served ranker scores != the numpy walk")
    emit({"phase": "serve_ranker", "rows": int(rows_s.shape[0]),
          "trees": bst.num_trees(), "launches": launches,
          "raw_bitwise": True, "request_ms": serve_ms})
    out["traverse"] = launches
    return out


def slice13_phases(gen, dev, fix, rows, ds):
    """43-47: sampling, the kernels under masks, cv and learning to rank
    against tests/fixtures/torch_sampling_ref.json.  Returns the
    launches of each kernel mode on these paths."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, SAMPLING_FIXTURE)) as fh:
        ref = json.load(fh)
    require(ref["data"]["n_train"] == fix["data"]["n_train"]
            and ref["data"]["seed"] == fix["data"]["seed"],
            "the sampling fixture's rows != the bench rows")
    t0 = time.perf_counter()
    launches = sampling_phase(dev, fix, rows, ds, ref)
    masked_kernel_phase(gen, dev, fix, ds)
    cv_l = cv_phase(dev, fix, rows, ref)
    ltr_l = ltr_phase(dev, ref)
    for kernel in ("histogram", "wave"):
        launches["f32"][kernel] += cv_l[kernel] + ltr_l[kernel]
    launches["traverse"] = ltr_l["traverse"]
    emit({"phase": "slice13", "seconds": time.perf_counter() - t0,
          "launches": launches})
    return launches


# ------------------------------------------------ slice 15: sorted categorical
CAT_FIXTURE = os.path.join("tests", "fixtures", "torch_categorical_ref.json")
#: phase 48's bars on the holdout AUC against the JAX package's: float32
#: order alone moves one 100-iteration run by ~1e-3 (PERF.md), and the
#: sorted order of near-tie categories amplifies it
CAT_AUC_TOL = {"f32": 2e-3, "quantized": 3e-3}
#: phase 48's iterations: the fixture's 100 cut to 30 for the time limit
#: (its history holds the JAX package's AUC after each iteration)
CAT_ITERS = 30
#: phase 49's rows (exact-sum gradients, three growers)
CAT_GROW_ROWS = 20_000
#: phase 50's request: rows, and the shares of categorical cells set to
#: an unseen category and to NaN
CAT_SERVE_ROWS = 65_536
CAT_UNSEEN, CAT_NAN = 0.03, 0.02


def cat_sets(bst):
    """Category counts of every categorical node of a booster's trees."""
    return [int(np.asarray(t.cat_mask[i]).sum())
            for cls in bst._gbdt.models for t in cls
            for i in range(t.num_leaves - 1) if bool(t.is_cat[i])]


def sorted_cat_training(dev, fix, ref, data, rec10):
    """48. ``make_airline_like`` at the bench params, the categorical keys
    at their defaults: ``CAT_ITERS`` iterations in f32 and quantized
    (``stochastic_rounding`` false) through the fused wave and histogram
    kernels, the holdout AUC within ``CAT_AUC_TOL`` of the JAX package's
    at that iteration (tests/fixtures/torch_categorical_ref.json's
    history), at least one category set of 2 or more; f32 at
    ``max_cat_to_onehot`` 256 beside them (no bar).  Returns (the f32
    booster, its params, the dataset, launches by mode)."""
    import lightgbm_tpu_torch as lgt
    X, y, cat_cols = data
    nt = ref["data"]["n_train"]
    rows = (X, y)
    cfix = dict(fix, data=dict(fix["data"], n_train=nt))
    t0 = time.perf_counter()
    ds = lgt.Dataset(X[:nt], label=y[:nt], categorical_feature=cat_cols)
    ds.construct(dict(ref["params"]))
    binned = ds.construct().binned
    nbpf = [int(binned.num_bins_per_feature[j]) for j in cat_cols]
    emit({"phase": "categorical_data", "rows": int(X.shape[0]),
          "train_rows": nt, "features": int(X.shape[1]),
          "categorical_columns": cat_cols, "bins": nbpf,
          "rest_bin_share": [float(np.mean(binned.bins[:, j] == b - 1))
                             for j, b in zip(cat_cols, nbpf)],
          "binning_s": time.perf_counter() - t0})
    launches = {"f32": {"histogram": 0, "wave": 0},
                "int8": {"histogram": 0, "wave": 0}}
    out = {}
    for name, extra, mode in (
            ("f32", {}, "f32"),
            ("quantized", {"use_quantized_grad": True,
                           "stochastic_rounding": False}, "int8"),
            ("onehot", {"max_cat_to_onehot": 256}, "f32")):
        want = ref["runs"][name]
        want_auc = want["history"][CAT_ITERS - 1]
        bst, params, rec = train_phase(
            dev, cfix, rows, f"train_categorical_{name}", extra, ds, mode,
            mode, iters=CAT_ITERS)
        launches[mode]["histogram"] += rec["histogram_launches"]
        launches[mode]["wave"] += rec["wave_launches"]
        sets = cat_sets(bst)
        gap = rec["holdout_auc"] - want_auc
        summary = {"phase": f"categorical_{name}", "iterations": CAT_ITERS,
                   "holdout_auc": rec["holdout_auc"],
                   "jax_holdout_auc": want_auc, "gap": gap,
                   "s_per_iteration": rec["s_per_iteration"],
                   "phase10_s_per_iteration": rec10["s_per_iteration"],
                   "categorical_nodes": len(sets),
                   "max_set_size": max(sets, default=0),
                   "jax_max_set_size": want["max_set_size"]}
        if name in CAT_AUC_TOL:
            require(abs(gap) <= CAT_AUC_TOL[name],
                    f"categorical {name}: holdout AUC {rec['holdout_auc']} "
                    f"not within {CAT_AUC_TOL[name]} of the JAX package's "
                    f"{want_auc}")
            require(max(sets, default=0) >= 2, f"categorical {name}: no "
                    "category set of 2 or more")
            summary["bar"] = CAT_AUC_TOL[name]
        emit(summary)
        out[name] = (bst, params)
    return out["f32"][0], out["f32"][1], ds, launches


def sorted_cat_grower_phase(dev, ref, data):
    """49. Exact-sum gradients on ``CAT_GROW_ROWS`` of the categorical rows
    (+-0.5 and 0.25; quantized: values in [-1, 1] and (0, 1] with power-of-
    two scales): the grower through the fused wave kernel on the card, the
    ``tpu_wave_kernel=unfused`` grower on the card and the CPU grower give
    equal trees and ``row_leaf``, f32 and quantized.  Returns launches by
    mode."""
    import dataclasses
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import TrainData
    from lightgbm_tpu_torch.models.gbdt import _split_config
    from lightgbm_tpu_torch.models.grower import (GrowerConfig, make_grower,
                                                  wave_fused_for)
    X, y, cat_cols = data
    n = CAT_GROW_ROWS
    cfg = Config(dict(ref["params"], verbosity=-1))
    td = TrainData.build(X[:n], y[:n], cfg, categorical_features=cat_cols)
    rng = np.random.RandomState(3)
    sign = (rng.rand(n) > 0.5).astype(np.float32)
    exact = (sign - np.float32(0.5), np.full(n, 0.25, np.float32))
    gq = rng.uniform(-1, 1, n).astype(np.float32)
    hq = rng.uniform(0.01, 1, n).astype(np.float32)
    gq[0], hq[1] = -1.0, 1.0
    base = GrowerConfig(num_leaves=cfg.num_leaves,
                        num_bins=td.binned.max_num_bins,
                        split=_split_config(cfg, td), leaf_batch=16)
    require(base.split.use_sorted_categorical, "phase 49: no sorted feature")
    fields = TREE_FIELDS

    def grow(device, grads, **kw):
        gcfg = dataclasses.replace(base, **kw)
        meta = td.feature_meta_device(device)
        tree, row_leaf = make_grower(gcfg)(
            td.bins_device(device), torch.from_numpy(grads[0]).to(device),
            torch.from_numpy(grads[1]).to(device),
            torch.ones(n, device=device),
            torch.ones(X.shape[1], dtype=torch.bool, device=device),
            meta["num_bins_per_feature"], meta["nan_bins"],
            meta["is_categorical"])
        out = {k: getattr(tree, k).cpu().numpy() for k in fields}
        out["num_leaves"] = int(tree.num_leaves)
        out["row_leaf"] = row_leaf.cpu().numpy()
        return out

    launches = {"f32": {"histogram": 0, "wave": 0},
                "int8": {"histogram": 0, "wave": 0}}
    cases = {}
    cpu = torch.device("cpu")
    for name, grads, kw, mode in (
            ("f32", exact, {}, "f32"),
            ("quantized", (gq, hq), {"quantized": True,
                                     "stochastic_rounding": False}, "int8")):
        require(wave_fused_for(dataclasses.replace(base, **kw), dev),
                "phase 49: auto does not fuse on the card")
        t0 = time.perf_counter()
        want = grow(cpu, grads, **kw)
        cpu_s = time.perf_counter() - t0
        _zero_launches()
        fused = grow(dev, grads, **kw)
        fl = _read_launches()
        unfused = grow(dev, grads, wave_kernel="unfused", **kw)
        ul = _read_launches()
        require(fl["wave"][mode] > 0 and fl["histogram"][mode] == 1,
                f"phase 49 {name}: fused grower launched {fl}")
        require(ul["wave"][mode] == fl["wave"][mode]
                and ul["histogram"][mode] > fl["histogram"][mode],
                f"phase 49 {name}: unfused grower launched {ul}")
        for label, got in (("fused", fused), ("unfused", unfused)):
            for k in fields + ("num_leaves", "row_leaf"):
                require(np.array_equal(np.asarray(got[k]),
                                       np.asarray(want[k])),
                        f"phase 49 {name}: the {label} grower on the card "
                        f"differs from the CPU grower in {k}")
        m = want["num_leaves"] - 1
        sets = want["cat_mask"][:m][want["is_cat"][:m]].sum(axis=1)
        require(sets.size and sets.max() >= 2,
                f"phase 49 {name}: no category set of 2 or more")
        for kernel in ("histogram", "wave"):
            launches[mode][kernel] += ul[kernel][mode]
        cases[name] = {"leaves": want["num_leaves"],
                       "categorical_nodes": int(sets.size),
                       "max_set_size": int(sets.max()), "cpu_s": cpu_s,
                       "launches_fused": {k: fl[k][mode] for k in fl},
                       "launches_unfused": {k: ul[k][mode] - fl[k][mode]
                                            for k in ul}}
    emit({"phase": "categorical_growers_equal", "rows": n,
          "features": int(X.shape[1]), "cases": cases})
    return launches


def sorted_cat_serving_phase(dev, bst, ds, data, ref, seed):
    """50. Phase 48's f32 model served as an int16 pack on
    ``CAT_SERVE_ROWS`` holdout rows whose categorical cells are set to an
    unseen category (3%) or NaN (2%): bit for bit a numpy walk of the
    pack, one traversal launch.  Then the model's text loaded in the port:
    rows with no rest-bin category within the round-trip bar of the
    in-memory predictions; how many rest-bin rows differ is reported (the
    text's bitsets hold category values only, so a rest bin in a left set
    goes right after the round trip: the JAX package's behaviour).
    Returns the traversal launches."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import traverse
    X, _y, cat_cols = data
    nt = ref["data"]["n_train"]
    rng = np.random.RandomState(seed + 50)
    rows = X[nt:][rng.randint(0, X.shape[0] - nt, CAT_SERVE_ROWS)].copy()
    u = rng.rand(CAT_SERVE_ROWS, len(cat_cols))
    block = rows[:, cat_cols]
    block[u < CAT_UNSEEN] = 10_000 + rng.randint(0, 100, (u < CAT_UNSEEN).sum())
    block[(u >= CAT_UNSEEN) & (u < CAT_UNSEEN + CAT_NAN)] = np.nan
    rows[:, cat_cols] = block
    binned = ds.construct().binned
    pred = bst.serving_predictor(quantize="int16", raw_score=True)
    traverse.launches = 0
    t0 = time.perf_counter()
    served = pred.predict(rows)
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - t0) * 1e3
    launches = traverse.launches
    require(launches == 1, f"{launches} traversal launches for one request")
    pack = pred.plan._packs[0]
    host_bins = binned.apply(rows)
    acc, _ = walk_pack_numpy(pack, host_bins, binned.nan_bins)
    want = (acc.astype(np.int32).astype(np.float32)
            * np.float32(pack["scale"])).astype(np.float64) \
        + bst._gbdt.init_scores[0]
    require(served.shape == want.shape and np.array_equal(served, want),
            "served categorical scores != the numpy walk")
    mem = bst.predict(rows, raw_score=True)
    loaded = lgt.Booster(model_str=bst.model_to_string(), device=dev)
    raw = loaded.predict(rows, raw_score=True)
    rest = np.zeros(CAT_SERVE_ROWS, bool)
    for j in cat_cols:
        rest |= host_bins[:, j] == binned.num_bins_per_feature[j] - 1
    bar = LOAD_RAW_TOL + fp32_sum_bound(bst.num_trees(), mem)
    diff = np.abs(raw - mem)
    err_seen = float(diff[~rest].max())
    require(err_seen <= bar, f"loaded categorical model: rows without a "
            f"rest-bin category off by {err_seen} (bar {bar})")
    rest_left = sum(bool(t.cat_mask[i, binned.num_bins_per_feature[
        t.split_feature[i]] - 1]) for t in bst._gbdt.models[0]
        for i in range(t.num_leaves - 1) if bool(t.is_cat[i]))
    emit({"phase": "serve_categorical", "rows": CAT_SERVE_ROWS,
          "launches": launches, "raw_bitwise": True,
          "request_ms": request_ms, "rest_bin_rows": int(rest.sum()),
          "rest_bin_in_left_sets": int(rest_left),
          "loaded_max_abs_err_seen": err_seen, "bar": bar,
          "loaded_rest_rows_differing": int((diff[rest] > bar).sum()),
          "loaded_rest_max_abs_diff": float(diff[rest].max())
          if rest.any() else 0.0})
    return launches


def slice15_phases(dev, fix, rec10, seed):
    """48-51: sorted many-vs-many categorical splits against
    tests/fixtures/torch_categorical_ref.json.  Returns the launches of
    each kernel mode on these paths."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, CAT_FIXTURE)) as fh:
        ref = json.load(fh)
    d = ref["data"]
    t0 = time.perf_counter()
    data = make_airline_like(d["n_train"] + d["n_valid"], d["seed"])
    require(data[2] == d["categorical_columns"],
            "the categorical fixture's columns != make_airline_like's")
    bst, params, ds, launches = sorted_cat_training(dev, fix, ref, data,
                                                    rec10)
    grow_l = sorted_cat_grower_phase(dev, ref, data)
    for mode in launches:
        for kernel in launches[mode]:
            launches[mode][kernel] += grow_l[mode][kernel]
    launches["traverse"] = sorted_cat_serving_phase(dev, bst, ds, data, ref,
                                                    seed)
    # 51. where a sorted-categorical iteration's time goes
    prof = profile_phase(params, ds, dev)
    emit({**prof, "training": "categorical_f32",
          "sorted_cat_ms_per_iteration": prof[
              "range_host_ms_per_iteration"].get("grower/sorted_cat", 0.0),
          "phase10_s_per_iteration": rec10["s_per_iteration"]})
    require(prof["range_host_ms_per_iteration"].get("grower/sorted_cat", 0)
            > 0, "the profiler saw no grower/sorted_cat range")
    emit({"phase": "slice15", "seconds": time.perf_counter() - t0,
          "launches": launches})
    return launches


# ------------------------------------------------ slice 16: EFB bundling
EFB_FIXTURE = os.path.join("tests", "fixtures", "torch_efb_ref.json")
#: phase 52's bars on the holdout AUC against the JAX package's: phase
#: 48's, for its reason (float32 order moves a run by ~1e-3; PERF.md §2)
EFB_AUC_TOL = {"f32": 2e-3, "quantized": 3e-3}
#: phase 52's bar on the f32 holdout AUC against the port's own unbundled
#: run on the same rows: twice the widest of five readings (|gap| <=
#: 5.3e-4 over data seeds 0-4, tools/torch_efb_gap.py; bin 0 rebuilt as a
#: difference moves near-tie splits, PERF.md §6)
EFB_UNBUNDLED_TOL = 1e-3
#: phase 53's rows of the one-hot data (exact-sum gradients), and its
#: min_sum_hessian_in_leaf (255-leaf trees that split one-hot columns)
EFB_GROW_ROWS = 20_000
EFB_GROW_MIN_HESSIAN = 1.0
#: phase 54's request rows
EFB_SERVE_ROWS = 65_536


def make_wide_bundle_data(n, seed=2):
    """Eight mutually exclusive columns of 60 bins each (0 and 59 levels)
    and two normal ones (tests/test_torch_efb.py's ``_wide_data``): the
    eight bundle into one column of 1 + 8 * 59 = 473 bins, so the bundled
    matrix is uint16.  Returns (X (n, 10) float64, y)."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 8, n)
    level = rng.randint(1, 60, n).astype(np.float64)
    X = np.zeros((n, 10))
    X[np.arange(n), base] = level
    X[:, 8:] = rng.randn(n, 2)
    y = ((base % 3 == 0) ^ (level > 30) ^ (X[:, 8] > 0.8)).astype(np.float64)
    return X, y


def bundle_layout(fb):
    """What phase 52 holds to the fixture: the column count, each
    column's bins and the SHA-256 of the bundled matrix's bytes."""
    import hashlib
    return {"num_groups": int(fb.num_groups),
            "group_bins": [int(b) for b in fb.group_bins],
            "bins_dtype": str(fb.bins.dtype),
            "bins_sha256": hashlib.sha256(fb.bins.tobytes()).hexdigest()}


def efb_training(dev, fix, ref, data, rec10):
    """52. ``make_onehot_airline_like``'s 660 features at the bench params
    with ``enable_bundle`` at its default: the bundles equal the JAX
    package's (column count, bins a column, the bundled matrix's hash);
    50 iterations in f32 and quantized (``stochastic_rounding`` false)
    through the fused wave and histogram kernels over the bundled matrix,
    the holdout AUC within ``EFB_AUC_TOL`` of the JAX package's
    (tests/fixtures/torch_efb_ref.json); the f32 run unbundled
    (``enable_bundle`` false) beside them, the bundled f32 AUC within
    ``EFB_UNBUNDLED_TOL`` of it.  Reports binning and
    bundling seconds, s/iteration beside phase 10's and the peak device
    memory.
    Returns (the f32 booster, its params, the dataset, its bundles,
    launches by mode)."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.config import Config
    X, y = data
    nt = ref["data"]["n_train"]
    cfix = dict(fix, data=dict(fix["data"], n_train=nt))
    t0 = time.perf_counter()
    ds = lgt.Dataset(X[:nt], label=y[:nt])
    td = ds.construct(dict(ref["params"]))
    binning_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fb = td.build_bundles(Config(dict(ref["params"])))
    bundling_s = time.perf_counter() - t0
    require(fb is not None, "phase 52: the one-hot data did not bundle")
    layout = bundle_layout(fb)
    want = {k: ref["bundles"][k] for k in layout}
    require(layout == want, "phase 52: the bundles differ from the JAX "
            f"package's ({layout['num_groups']} columns, {layout['bins_sha256']}"
            f" against {want['num_groups']}, {want['bins_sha256']})")
    emit({"phase": "efb_data", "rows": int(X.shape[0]), "train_rows": nt,
          "features": int(X.shape[1]), "columns": layout["num_groups"],
          "multi_member_bundles": int(np.sum(
              np.bincount(fb.feat_group) > 1)),
          "max_column_bins": int(fb.max_group_bins),
          "bins_dtype": layout["bins_dtype"], "layout_equal": True,
          "binning_s": binning_s, "bundling_s": bundling_s,
          "jax_cpu_bundling_s": ref["bundling_s"]})
    launches = {}
    out = {}
    # the kernels' uint8 modes (uint16 where a column passes 256 bins)
    wide = "_uint16" if fb.bins.dtype == np.uint16 else ""
    for name, extra, mode in (
            ("f32", {}, "f32" + wide),
            ("quantized", {"use_quantized_grad": True,
                           "stochastic_rounding": False}, "int8" + wide)):
        want_auc = ref["runs"][name]["holdout_auc"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bst, params, rec = train_phase(
            dev, cfix, data, f"train_efb_{name}", extra, ds, mode, mode,
            iters=ref["iterations"])
        peak = torch.cuda.max_memory_allocated()
        g = bst._gbdt
        require(g.bundles is fb and "bundle" in g._bundle_args
                and tuple(g.bins_dev.shape) == (nt, fb.num_groups),
                f"phase 52 {name}: trained on {tuple(g.bins_dev.shape)} "
                "bins, not the bundled matrix")
        launches[mode] = {"histogram": rec["histogram_launches"],
                          "wave": rec["wave_launches"]}
        gap = rec["holdout_auc"] - want_auc
        require(abs(gap) <= EFB_AUC_TOL[name],
                f"EFB {name}: holdout AUC {rec['holdout_auc']} not within "
                f"{EFB_AUC_TOL[name]} of the JAX package's {want_auc}")
        emit({"phase": f"efb_{name}", "iterations": ref["iterations"],
              "holdout_auc": rec["holdout_auc"], "jax_holdout_auc": want_auc,
              "gap": gap, "bar": EFB_AUC_TOL[name],
              "s_per_iteration": rec["s_per_iteration"],
              "phase10_s_per_iteration": rec10["s_per_iteration"],
              "peak_device_bytes": peak,
              "leaf_hist_bytes": int(g.grower_cfg.num_leaves * fb.num_groups
                                     * fb.max_group_bins * 3 * 4)})
        out[name] = (bst, params, rec)
    # the same f32 run unbundled beside them: what bundling changes in
    # time, memory and AUC
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    unb, _p, rec_u = train_phase(
        dev, cfix, data, "train_efb_unbundled_f32", {"enable_bundle": False},
        ds, "f32", "f32", iters=ref["iterations"])
    require(unb._gbdt.bundles is None
            and tuple(unb._gbdt.bins_dev.shape) == (nt, X.shape[1]),
            "phase 52: the unbundled run trained on bundled bins")
    own_gap = out["f32"][2]["holdout_auc"] - rec_u["holdout_auc"]
    require(abs(own_gap) <= EFB_UNBUNDLED_TOL,
            f"EFB f32: holdout AUC {out['f32'][2]['holdout_auc']} not within "
            f"{EFB_UNBUNDLED_TOL} of the unbundled run's "
            f"{rec_u['holdout_auc']}")
    emit({"phase": "efb_unbundled_f32", "holdout_auc": rec_u["holdout_auc"],
          "bundled_gap": own_gap, "bundled_bar": EFB_UNBUNDLED_TOL,
          "bundled_holdout_auc": out["f32"][2]["holdout_auc"],
          "jax_bundled_holdout_auc": ref["runs"]["f32"]["holdout_auc"],
          "jax_holdout_auc": ref["runs"]["unbundled"]["holdout_auc"],
          "s_per_iteration": rec_u["s_per_iteration"],
          "bundled_s_per_iteration": out["f32"][2]["s_per_iteration"],
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    lf = launches.setdefault("f32", {"histogram": 0, "wave": 0})
    lf["histogram"] += rec_u["histogram_launches"]
    lf["wave"] += rec_u["wave_launches"]
    del unb
    return out["f32"][0], out["f32"][1], ds, fb, launches


def efb_grower_phase(dev, ref, data, ds, fb52):
    """53. Exact-sum gradients that follow the label (0.5 - y and 0.25;
    quantized: values in [-1, 1] and (0, 1] with power-of-two scales) on
    the first ``EFB_GROW_ROWS`` rows of phase 52's own bundled matrix
    (its 339 uint8 columns, the columns the re-check split off included)
    and on ``make_wide_bundle_data``'s rows (a 473-bin column: uint16
    bundles), at ``EFB_GROW_MIN_HESSIAN``, each tree splitting a bundled
    feature: the bundled grower through the fused wave kernel on the
    card, the ``tpu_wave_kernel=unfused`` bundled grower on the card, the
    bundled CPU grower and the unbundled grower on the card give equal
    trees and ``row_leaf``, f32 and quantized.  Returns launches by
    mode."""
    import dataclasses
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import TrainData
    from lightgbm_tpu_torch.models.gbdt import _split_config
    from lightgbm_tpu_torch.models.grower import (GrowerConfig, make_grower,
                                                  wave_fused_for)
    from lightgbm_tpu_torch.ops.bundle import bundle_tables
    n = EFB_GROW_ROWS
    # min_sum_hessian_in_leaf 1: at the bench's 100 a 20,000-row tree of
    # these gradients stops at 39 leaves with no split on a one-hot
    # column, and the decode would go unread
    cfg = Config(dict(ref["params"], verbosity=-1,
                      min_sum_hessian_in_leaf=EFB_GROW_MIN_HESSIAN))
    rng = np.random.RandomState(3)

    def label_grads(y):
        """Exact-sum gradients that follow the label (binary logloss's
        first gradients without a boost from average, 0.5 - y, so the
        trees split on what carries the label, the one-hot columns
        too), and quantized ones: the same signs times magnitudes in
        (0, 1], one row at exactly 1 in each channel."""
        exact = ((0.5 - y).astype(np.float32), np.full(n, 0.25, np.float32))
        gq = ((1.0 - 2.0 * y) * rng.uniform(0.05, 1, n)).astype(np.float32)
        hq = rng.uniform(0.01, 1, n).astype(np.float32)
        gq[0], hq[1] = np.float32(1.0 - 2.0 * y[0]), 1.0
        return exact, (gq, hq)
    fields = TREE_FIELDS
    launches = {}
    cases = {}
    cpu = torch.device("cpu")
    # phase 52's TrainData and bundles, cut to the first n rows: its
    # bundles fit any subset of its rows
    td52 = ds.construct()
    wide_td = TrainData.build(*make_wide_bundle_data(n), cfg)
    for dname, td, fb, y in (
            ("onehot", td52, fb52, data[1][:n]),
            ("uint16", wide_td, wide_td.build_bundles(cfg), wide_td.label)):
        require(fb is not None, f"phase 53 {dname}: no bundles")
        want_dtype = np.uint8 if dname == "onehot" else np.uint16
        require(fb.bins.dtype == want_dtype,
                f"phase 53 {dname}: bundled matrix {fb.bins.dtype}")
        wide = "_uint16" if fb.bins.dtype == np.uint16 else ""
        exact, quant = label_grads(np.asarray(y[:n], np.float64))
        base = GrowerConfig(num_leaves=cfg.num_leaves,
                            num_bins=td.binned.max_num_bins,
                            split=_split_config(cfg, td), leaf_batch=16)
        host_bins = {True: np.ascontiguousarray(fb.bins[:n]),
                     False: np.ascontiguousarray(td.binned.bins[:n])}

        def grow(device, grads, bundled=True, **kw):
            gcfg = dataclasses.replace(base, **kw)
            meta = td.feature_meta_device(device)
            efb = ({"bundle": bundle_tables(
                fb, td.binned.num_bins_per_feature, base.num_bins, device)}
                if bundled else {})
            tree, row_leaf = make_grower(gcfg)(
                torch.from_numpy(host_bins[bundled]).to(device),
                torch.from_numpy(grads[0]).to(device),
                torch.from_numpy(grads[1]).to(device),
                torch.ones(n, device=device),
                torch.ones(td.num_features, dtype=torch.bool, device=device),
                meta["num_bins_per_feature"], meta["nan_bins"],
                meta["is_categorical"], **efb)
            out = {k: getattr(tree, k).cpu().numpy() for k in fields}
            out["num_leaves"] = int(tree.num_leaves)
            out["row_leaf"] = row_leaf.cpu().numpy()
            return out

        for name, grads, kw, mode in (
                ("f32", exact, {}, "f32" + wide),
                ("quantized", quant, {"quantized": True,
                                      "stochastic_rounding": False},
                 "int8" + wide)):
            require(wave_fused_for(dataclasses.replace(base, **kw), dev),
                    "phase 53: auto does not fuse on the card")
            t0 = time.perf_counter()
            want = grow(cpu, grads, **kw)
            cpu_s = time.perf_counter() - t0
            _zero_launches()
            t0 = time.perf_counter()
            fused = grow(dev, grads, **kw)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            fl = _read_launches()
            unfused = grow(dev, grads, wave_kernel="unfused", **kw)
            ul = _read_launches()
            plain = grow(dev, grads, bundled=False, **kw)
            require(fl["wave"][mode] > 0 and fl["histogram"][mode] == 1,
                    f"phase 53 {dname} {name}: fused grower launched {fl}")
            require(ul["wave"][mode] == fl["wave"][mode]
                    and ul["histogram"][mode] > fl["histogram"][mode],
                    f"phase 53 {dname} {name}: unfused grower launched {ul}")
            require(want["num_leaves"] > 2,
                    f"phase 53 {dname} {name}: a stump")
            for label, got in (("fused", fused), ("unfused", unfused),
                               ("unbundled", plain)):
                for k in fields + ("num_leaves", "row_leaf"):
                    require(np.array_equal(np.asarray(got[k]),
                                           np.asarray(want[k])),
                            f"phase 53 {dname} {name}: the {label} grower "
                            f"differs from the bundled CPU grower in {k}")
            m = want["num_leaves"] - 1
            bundled_splits = int(np.sum(
                fb.feat_offset[want["split_feature"][:m]] >= 0))
            require(bundled_splits > 0, f"phase 53 {dname} {name}: no "
                    "split on a bundled feature")
            lm = launches.setdefault(mode, {"histogram": 0, "wave": 0})
            for kernel in ("histogram", "wave"):
                lm[kernel] += ul[kernel][mode]
            cases[f"{dname}/{name}"] = {
                "leaves": want["num_leaves"], "columns": fb.num_groups,
                "bins_dtype": str(fb.bins.dtype),
                "splits_on_bundled_features": bundled_splits,
                "cpu_s": cpu_s, "card_fused_s": card_s,
                "launches_fused": {k: fl[k][mode] for k in fl},
                "launches_unfused": {k: ul[k][mode] - fl[k][mode]
                                     for k in ul}}
    emit({"phase": "efb_growers_equal", "rows": n, "cases": cases})
    return launches


def efb_serving_phase(dev, bst, ds, data, ref, seed):
    """54a. Phase 52's f32 model (its trees in feature space) served as an
    int16 pack on ``EFB_SERVE_ROWS`` holdout rows: bit for bit a numpy
    walk of the pack, one traversal launch.  Returns the launches."""
    import torch
    from lightgbm_tpu_torch.ops import traverse
    X, _y = data
    nt = ref["data"]["n_train"]
    rng = np.random.RandomState(seed + 54)
    rows = X[nt:][rng.randint(0, X.shape[0] - nt, EFB_SERVE_ROWS)]
    binned = ds.construct().binned
    pred = bst.serving_predictor(quantize="int16", raw_score=True)
    traverse.launches = 0
    t0 = time.perf_counter()
    served = pred.predict(rows)
    torch.cuda.synchronize()
    request_ms = (time.perf_counter() - t0) * 1e3
    launches = traverse.launches
    require(launches == 1, f"{launches} traversal launches for one request")
    pack = pred.plan._packs[0]
    acc, _ = walk_pack_numpy(pack, binned.apply(rows), binned.nan_bins)
    want = (acc.astype(np.int32).astype(np.float32)
            * np.float32(pack["scale"])).astype(np.float64) \
        + bst._gbdt.init_scores[0]
    require(served.shape == want.shape and np.array_equal(served, want),
            "served EFB scores != the numpy walk")
    emit({"phase": "serve_efb", "rows": EFB_SERVE_ROWS, "features":
          int(X.shape[1]), "launches": launches, "raw_bitwise": True,
          "request_ms": request_ms})
    return launches


def slice16_phases(dev, fix, rec10, seed):
    """52-54: exclusive feature bundling against
    tests/fixtures/torch_efb_ref.json.  Returns the launches of each
    kernel mode on these paths, and what phase 58 reads: phase 52's
    dataset and f32 params and phase 54's profile."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, EFB_FIXTURE)) as fh:
        ref = json.load(fh)
    d = ref["data"]
    t0 = time.perf_counter()
    data = make_onehot_airline_like(d["n_train"] + d["n_valid"], d["seed"])
    require(data[0].shape[1] == d["n_features"],
            "the EFB fixture's features != make_onehot_airline_like's")
    bst, params, ds, fb, launches = efb_training(dev, fix, ref, data, rec10)
    for mode, counts in efb_grower_phase(dev, ref, data, ds, fb).items():
        lm = launches.setdefault(mode, {"histogram": 0, "wave": 0})
        for kernel in counts:
            lm[kernel] += counts[kernel]
    launches["traverse"] = efb_serving_phase(dev, bst, ds, data, ref, seed)
    # 54b. where a bundled iteration's time goes
    prof = profile_phase(params, ds, dev)
    efb_ms = prof["range_host_ms_per_iteration"].get("grower/efb_scan", 0.0)
    emit({**prof, "training": "efb_f32", "efb_scan_ms_per_iteration": efb_ms,
          "phase10_s_per_iteration": rec10["s_per_iteration"]})
    require(efb_ms > 0, "the profiler saw no grower/efb_scan range")
    emit({"phase": "slice16", "seconds": time.perf_counter() - t0,
          "launches": launches})
    return launches, {"ds": ds, "params": params, "profile": prof}


# ------------------------------- slice 17: the histogram pool, tiled scans
#: phases 55-57's leaf batch (the bench's tpu_leaf_batch)
POOL_LEAF_BATCH = 16
#: phase 55's growers: name, GrowerConfig fields, the kernels' mode
POOL_GROWERS = (("f32", {}, "f32"),
                ("f32_unfused", {"wave_kernel": "unfused"}, "f32"),
                ("quantized", {"quantized": True,
                               "stochastic_rounding": False}, "int8"),
                ("bf16", {"histogram_impl": "flat_bf16",
                          "wave_kernel": "fused"}, "bf16"))
#: phase 56's quantized iterations, pooled and unpooled
POOL_QUANT_ITERS = 30
#: phase 57: LightGBM's published Experiments config for Epsilon
#: (2,000 dense features, 400,000 rows: docs/Experiments.rst), its rows
#: cut to EPS_ROWS for the time limit; the pool's size in MB, and how far
#: the pooled grower's peak must fall below the unpooled one's (full
#: residency 255 x 2,000 x 255 x 12 B = 1.56 GB, the pool's 33 slots
#: 0.20 GB)
EPS_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "min_sum_hessian_in_leaf": 100,
              "verbosity": -1}
EPS_FEATURES = 2000
EPS_ROWS = 131_072
EPS_POOL_MB = 128
EPS_PEAK_DROP = 1.0e9
#: phase 57's explicit block width (2,000 columns: 16 blocks)
EPS_TILE = 128
#: phase 58's iterations at each tile setting, and its explicit width
#: (660 columns in feature space: 6 blocks)
TILE_ITERS = 10
EFB_TILE = 128


def grow_once(grower, bins, grad, hess, meta):
    """One tree of ``grower`` on the card with every row in the bag and
    every feature on: (tree fields and ``row_leaf`` as numpy, launches by
    kernel and mode, seconds)."""
    import torch
    dev = bins.device
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree, row_leaf = grower(bins, grad, hess,
                            torch.ones(bins.shape[0], device=dev),
                            torch.ones(meta[0].shape[0], dtype=torch.bool,
                                       device=dev), *meta)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = {k: getattr(tree, k).cpu().numpy() for k in TREE_FIELDS}
    out["num_leaves"] = int(tree.num_leaves)
    out["row_leaf"] = row_leaf.cpu().numpy()
    return out, _read_launches(), seconds


def same_tree(a, b):
    return all(np.array_equal(a[k], b[k])
               for k in TREE_FIELDS + ("num_leaves", "row_leaf"))


def add_launches(total, launches):
    """Add one run's launches by kernel and mode into ``total`` (mode ->
    {"histogram": n, "wave": n})."""
    for kernel, counts in launches.items():
        for mode, n in counts.items():
            if n:
                lm = total.setdefault(mode, {"histogram": 0, "wave": 0})
                lm[kernel] += n


def pool_grower_phase(dev, fix, rows, ds):
    """55. Phase 10's 200,000 x 28 uint8 rows at its params (255 leaves)
    and ``tpu_leaf_batch`` 16, with exact-sum gradients that follow the
    label (0.5 - y, hessian 0.25; bf16-exact): the grower at
    ``histogram_pool_size`` 0 (the floor, 2W + 1 = 33 slots) against the
    unpooled grower, fused f32, ``tpu_wave_kernel=unfused`` f32, fused
    quantized and fused bf16 (``flat_bf16``).  Trees and ``row_leaf``
    bit for bit, misses > 0, and each miss one more histogram launch
    than the unpooled grower made (the wave launches the same).  Returns
    launches by mode."""
    import dataclasses
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.gbdt import _split_config
    from lightgbm_tpu_torch.models.grower import GrowerConfig, make_grower
    td = ds.construct()
    cfg = Config(dict(fix["params"], tpu_leaf_batch=POOL_LEAF_BATCH,
                      verbosity=-1))
    nt = fix["data"]["n_train"]
    y = np.asarray(rows[1][:nt], np.float64)
    grad = torch.from_numpy((0.5 - y).astype(np.float32)).to(dev)
    hess = torch.full((nt,), 0.25, device=dev)
    bins = td.bins_device(dev)
    m = td.feature_meta_device(dev)
    meta = (m["num_bins_per_feature"], m["nan_bins"], m["is_categorical"])
    base = GrowerConfig(num_leaves=cfg.num_leaves,
                        num_bins=td.binned.max_num_bins,
                        split=_split_config(cfg, td),
                        leaf_batch=POOL_LEAF_BATCH)
    launches, cases = {}, {}
    for name, kw, mode in POOL_GROWERS:
        plain = make_grower(dataclasses.replace(base, **kw))
        pooled = make_grower(dataclasses.replace(base, histogram_pool_size=0,
                                                 **kw))
        slots = pooled.pool_slots(bins.shape[1])
        require(slots == 2 * POOL_LEAF_BATCH + 1,
                f"phase 55: {slots} pool slots, not the floor")
        want, ul, us = grow_once(plain, bins, grad, hess, meta)
        got, pl, ps = grow_once(pooled, bins, grad, hess, meta)
        counts = pooled.pool_counts
        require(same_tree(want, got), f"phase 55 {name}: the pooled tree "
                "differs from the unpooled one")
        require(counts["misses"] > 0, f"phase 55 {name}: no pool miss")
        require(want["num_leaves"] > slots, f"phase 55 {name}: "
                f"{want['num_leaves']} leaves fit the pool")
        for label, lc in (("unpooled", ul), ("pooled", pl)):
            ran = {(k, md) for k in lc for md, v in lc[k].items() if v}
            require(ran <= {("histogram", mode), ("wave", mode)},
                    f"phase 55 {name}: the {label} grower launched {lc}")
        extra = pl["histogram"][mode] - ul["histogram"][mode]
        require(extra == counts["misses"]
                and pl["wave"][mode] == ul["wave"][mode],
                f"phase 55 {name}: {extra} more histogram launches for "
                f"{counts['misses']} misses (wave {pl['wave'][mode]} "
                f"against {ul['wave'][mode]})")
        add_launches(launches, ul)
        add_launches(launches, pl)
        cases[name] = {"mode": mode, "leaves": want["num_leaves"],
                       "slots": slots, **counts,
                       "histogram_launches_unpooled": ul["histogram"][mode],
                       "histogram_launches_pooled": pl["histogram"][mode],
                       "wave_launches": pl["wave"][mode],
                       "unpooled_s": us, "pooled_s": ps}
    emit({"phase": "pool_growers_equal", "rows": nt,
          "features": int(bins.shape[1]), "leaf_batch": POOL_LEAF_BATCH,
          "cases": cases})
    return launches


def pool_training_phase(dev, fix, rows, ds, rec10):
    """56. Training at the bench config (``bench_auc.json`` plus
    ``tpu_leaf_batch`` 16) with ``histogram_pool_size`` 0: f32 for the
    fixture's 100 iterations, the holdout AUC within phase 10's 1e-3 of
    genuine LightGBM's (a rebuilt parent is a fresh float32 sum where the
    unpooled grower subtracts, so the trees may part from phase 10's),
    s/iteration beside phase 10's, misses and histogram launches per
    iteration; quantized, POOL_QUANT_ITERS iterations pooled and unpooled:
    the model text byte for byte but for the line recording the pool.
    Returns launches by mode."""
    launches = {}
    bst, _p, rec = train_phase(
        dev, fix, rows, "train_pooled_f32", {"histogram_pool_size": 0}, ds,
        "f32", "f32", ref=(fix["ref_auc"], 1e-3))
    counts = dict(bst._gbdt.grow.pool_counts)
    iters = rec["iterations"]
    require(counts["misses"] > 0, "phase 56: no pool miss in training")
    add_launches(launches, {"histogram": {"f32": rec["histogram_launches"]},
                            "wave": {"f32": rec["wave_launches"]}})
    texts = {}
    for name, extra in (("pooled", {"histogram_pool_size": 0}),
                        ("unpooled", {})):
        qb, _p, qrec = train_phase(
            dev, fix, rows, f"train_{name}_quantized",
            dict(extra, use_quantized_grad=True), ds, "int8", "int8",
            iters=POOL_QUANT_ITERS)
        texts[name] = qb.model_to_string()
        if name == "pooled":
            q_misses = qb._gbdt.grow.pool_counts["misses"]
        add_launches(launches,
                     {"histogram": {"int8": qrec["histogram_launches"]},
                      "wave": {"int8": qrec["wave_launches"]}})
    require(q_misses > 0, "phase 56: no pool miss in quantized training")
    require(drop_param(texts["pooled"], "[histogram_pool_size: 0]")
            == texts["unpooled"], "phase 56: the pooled quantized model "
            "text differs from the unpooled one")
    emit({"phase": "pool_training", "iterations": iters,
          "holdout_auc": rec["holdout_auc"], "ref_auc": fix["ref_auc"],
          "auc_gap": rec["holdout_auc"] - fix["ref_auc"],
          "phase10_holdout_auc": rec10["holdout_auc"],
          "s_per_iteration": rec["s_per_iteration"],
          "phase10_s_per_iteration": rec10["s_per_iteration"],
          "misses_per_iteration": counts["misses"] / iters,
          "evictions_per_iteration": counts["evictions"] / iters,
          "hits_per_iteration": counts["hits"] / iters,
          "histogram_launches_per_iteration":
              rec["histogram_launches_per_iteration"],
          "phase10_histogram_launches_per_iteration":
              rec10["histogram_launches_per_iteration"],
          "quantized_iterations": POOL_QUANT_ITERS,
          "quantized_misses_per_iteration": q_misses / POOL_QUANT_ITERS,
          "quantized_text_equal": True})
    return launches


def epsilon_phase(gen, dev):
    """57. Epsilon's width (EPS_PARAMS: 2,000 dense features, max_bin
    255, 255 leaves) at EPS_ROWS rows and ``tpu_leaf_batch`` 16: uint8
    bins drawn on the card from the seed, a label read off three columns
    plus noise, exact-sum gradients that follow it.  One tree each from
    the unpooled untiled grower (``tpu_split_tile`` 1), the unpooled
    grower in 128-wide blocks (EPS_TILE: 16 blocks) and the pooled one
    at auto (its root scan untiled on the card: ``block_width``) with
    ``histogram_pool_size`` EPS_POOL_MB (its slots floored at 2W + 1):
    trees and ``row_leaf`` bit for bit across the three, and
    the pooled grower's peak device memory at least EPS_PEAK_DROP below
    the unpooled ones'.  Returns launches by mode."""
    import torch
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.gbdt import _split_config
    from lightgbm_tpu_torch.models.grower import GrowerConfig, make_grower
    from lightgbm_tpu_torch.ops.split import block_width
    n, f, b = EPS_ROWS, EPS_FEATURES, EPS_PARAMS["max_bin"]
    bins = torch.randint(0, b, (n, f), generator=gen, device=dev,
                         dtype=torch.uint8)
    z = (bins[:, 0].float() + bins[:, 1].float() - bins[:, 2].float()
         + 64.0 * torch.randn(n, generator=gen, device=dev))
    grad = 0.5 - (z > 127.0).float()
    hess = torch.full((n,), 0.25, device=dev)
    meta = (torch.full((f,), b, dtype=torch.int32, device=dev),
            torch.full((f,), b, dtype=torch.int32, device=dev),
            torch.zeros(f, dtype=torch.bool, device=dev))
    launches, runs = {}, {}
    want = None
    for name, tile, pool in (("unpooled_untiled", 1, -1.0),
                             ("unpooled_tiled", EPS_TILE, -1.0),
                             ("pooled_auto", 0, EPS_POOL_MB)):
        split = _split_config(Config(dict(EPS_PARAMS, tpu_split_tile=tile)))
        grower = make_grower(GrowerConfig(
            num_leaves=EPS_PARAMS["num_leaves"], num_bins=b, split=split,
            leaf_batch=POOL_LEAF_BATCH, histogram_pool_size=pool))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        data_bytes = torch.cuda.memory_allocated()
        got, lc, secs = grow_once(grower, bins, grad, hess, meta)
        peak = torch.cuda.max_memory_allocated()
        add_launches(launches, lc)
        if want is None:
            want = got
        require(same_tree(want, got), f"phase 57 {name}: the tree differs "
                "from the unpooled untiled grower's")
        width = block_width(split, 1, f, b, cuda=True)
        runs[name] = {"root_scan_blocks": -(-f // (width or f)),
                      "slots": grower.pool_slots(f), "seconds": secs,
                      "peak_allocated_bytes": peak,
                      "peak_above_data_bytes": peak - data_bytes,
                      "launches": {k: {md: v for md, v in lc[k].items() if v}
                                   for k in lc},
                      **grower.pool_counts}
        del grower
    leaves = want["num_leaves"]
    require(leaves > runs["pooled_auto"]["slots"],
            f"phase 57: {leaves} leaves fit the pool")
    drop = min(runs[k]["peak_allocated_bytes"] for k in
               ("unpooled_untiled", "unpooled_tiled")) \
        - runs["pooled_auto"]["peak_allocated_bytes"]
    require(drop >= EPS_PEAK_DROP, f"phase 57: the pool lowered the peak "
            f"by {drop} bytes, not {EPS_PEAK_DROP}")
    emit({"phase": "epsilon_pool_tiles", "rows": n, "features": f,
          "bins": b, "leaves": leaves, "trees_equal": True,
          "full_residency_bytes": EPS_PARAMS["num_leaves"] * f * b * 12,
          "pool_bytes": runs["pooled_auto"]["slots"] * f * b * 12,
          "peak_drop_bytes": drop, "peak_drop_bar": EPS_PEAK_DROP,
          "runs": runs})
    return launches


def tile_efb_phase(dev, s16):
    """58. The tiled scan on phase 52's bundled data (660 features in
    feature space): TILE_ITERS iterations at the default (auto: on the
    card untiled below ``AUTO_TILE_BYTES``, as ``block_width`` reports
    for the wave's 2W children) and at ``tpu_split_tile`` EFB_TILE (6
    blocks) give the same model text but for the line recording the
    option, with the peak device memory of each; then one profiled
    iteration run (``profile_phase``) at EFB_TILE beside phase 54's at
    the default: ``grower/efb_scan`` and the whole iteration's host ms.
    Returns launches by mode."""
    import torch
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.split import block_width
    ds, params = s16["ds"], s16["params"]
    launches, runs, texts = {}, {}, {}
    for name, extra in (("default", {}),
                        ("tiled", {"tpu_split_tile": EFB_TILE})):
        prm = dict(params, **extra)
        _zero_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bst = lgt.train(prm, ds, TILE_ITERS, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        add_launches(launches, _read_launches())
        texts[name] = bst.model_to_string()
        gcfg = bst._gbdt.grower_cfg
        f = int(ds.construct().num_features)
        width = block_width(gcfg.split, 2 * gcfg.leaf_batch, f,
                            gcfg.num_bins, cuda=True)
        runs[name] = {"s_per_iteration": secs / TILE_ITERS,
                      "wave_scan_blocks": -(-f // (width or f)),
                      "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        del bst
    require(runs["default"]["wave_scan_blocks"] == 1
            and runs["tiled"]["wave_scan_blocks"] > 1,
            f"phase 58: scan blocks {runs}")
    require(drop_param(texts["tiled"], f"[tpu_split_tile: {EFB_TILE}]")
            == texts["default"], "phase 58: the tiled EFB model text "
            "differs from the untiled one")
    prof = profile_phase(dict(params, tpu_split_tile=EFB_TILE), ds, dev)
    efb = "grower/efb_scan"
    for name, p in (("default", s16["profile"]), ("tiled", prof)):
        runs[name]["profile_efb_scan_ms_per_iteration"] = \
            p["range_host_ms_per_iteration"].get(efb, 0.0)
        runs[name]["profile_wall_ms_per_iteration"] = \
            p["wall_ms_per_iteration"]
        runs[name]["profile_device_busy_share"] = p["device_busy_share"]
    require(runs["tiled"]["profile_efb_scan_ms_per_iteration"] > 0,
            "phase 58: the profiler saw no grower/efb_scan range")
    emit({**prof, "training": "efb_f32_tiled"})
    emit({"phase": "tile_efb", "iterations": TILE_ITERS, "text_equal": True,
          "features": f, "tile": EFB_TILE, "runs": runs})
    return launches


def slice17_phases(gen, dev, fix, rows, ds, rec10, s16):
    """55-58: the histogram pool and the tiled scan.  Returns the
    launches of each kernel mode on these paths."""
    t0 = time.perf_counter()
    launches = {}
    for part in (pool_grower_phase(dev, fix, rows, ds),
                 pool_training_phase(dev, fix, rows, ds, rec10),
                 epsilon_phase(gen, dev),
                 tile_efb_phase(dev, s16)):
        for mode, counts in part.items():
            lm = launches.setdefault(mode, {"histogram": 0, "wave": 0})
            for kernel, n in counts.items():
                lm[kernel] += n
    emit({"phase": "slice17", "seconds": time.perf_counter() - t0,
          "launches": launches})
    return launches


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the data and the random weights")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lightgbm_tpu_torch import Predictor, bin_dataset, model_from_arrays
    from lightgbm_tpu_torch.models.tree import (_ensemble_sum_q, pack_nbytes,
                                                quantize_stack_trees)
    from lightgbm_tpu_torch.ops import _build, traverse
    from lightgbm_tpu_torch.serve.device_binning import (bin_rows_device,
                                                         build_bin_tables,
                                                         float_bits)
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    rng = np.random.RandomState(args.seed)

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    _build.load_library()
    info = _build.build_info
    emit({"phase": "build", "seconds": info["seconds"],
          "built": info["built"], "sources": info["sources"],
          "ptxas": [ln.strip() for ln in info["ptxas"].splitlines()
                    if ln.strip()]})

    # 3. models
    t0 = time.perf_counter()
    X, _y = make_higgs_like(200_000, 28, args.seed)
    X = X.astype(np.float64)
    X[rng.rand(*X.shape) < 0.02] = np.nan
    binned = bin_dataset(X, max_bin=255)
    state = random_model_state(rng, binned, 500, 255)
    model = model_from_arrays(state)
    Xc = categorical_data(rng, 20_000)
    binned_c = bin_dataset(Xc, max_bin=255, categorical_features=[1, 4])
    model_c = model_from_arrays(
        random_model_state(rng, binned_c, 50, 31, cat_features=(1, 4)))
    models = {"full": (model, binned, X), "categorical": (model_c, binned_c,
                                                          Xc)}
    packs = {}
    for name, (mdl, bnd, _x) in models.items():
        trees = mdl.host_trees()[0]
        for mode in ("int16", "int8"):
            packs[name, mode] = quantize_stack_trees(
                trees, mdl.cfg.num_leaves, bnd.max_num_bins, mode, dev)
    full16 = packs["full", "int16"]
    emit({"phase": "model", "seconds": time.perf_counter() - t0,
          "rows": int(X.shape[0]), "features": int(X.shape[1]),
          "max_num_bins": int(binned.max_num_bins), "trees": 500,
          "leaves": 255, "depth": full16["depth"],
          "pack_bytes_int16": pack_nbytes(full16),
          "pack_bytes_int8": pack_nbytes(packs["full", "int8"]),
          "categorical_model": {"trees": 50, "leaves": 31,
                                "categorical_features": [1, 4]}})

    # 4. kernel vs plain version, bitwise
    checks = []
    for (name, mode), pack in packs.items():
        _mdl, bnd, xs = models[name]
        nanb = torch.as_tensor(bnd.nan_bins, dtype=torch.int32, device=dev)
        for n in (1, 33, 4096, 65536):
            idx = rng.randint(0, xs.shape[0], n)
            bins = torch.from_numpy(bnd.apply(xs[idx]).astype(np.int32)).to(
                dev)
            got = traverse.fused_class_sums(pack, bins, nanb)
            want = _ensemble_sum_q(pack, bins, nanb)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"kernel != plain version: {name} {mode} N={n}")
            checks.append(f"{name}/{mode}/{n}")
    # slice 10: trees that push the redesigned kernel (categorical nodes,
    # single-leaf and chain trees, 5,000-leaf trees), rows staged in
    # shared memory and read from global memory
    nanb = torch.as_tensor(binned.nan_bins, dtype=torch.int32, device=dev)
    min_trees = traverse.ROW_STAGE_MIN_TREES
    for trees_n, leaves in EDGE_PACKS:
        trees = edge_case_trees(rng, binned.num_bins_per_feature,
                                binned.max_num_bins, (1, 4), trees_n,
                                leaves)
        for mode in ("int16", "int8"):
            pack = quantize_stack_trees(trees, leaves, binned.max_num_bins,
                                        mode, dev)
            for stage in (True, False):
                traverse.ROW_STAGE_MIN_TREES = 1 if stage else 10 ** 9
                for n in (1, 33, 4096, 65536):
                    idx = rng.randint(0, X.shape[0], n)
                    bins = torch.from_numpy(binned.apply(X[idx]).astype(
                        np.int32)).to(dev)
                    got = traverse.fused_class_sums(pack, bins, nanb)
                    want = _ensemble_sum_q(pack, bins, nanb)
                    torch.cuda.synchronize()
                    tag = (f"edge {trees_n}x{leaves}/{mode}/"
                           f"{'staged' if stage else 'global'}/{n}")
                    require(torch.equal(got, want),
                            f"kernel != plain version: {tag}")
                    checks.append(tag)
    traverse.ROW_STAGE_MIN_TREES = min_trees
    emit({"phase": "kernel_vs_plain", "bitwise": True, "cases": checks})

    # 5. device binning vs host binning, bitwise
    zam_x = rng.randn(20_000, 3)
    zam_x[rng.rand(20_000, 3) < 0.3] = 0.0
    binned_z = bin_dataset(zam_x, max_bin=255, zero_as_missing=True)
    cases = {}
    for name, (bnd, xs) in {"full": (binned, X), "categorical": (binned_c, Xc),
                            "zero_as_missing": (binned_z, zam_x)}.items():
        rows = device_binning_rows(bnd, xs, rng, 65_536)
        tables = build_bin_tables(bnd.mappers, dev)
        got = bin_rows_device(tables, torch.from_numpy(float_bits(rows)).to(
            dev)).cpu().numpy()
        want = bnd.apply(rows).astype(np.int32)
        require(np.array_equal(got, want),
                f"device binning != host binning ({name}): "
                f"{int((got != want).sum())} cells differ")
        cases[name] = int(rows.shape[0])
    emit({"phase": "device_binning", "bitwise": True, "rows": cases})

    # 6. serving through the entry points, one kernel launch per request
    pred = Predictor(model, quantize="int16", raw_score=True)
    pred_p = Predictor(model, quantize="int16")
    plan_pack = pred.plan._packs[0]
    scale = np.float32(plan_pack["scale"])
    nan_bins = binned.nan_bins
    requests = []
    traverse.launches = 0
    answers = []
    for n in (1, 7, 256, 4096, 65_536):
        rows = X[rng.randint(0, X.shape[0], n)]
        t1 = time.perf_counter()
        out = pred.predict(rows)
        requests.append({"rows": n, "ms": (time.perf_counter() - t1) * 1e3})
        answers.append((rows, out))
    rows_p = X[rng.randint(0, X.shape[0], 4096)]
    t1 = time.perf_counter()
    prob = pred_p.predict(rows_p)
    requests.append({"rows": 4096, "ms": (time.perf_counter() - t1) * 1e3,
                     "transformed": True})
    torch.cuda.synchronize()
    serve_launches = traverse.launches
    require(serve_launches == len(requests),
            f"{serve_launches} kernel launches for {len(requests)} requests")
    init = model.init_scores[0]
    for rows, out in answers:
        acc, _ = walk_pack_numpy(plan_pack, binned.apply(rows), nan_bins)
        want = (acc.astype(np.int32).astype(np.float32) * scale).astype(
            np.float64) + init
        require(out.shape == want.shape and np.array_equal(out, want),
                f"served raw scores != numpy walk at N={rows.shape[0]}")
    acc, _ = walk_pack_numpy(plan_pack, binned.apply(rows_p), nan_bins)
    raw32 = ((acc.astype(np.int32).astype(np.float32) * scale).astype(
        np.float64) + init).astype(np.float32)
    want_p = 1.0 / (1.0 + np.exp(-raw32))
    err_p = float(np.abs(prob - want_p).max())
    require(err_p <= 1e-6, f"served probabilities off by {err_p}")
    emit({"phase": "serve", "requests": requests, "launches": serve_launches,
          "raw_bitwise": True, "prob_max_abs_err": err_p,
          "metrics": pred.metrics_snapshot()})

    # 7. timing at the serving shape: int16 and int8 packs, 1 row to bulk
    timing = {}
    pack_bytes = pack_nbytes(full16)
    nanb = torch.as_tensor(nan_bins, dtype=torch.int32, device=dev)
    host_bins = binned.apply(X).astype(np.int32)
    # one row draw a size for both packs: they hold the same trees, so the
    # numpy walk's node visits are counted once
    draws = {n: rng.randint(0, X.shape[0], n) for n in TRAVERSE_TIMING_ROWS}
    visits_at = {}
    for mode in ("int16", "int8"):
        pack = packs["full", mode]
        for n in TRAVERSE_TIMING_ROWS:
            idx = draws[n]
            bins = torch.from_numpy(host_bins[idx]).to(dev)
            fn = lambda: traverse.fused_class_sums(pack, bins, nanb)
            nbytes = traverse_bytes(pack, bins)
            entry = {"kernel_ms": cuda_time_ms(
                fn, iters=20 if n <= 65_536 else 5), "bytes": nbytes,
                "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "device_ms": named_kernel_ms(
                    fn, "traverse", iters=10 if n <= 65_536 else 3)}
            if n <= 65_536:
                if n not in visits_at:
                    visits_at[n] = walk_pack_numpy(pack, host_bins[idx],
                                                   nan_bins)[1]
                visits = visits_at[n]
                entry["node_visits"] = visits
                entry["ops_ms"] = visits / SCALAR_OPS_PER_S * 1e3
            if n == 65_536:
                # the plain walk takes ~5 s a call: timed once for the
                # int16 pack (the kernels line), checked for both
                t_plain = time.perf_counter()
                plain = _ensemble_sum_q(pack, bins, nanb)
                torch.cuda.synchronize()
                if mode == "int16":
                    entry["plain_ms"] = (time.perf_counter() - t_plain) * 1e3
                entry["max_abs_err"] = int((fn() - plain).abs().max())
            timing[str(n) if mode == "int16" else f"{mode}/{n}"] = entry
    emit({"phase": "timing", "trees": 500, "leaves": 255, "features": 28,
          "pack_bytes": pack_bytes, "launches_per_request": 1,
          "nvidia_smi": smi, "shapes": timing,
          "request_breakdown_ms": request_breakdown(pred, X, rng)})

    t65 = timing["65536"]
    kernels = [{
        "name": "traverse", "route": "cuda", "source": TRAVERSE_SOURCE,
        "replaces": TRAVERSE_REPLACES, "matches_plain": True,
        "launches": serve_launches, "max_abs_err": t65["max_abs_err"],
        "ms": t65["kernel_ms"], "plain_ms": t65["plain_ms"],
        "bound_ms": max(t65["bytes_ms"], t65["ops_ms"]),
        "bound_by": ("bytes" if t65["bytes_ms"] >= t65["ops_ms"]
                     else "operations"),
        "library_ms": None, "rows": 65_536}]
    entries, obj_serve, ranker_launches, cat_launches, efb_launches = \
        training_phases(args.seed, dev, smi)
    # the traversal's launches serving phase 35's 4-class model
    kernels[0]["objective_launches"] = obj_serve["launches_per_request"] * 2
    # and phase 46's ranker
    require(ranker_launches > 0, "traverse: no launch serving the ranker")
    kernels[0]["slice13_launches"] = ranker_launches
    # and phase 50's categorical request
    require(cat_launches > 0, "traverse: no launch serving phase 48's model")
    kernels[0]["slice15_launches"] = cat_launches
    # and phase 54's bundled model
    require(efb_launches > 0, "traverse: no launch serving phase 52's model")
    kernels[0]["slice16_launches"] = efb_launches
    # slice 17 serves nothing: a pooled model is served as any model
    kernels[0]["slice17_launches"] = 0
    kernels += entries
    emit({"kernels": kernels})
    print(f"wall_s={time.perf_counter() - t_start:.1f}", flush=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
