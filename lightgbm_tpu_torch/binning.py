"""Feature discretization: value -> bin mapping (host, numpy).

The port's copy of the JAX package's ``binning.py`` numpy path: the
greedy equal-count boundary search, the per-feature ``BinMapper``, sampled
``bin_dataset``, dense and CSC ingestion, and the flat-array mapper
encoding, per-feature bin budgets (``max_bin_by_feature``), forced bin
bounds (``forcedbins_filename``, :func:`load_forced_bins`) and exclusive
feature bundling (:func:`build_bundles`).  Mappers, bin matrices and
bundles are byte-for-byte those of the JAX package (pinned by
tests/test_torch_binning.py and tests/test_torch_efb.py).  The JAX package's threaded C++ fast path
(``native``) is not ported (ROADMAP A1b).

Conventions kept from the JAX package: bins are dense ``uint8``/``uint16``;
the NaN bin, when present, is the LAST bin of a feature; categorical bins
are ordered by descending category frequency, with rare/unseen/negative
categories in the last bin.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .utils.log import Log

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

_KZERO_LO, _KZERO_HI = -1e-35, 1e-35  # reference uses kZeroThreshold = 1e-35


@dataclasses.dataclass
class BinMapper:
    """Per-feature value->bin discretizer (reference ``bin.h:85``)."""

    num_bins: int
    missing_type: int
    is_categorical: bool
    # Numerical: inclusive upper bound of each *value* bin (excludes the NaN bin).
    upper_bounds: Optional[np.ndarray] = None
    # Categorical: category integer value per bin index.
    categories: Optional[np.ndarray] = None
    is_trivial: bool = False  # single-bin feature; carries no signal
    default_bin: int = 0      # bin of value 0.0

    @property
    def has_nan_bin(self) -> bool:
        return self.missing_type != MISSING_NONE

    @property
    def nan_bin(self) -> int:
        return self.num_bins - 1 if self.has_nan_bin else -1

    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized ValueToBin (reference ``bin.h:173``)."""
        v = np.asarray(values, dtype=np.float64)
        if self.is_categorical:
            cats = self.categories
            # Map category value -> bin by table lookup; unseen/negative -> last bin.
            out = np.full(v.shape, self.num_bins - 1, dtype=np.int32)
            vi = np.where(np.isfinite(v), v, -1).astype(np.int64)
            lut_size = int(cats.max()) + 1 if cats.size else 1
            lut = np.full(lut_size, self.num_bins - 1, dtype=np.int32)
            lut[cats] = np.arange(len(cats), dtype=np.int32)
            in_range = (vi >= 0) & (vi < lut_size)
            out[in_range] = lut[vi[in_range]]
            return out
        n_value_bins = self.num_bins - (1 if self.has_nan_bin else 0)
        if self.missing_type == MISSING_ZERO:
            v = np.where((v > _KZERO_LO) & (v < _KZERO_HI), np.nan, v)
        # bin b holds values <= upper_bounds[b]; clip overflow into last value bin.
        bins = np.searchsorted(self.upper_bounds[: n_value_bins - 1], v,
                               side="left").astype(np.int32)
        if self.has_nan_bin:
            bins = np.where(np.isnan(v), self.nan_bin, bins)
        else:
            bins = np.where(np.isnan(v), 0, bins)
        return bins


def _greedy_find_boundaries(
    distinct: np.ndarray,
    counts: np.ndarray,
    max_bins: int,
    total_cnt: int,
    min_data_in_bin: int,
) -> List[float]:
    """Greedy equal-count boundary search (reference ``bin.cpp`` GreedyFindBin).

    Walks distinct values accumulating counts; closes a bin once it holds at least
    ``max(mean_size, min_data_in_bin)`` samples, re-estimating the mean from the
    remainder.  Heavy hitters (count >= mean) always get their own bin.
    """
    n = len(distinct)
    if n == 0:
        return [np.inf]
    if n <= max_bins:
        # Every distinct value gets a bin; boundary = midpoint to next value.
        bounds = [(distinct[i] + distinct[i + 1]) / 2.0 for i in range(n - 1)]
        bounds.append(np.inf)
        return bounds
    bounds: List[float] = []
    rest_cnt = total_cnt
    rest_bins = max_bins
    cur = 0
    i = 0
    while i < n:
        mean_size = rest_cnt / max(rest_bins, 1)
        target = max(mean_size, float(min_data_in_bin))
        cur += counts[i]
        rest_cnt -= counts[i]
        # Close the bin if full, or if the remaining values just fit remaining bins.
        if cur >= target or (n - i - 1) <= (rest_bins - 1 - len(bounds) - 1):
            if i + 1 < n:
                bounds.append((distinct[i] + distinct[i + 1]) / 2.0)
            cur = 0
            rest_bins -= 1
            if len(bounds) >= max_bins - 1:
                break
        i += 1
    bounds.append(np.inf)
    return bounds


def load_forced_bins(path: str, num_features: int,
                     categorical: Sequence[int] = ()) -> Optional[dict]:
    """Parse a forcedbins_filename JSON file into {feature: [bounds]}
    (reference ``DatasetLoader::GetForcedBins``, dataset_loader.cpp:1493:
    array of {"feature": i, "bin_upper_bound": [...]}; categorical
    features are warned and skipped; missing file warns and is ignored)."""
    if not path:
        return None
    import json
    try:
        with open(path) as fh:
            spec = json.load(fh)
    except OSError:
        Log.warning(f"Could not open {path}. Will ignore.")
        return None
    cats = set(int(c) for c in categorical)
    out: dict = {}
    for entry in spec:
        fi = int(entry["feature"])
        if fi >= num_features:
            raise ValueError(
                f"forced bins feature {fi} out of range ({num_features})")
        if fi in cats:
            Log.warning(f"Feature {fi} is categorical. Will ignore forced "
                        "bins for this feature.")
            continue
        out[fi] = [float(b) for b in entry["bin_upper_bound"]]
    return out or None


def _bounds_with_forced(distinct, counts, max_bins, total_cnt,
                        min_data_in_bin, forced) -> List[float]:
    """Bin boundaries honoring user-forced upper bounds (reference
    ``FindBinWithPredefinedBin``, bin.cpp:157): the forced bounds become
    boundaries first, then each segment between them gets a greedy-
    equal-count refill proportional to its sample mass, the last segment
    absorbing the remaining budget.

    Forced bounds within ``kZeroThreshold`` (1e-35) of zero are dropped,
    as the reference skips any ``|bound| <= kZeroThreshold``.  As in the
    JAX package (and its ``_greedy_find_boundaries``), the reference's own
    implicit boundaries at +-kZeroThreshold are not added."""
    forced = sorted({float(b) for b in forced
                     if np.isfinite(b) and not (_KZERO_LO <= b <= _KZERO_HI)})
    bounds = forced[: max(max_bins - 1, 0)] + [np.inf]
    free_bins = max_bins - len(bounds)
    to_add: List[float] = []
    vi = 0
    for i, ub in enumerate(bounds):
        seg_start = vi
        cnt_in_bin = 0
        while vi < len(distinct) and distinct[vi] < ub:
            cnt_in_bin += int(counts[vi])
            vi += 1
        remaining = free_bins - len(to_add)
        if i == len(bounds) - 1:
            num_sub = remaining + 1
        else:
            num_sub = min(int(round(cnt_in_bin * free_bins
                                    / max(total_cnt, 1))), remaining) + 1
        if num_sub > 1 and vi > seg_start:
            sub = _greedy_find_boundaries(
                distinct[seg_start:vi], counts[seg_start:vi], num_sub,
                cnt_in_bin, min_data_in_bin)
            to_add.extend(sub[:-1])   # last sub-bound is +inf
    return sorted(bounds[:-1] + to_add) + [np.inf]


def find_bin(
    sample_values: np.ndarray,
    max_bin: int,
    min_data_in_bin: int = 3,
    *,
    is_categorical: bool = False,
    use_missing: bool = True,
    zero_as_missing: bool = False,
    min_data_per_category: int = 1,
    forced_upper_bounds: Optional[Sequence[float]] = None,
) -> BinMapper:
    """Construct a :class:`BinMapper` from sampled values (reference
    ``FindBin``); ``forced_upper_bounds`` are kept as boundaries
    (``forcedbins_filename``)."""
    v = np.asarray(sample_values, dtype=np.float64).ravel()
    na_mask = np.isnan(v)
    if zero_as_missing:
        na_mask = na_mask | ((v > _KZERO_LO) & (v < _KZERO_HI))
    num_na = int(na_mask.sum())
    vv = v[~na_mask]

    if is_categorical:
        cats_f = vv[vv >= 0]
        cats, counts = np.unique(cats_f.astype(np.int64), return_counts=True)
        order = np.argsort(-counts, kind="stable")
        cats, counts = cats[order], counts[order]
        keep = counts >= min_data_per_category
        if keep.any():
            cats, counts = cats[keep], counts[keep]
        cats = cats[: max_bin - 1] if len(cats) >= max_bin else cats
        num_bins = len(cats) + 1  # final bin: rare/unseen/missing
        if num_bins < 2:
            return BinMapper(num_bins=1, missing_type=MISSING_NONE,
                             is_categorical=True, categories=cats.astype(np.int64),
                             is_trivial=True)
        return BinMapper(
            num_bins=num_bins,
            missing_type=MISSING_NAN if (use_missing and num_na > 0) else MISSING_NONE,
            is_categorical=True,
            categories=cats.astype(np.int64),
        )

    missing_type = MISSING_NONE
    if use_missing and zero_as_missing and num_na > 0:
        missing_type = MISSING_ZERO
    elif use_missing and num_na > 0:
        missing_type = MISSING_NAN

    has_nan_bin = missing_type != MISSING_NONE
    max_value_bins = max_bin - (1 if has_nan_bin else 0)
    distinct, counts = np.unique(vv, return_counts=True)
    if forced_upper_bounds:
        bounds = _bounds_with_forced(distinct, counts, max_value_bins,
                                     len(vv), min_data_in_bin,
                                     forced_upper_bounds)
    else:
        bounds = _greedy_find_boundaries(distinct, counts, max_value_bins,
                                         len(vv), min_data_in_bin)
    num_bins = len(bounds) + (1 if has_nan_bin else 0)
    trivial = num_bins <= 1 or (len(distinct) <= 1 and not has_nan_bin)
    ub = np.asarray(bounds, dtype=np.float64)
    default_bin = int(np.searchsorted(ub[:-1], 0.0, side="left")) if len(ub) else 0
    return BinMapper(
        num_bins=max(num_bins, 1),
        missing_type=missing_type,
        is_categorical=False,
        upper_bounds=ub,
        is_trivial=trivial,
        default_bin=default_bin,
    )


def _is_sparse(X) -> bool:
    return hasattr(X, "tocsc") and hasattr(X, "tocsr")


def bin_dataset(
    X: np.ndarray,
    max_bin: int = 255,
    min_data_in_bin: int = 3,
    categorical_features: Sequence[int] = (),
    *,
    use_missing: bool = True,
    zero_as_missing: bool = False,
    sample_cnt: int = 200000,
    random_state: int = 1,
    max_bin_by_feature: Optional[Sequence[int]] = None,
    forced_bins: Optional[dict] = None,
) -> "BinnedData":
    """Bin a full feature matrix: bin boundaries come from a row subsample
    (reference ``DatasetLoader::SampleTextDataFromFile``), then the full
    matrix is discretized.  scipy sparse inputs are binned column-wise
    straight from CSC, never densified.  ``max_bin_by_feature`` gives each
    feature its own bin budget; ``forced_bins`` ({feature: bounds}, from
    :func:`load_forced_bins`) its forced upper bounds."""
    sparse = _is_sparse(X)
    if not sparse:
        X = np.asarray(X)
    n, f = X.shape
    if n > sample_cnt:
        rng = np.random.RandomState(random_state)
        idx = rng.choice(n, size=sample_cnt, replace=False)
        sample = X[idx] if not sparse else X.tocsr()[np.sort(idx)]
    else:
        sample = X
    if sparse:
        sample = sample.tocsc()
    cat_set = set(int(c) for c in categorical_features)
    if max_bin_by_feature is not None:
        # reference CHECKs length == num features and every value > 1
        if len(max_bin_by_feature) != f:
            raise ValueError(
                f"max_bin_by_feature has {len(max_bin_by_feature)} entries "
                f"for {f} features (reference requires an exact match)")
        if any(int(v) <= 1 for v in max_bin_by_feature):
            raise ValueError("max_bin_by_feature values must be > 1")
    mappers: List[BinMapper] = []
    s = sample.shape[0]
    all_nan_cols: List[int] = []
    for j in range(f):
        mb = (max_bin if max_bin_by_feature is None
              else int(max_bin_by_feature[j]))
        if sparse:
            nz = np.asarray(sample.data[sample.indptr[j]:
                                        sample.indptr[j + 1]], np.float64)
            col = np.zeros(s, np.float64)
            col[: len(nz)] = nz       # find_bin is order-invariant
        else:
            col = sample[:, j]
        if (j not in cat_set and s
                and bool(np.isnan(np.asarray(col, np.float64)).all())):
            all_nan_cols.append(j)
        mappers.append(find_bin(
            col, mb, min_data_in_bin, is_categorical=(j in cat_set),
            use_missing=use_missing, zero_as_missing=zero_as_missing,
            forced_upper_bounds=(forced_bins or {}).get(j)))
    const_cols = [j for j, m in enumerate(mappers)
                  if m.is_trivial and j not in all_nan_cols]
    if all_nan_cols:
        Log.warning(
            f"{len(all_nan_cols)} feature column(s) are entirely NaN "
            f"in the binning sample (e.g. {all_nan_cols[:8]}); they "
            "can never split")
    if const_cols:
        Log.warning(
            f"{len(const_cols)} feature column(s) are constant "
            f"(e.g. {const_cols[:8]}); they can never split")
    return BinnedData.from_mappers(X, mappers)


def _bin_sparse_matrix(X, mappers: List[BinMapper], dtype) -> np.ndarray:
    """Bin a scipy sparse matrix column-wise without densifying: every
    column starts at its zero-value bin, then only the nonzeros are
    discretized and scattered.  Peak extra memory is O(nnz)."""
    csc = X.tocsc()
    n, f = csc.shape
    out = np.empty((n, f), dtype=dtype)
    zero = np.zeros(1, np.float64)
    for j, m in enumerate(mappers):
        out[:, j] = m.value_to_bin(zero)[0]
        lo, hi = csc.indptr[j], csc.indptr[j + 1]
        if hi > lo:
            out[csc.indices[lo:hi], j] = m.value_to_bin(
                np.asarray(csc.data[lo:hi], np.float64)).astype(dtype)
    return out


def _bin_full_matrix(X, mappers: List[BinMapper], dtype) -> np.ndarray:
    """Bin every column with its mapper (dense or CSC input)."""
    if _is_sparse(X):
        return _bin_sparse_matrix(X, mappers, dtype)
    X = np.asarray(X)
    n, f = X.shape
    out = np.empty((n, f), dtype=dtype)
    for j, m in enumerate(mappers):
        out[:, j] = m.value_to_bin(X[:, j]).astype(dtype)
    return out


@dataclasses.dataclass
class BinnedData:
    """Dense binned matrix + per-feature metadata."""

    bins: np.ndarray                 # (N, F) uint8/uint16
    mappers: List[BinMapper]
    max_num_bins: int                # B: padded bin axis
    upper_bounds_padded: np.ndarray  # (F, B) f32: threshold per (feature, bin)
    nan_bins: np.ndarray             # (F,) int32: NaN bin index or B (none)
    num_bins_per_feature: np.ndarray  # (F,) int32
    is_categorical: np.ndarray       # (F,) bool

    @classmethod
    def from_mappers(cls, X: np.ndarray, mappers: List[BinMapper]) -> "BinnedData":
        return cls.from_prebinned(
            _bin_full_matrix(X, mappers, bins_dtype(mappers)), mappers)

    @classmethod
    def from_prebinned(cls, bins: np.ndarray,
                       mappers: List[BinMapper]) -> "BinnedData":
        """Wrap an already-binned matrix (or an empty (0, F) one, as a
        model carried across without its training rows does)."""
        f = len(mappers)
        max_b = max(max(m.num_bins for m in mappers), 2)
        ub = np.full((f, max_b), np.inf, dtype=np.float32)
        nan_bins = np.full(f, max_b, dtype=np.int32)
        nbpf = np.empty(f, dtype=np.int32)
        is_cat = np.zeros(f, dtype=bool)
        for j, m in enumerate(mappers):
            nbpf[j] = m.num_bins
            is_cat[j] = m.is_categorical
            if m.is_categorical:
                ub[j, : m.num_bins] = np.arange(m.num_bins, dtype=np.float32)
            elif m.upper_bounds is not None:
                k = len(m.upper_bounds)
                ub[j, :k] = m.upper_bounds.astype(np.float32)
            if m.has_nan_bin:
                nan_bins[j] = m.nan_bin
        return cls(
            bins=bins, mappers=mappers, max_num_bins=max_b,
            upper_bounds_padded=ub, nan_bins=nan_bins,
            num_bins_per_feature=nbpf, is_categorical=is_cat,
        )

    @property
    def num_data(self) -> int:
        return self.bins.shape[0]

    @property
    def num_features(self) -> int:
        return self.bins.shape[1]

    def apply(self, X) -> np.ndarray:
        """Bin new data with these mappers (dense arrays or scipy sparse,
        the latter straight from CSC)."""
        if _is_sparse(X):
            return _bin_sparse_matrix(X, self.mappers, self.bins.dtype)
        return _bin_full_matrix(np.asarray(X), self.mappers, self.bins.dtype)


def bins_dtype(mappers: List[BinMapper]):
    """Storage dtype of a bin matrix for these mappers."""
    max_b = max(max(m.num_bins for m in mappers), 2)
    return np.uint8 if max_b <= 256 else np.uint16


def mappers_to_arrays(mappers: List[BinMapper]) -> dict:
    """Flatten per-feature mappers into fixed arrays (the JAX package's
    binary-cache encoding; also the form a model is carried across in)."""
    f = len(mappers)
    num_bins = np.array([m.num_bins for m in mappers], np.int32)
    missing = np.array([m.missing_type for m in mappers], np.int32)
    is_cat = np.array([m.is_categorical for m in mappers], bool)
    trivial = np.array([m.is_trivial for m in mappers], bool)
    default_bin = np.array([m.default_bin for m in mappers], np.int32)
    ub_flat, ub_off = [], [0]
    cat_flat, cat_off = [], [0]
    for m in mappers:
        ub = m.upper_bounds if m.upper_bounds is not None else np.zeros(0)
        ub_flat.append(np.asarray(ub, np.float64))
        ub_off.append(ub_off[-1] + len(ub))
        cats = m.categories if m.categories is not None else np.zeros(0, np.int64)
        cat_flat.append(np.asarray(cats, np.int64))
        cat_off.append(cat_off[-1] + len(cats))
    return {
        "mapper_num_bins": num_bins, "mapper_missing": missing,
        "mapper_is_cat": is_cat, "mapper_trivial": trivial,
        "mapper_default_bin": default_bin,
        "mapper_ub": np.concatenate(ub_flat) if f else np.zeros(0),
        "mapper_ub_off": np.array(ub_off, np.int64),
        "mapper_cats": np.concatenate(cat_flat) if f else np.zeros(0, np.int64),
        "mapper_cat_off": np.array(cat_off, np.int64),
    }


@dataclasses.dataclass
class FeatureBundles:
    """Exclusive feature bundling (reference EFB: ``DatasetLoader::FindGroups``
    / ``FeatureGroup``), the JAX package's ``FeatureBundles``.

    Mutually (near-)exclusive sparse features share one histogram column:
    bundle bin 0 means "every member at its default"; member ``f``'s
    non-default bins ``1..nb_f-1`` occupy ``[offset_f, offset_f + nb_f - 2]``.
    Features that cannot bundle (categorical, a non-zero default bin, too
    many bins) ride along as identity singletons (``feat_offset == -1``).
    Histograms and row partitions run on the (N, G) bundled matrix; split
    scans, trees, model text and serving stay in the original feature
    space (``ops/bundle.py`` rebuilds each feature's histogram)."""

    feat_group: np.ndarray    # (F,) int32: bundle column of each feature
    feat_offset: np.ndarray   # (F,) int32: non-default-bin offset; -1 identity
    group_bins: np.ndarray    # (G,) int32: bins per bundle column
    bins: np.ndarray          # (N, G) bundled matrix, uint8 or uint16

    @property
    def num_groups(self) -> int:
        return len(self.group_bins)

    @property
    def max_group_bins(self) -> int:
        return int(self.group_bins.max()) if len(self.group_bins) else 1

    def bundle_row_matrix(self, bins: np.ndarray) -> np.ndarray:
        """Bundle an (N, F) original-bin matrix; where members conflict in
        a row, the last writer (the highest feature index) wins."""
        n = bins.shape[0]
        out = np.zeros((n, self.num_groups), dtype=self.bins.dtype)
        for f in range(len(self.feat_group)):
            g, off = int(self.feat_group[f]), int(self.feat_offset[f])
            col = bins[:, f]
            if off < 0:
                out[:, g] = col
            else:
                nz = col > 0
                out[nz, g] = (off + col[nz].astype(np.int32) - 1).astype(
                    out.dtype)
        return out


def _evict_conflicts(bins: np.ndarray, members: List[int],
                     full_budget: int) -> List[int]:
    """The full-matrix re-check of one bundle: while its rows hold more
    than ``(m - 1) * full_budget`` conflicts (a row with k non-default
    members counts k - 1), evict the member that takes part in the most
    conflicting rows (the first such member on ties).  Returns the
    evicted features in order; ``members`` keeps the rest.

    The (N, m) non-default matrix is built once; an eviction updates the
    per-row counts, and only the rows that conflicted at the start (a
    row's count only falls) are read again: the JAX package's
    recomputation, eviction for eviction, without its full pass each
    time."""
    nz_cols = bins[:, members] != 0                      # (N, m)
    row_nnz = nz_cols.sum(axis=1)
    rows = np.nonzero(row_nnz > 1)[0]
    sub = nz_cols[rows]                                  # (R, m)
    cnt = row_nnz[rows]
    alive = np.ones(len(members), bool)
    order = list(members)
    evicted = []
    while alive.sum() > 1:
        conflicts = int(np.maximum(cnt - 1, 0).sum())
        if conflicts <= (int(alive.sum()) - 1) * full_budget:
            break
        overlap = (sub & (cnt > 1)[:, None]).sum(axis=0)
        overlap = np.where(alive, overlap, -1)
        i = int(np.argmax(overlap))
        alive[i] = False
        cnt = cnt - sub[:, i]
        evicted.append(order[i])
    members[:] = [j for j, a in zip(order, alive) if a]
    return evicted


def build_bundles(binned: BinnedData, *, max_conflict_rate: float = 0.0,
                  sample_cnt: int = 20000, max_bundle_bins: int = 4096,
                  min_gain_cols: float = 0.75,
                  random_state: int = 3) -> Optional[FeatureBundles]:
    """Greedy conflict-bounded bundling (the EFB paper's Greedy Bundling,
    reference ``FindGroups``), the JAX package's ``build_bundles`` byte for
    byte: eligible features (numerical, default bin 0, at most
    ``max_bundle_bins - 1`` non-default bins) go sparsest first into the
    first bundle whose conflicts with them on a ``sample_cnt``-row sample
    stay within the budget; each multi-member bundle is re-checked on the
    full matrix (:func:`_evict_conflicts`).  Returns None when fewer than
    8 features, or when the columns would not fall to ``min_gain_cols *
    F`` or fewer (dense data)."""
    bins = binned.bins
    n, f = bins.shape
    if f < 8:
        return None
    eligible = np.array(
        [(not m.is_categorical) and m.default_bin == 0 and m.num_bins >= 2
         and m.num_bins - 1 <= max_bundle_bins - 1
         for m in binned.mappers])
    if n > sample_cnt:
        rng = np.random.RandomState(random_state)
        sample = bins[rng.choice(n, size=sample_cnt, replace=False)]
    else:
        sample = bins
    s = sample.shape[0]
    nz = sample != 0                                   # (S, F)
    budget = int(max_conflict_rate * s)
    nbpf = binned.num_bins_per_feature
    # greedy, sparsest first
    order = [int(j) for j in np.argsort(nz.sum(axis=0)) if eligible[j]]
    bundles: List[List[int]] = []
    bundle_nz: List[np.ndarray] = []
    bundle_bins: List[int] = []
    for j in order:
        extra = int(nbpf[j]) - 1
        placed = False
        for bi in range(len(bundles)):
            if bundle_bins[bi] + extra > max_bundle_bins:
                continue
            if int(np.count_nonzero(bundle_nz[bi] & nz[:, j])) <= budget:
                bundles[bi].append(j)
                bundle_nz[bi] |= nz[:, j]
                bundle_bins[bi] += extra
                placed = True
                break
        if not placed:
            bundles.append([j])
            bundle_nz.append(nz[:, j].copy())
            bundle_bins.append(1 + extra)
    # re-check each multi-member bundle on the full matrix (the sample only
    # bounded the conflicts in-sample); each evicted feature becomes a
    # bundle of its own
    full_budget = int(max_conflict_rate * n)
    if n > s:
        for bi in range(len(bundles)):
            if len(bundles[bi]) > 1:
                bundles += [[j] for j in _evict_conflicts(
                    bins, bundles[bi], full_budget)]
    n_single = f - sum(len(b) for b in bundles)
    if len(bundles) + n_single > min_gain_cols * f:
        return None
    feat_group = np.empty(f, np.int32)
    feat_offset = np.full(f, -1, np.int32)
    group_bins = []
    for bi, members in enumerate(bundles):
        off = 1
        for j in members:
            feat_group[j] = bi
            feat_offset[j] = off
            off += int(nbpf[j]) - 1
        group_bins.append(off)
    g = len(bundles)
    for j in range(f):
        if eligible[j]:
            continue
        feat_group[j] = g
        group_bins.append(int(nbpf[j]))
        g += 1
    dtype = np.uint8 if max(group_bins) <= 256 else np.uint16
    fb = FeatureBundles(feat_group=feat_group, feat_offset=feat_offset,
                        group_bins=np.asarray(group_bins, np.int32),
                        bins=np.zeros((0, len(group_bins)), dtype))
    fb.bins = fb.bundle_row_matrix(bins)
    return fb


def mappers_from_arrays(d: dict) -> List[BinMapper]:
    d = {k: np.asarray(d[k]) for k in (
        "mapper_num_bins", "mapper_missing", "mapper_is_cat",
        "mapper_trivial", "mapper_default_bin", "mapper_ub",
        "mapper_ub_off", "mapper_cats", "mapper_cat_off")}
    f = len(d["mapper_num_bins"])
    out: List[BinMapper] = []
    for j in range(f):
        is_cat = bool(d["mapper_is_cat"][j])
        lo, hi = int(d["mapper_ub_off"][j]), int(d["mapper_ub_off"][j + 1])
        clo, chi = int(d["mapper_cat_off"][j]), int(d["mapper_cat_off"][j + 1])
        out.append(BinMapper(
            num_bins=int(d["mapper_num_bins"][j]),
            missing_type=int(d["mapper_missing"][j]),
            is_categorical=is_cat,
            upper_bounds=None if is_cat else d["mapper_ub"][lo:hi],
            categories=d["mapper_cats"][clo:chi] if is_cat else None,
            is_trivial=bool(d["mapper_trivial"][j]),
            default_bin=int(d["mapper_default_bin"][j]),
        ))
    return out
