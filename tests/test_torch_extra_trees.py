"""``extra_trees`` and ``feature_fraction_bynode`` in the port, held to
the JAX package (``lightgbm_tpu/models/grower.py::_node_inputs`` /
``_batch_node_inputs``, ``ops/split.py``'s ``rand_bins``; its own tests
are tests/test_categorical_sorted.py's two, ported at the end):

- The scan: ``best_split_batch`` with per-child (K, F) feature masks and
  random bins, bit for bit the JAX ``best_split`` of each child, on
  exact-sum histograms with NaN bins, one-hot and sorted categoricals,
  draws on the NaN bin and on phantom bins, a child with every feature
  off, untiled and tiled, plain and under ``lambda_l1`` + ``path_smooth``.
- The wave kernel's plain version (``wave_plain``) with a node table:
  each child's payload bit for bit the JAX scan's; an all-(-1) table
  gives the payload of no table.
- The grower on exact-sum gradients with the draws injected on both
  sides (``jax.random.randint`` / ``uniform`` patched to return fixed
  tables cut to the asked shape, the port's ``_node_draws`` patched to
  the same tables; nothing in the JAX package is edited): trees and
  ``row_leaf`` bit for bit, on the wave layout (the fused step's plain
  version and the unfused step, W = 1, 4 and 16), the mask layout,
  quantized (deterministic rounding), EFB bundles, sorted categoricals,
  the histogram pool and the tiled scan.
- The node generator: seeded per (iteration, class); two trainings give
  equal text; the keep-at-least-one rule; ``extra_seed`` changes trees.

On the card (``cuda`` marker) the wave kernel with a node table equals
its plain version bit for bit in every mode, and the grower through the
kernels equals the CPU grower's trees.
"""

import numpy as np
import pytest
import torch

from torch_port_util import (assert_same_tree, cuda_device,  # noqa: F401
                             exact_grads, grown_data, jax_grow, port_grow,
                             pow2_scale_grads)

import lightgbm_tpu_torch as lgt
import lightgbm_tpu_torch.models.grower as PG
from lightgbm_tpu_torch.ops import split as S
from lightgbm_tpu_torch.ops import wave as WV
from lightgbm_tpu_torch.ops.histogram import histogram_segment
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)


# ---------------------------------------------------------------- the scan
#: numeric with a NaN bin, numeric, one-hot (4 bins), sorted with a rest
#: bin (24), sorted (12), sorted (20) masked out, numeric (16 bins)
B = 32
NBPF = np.array([16, 12, 4, 24, 12, 20, 16], np.int32)
NAN = np.array([15, 32, 32, 32, 32, 32, 32], np.int32)
IS_CAT = np.array([0, 0, 1, 1, 1, 1, 0], bool)
FMASK = np.array([1, 1, 1, 1, 1, 0, 1], bool)
SCAN_CASES = {
    "default": dict(min_data_in_leaf=1, min_data_per_group=5,
                    cat_smooth=1.0),
    "l1_path_smooth": dict(min_data_in_leaf=1, min_data_per_group=5,
                           path_smooth=3.0, lambda_l1=0.5, lambda_l2=1.0),
}


def _scan_hist(seed):
    """(F, B, 3) exact-sum histogram of one row set (every feature sums to
    the same totals); the sorted features carry a strong set signal."""
    rng = np.random.RandomState(seed)
    f = len(NBPF)
    cnt = rng.randint(0, 30, (f, B)).astype(np.float32)
    g = rng.randint(-10, 11, (f, B)).astype(np.float32) * 0.5
    g[3:6] *= 4.0
    hist = np.stack([g, cnt * 0.25, cnt], axis=-1)
    hist[np.arange(B)[None, :] >= NBPF[:, None]] = 0.0
    tot = hist[0].sum(axis=0)
    for j in range(1, f):
        hist[j, 0] += tot - hist[j].sum(axis=0)
    return hist, tot


def _child_inputs(k, seed):
    """(K, F) feature masks (the per-tree mask ANDed with a draw; child 2
    has every feature off) and random bins: child 0 draws feature 0's NaN
    bin, child 1 phantom bins (past a feature's bins), the rest draws
    below each feature's bins."""
    rng = np.random.RandomState(seed)
    f = len(NBPF)
    fm = FMASK[None, :] & (rng.rand(k, f) < 0.7)
    fm[2] = False
    rand = rng.randint(0, 1 << 30, (k, f)) % NBPF[None, :]
    rand[0, 0] = NAN[0]
    rand[1] = NBPF + np.arange(f) % 3
    return fm, rand.astype(np.int64)


def _jax_scan(hist, tot, fm, rand, kw, pout=None, sorted_=True, nbpf=NBPF):
    import jax.numpy as jnp

    from lightgbm_tpu.ops import split as JS
    return JS.best_split(
        jnp.asarray(hist), *(jnp.float32(v) for v in tot),
        num_bins_per_feature=jnp.asarray(nbpf), nan_bins=jnp.asarray(NAN),
        is_categorical=jnp.asarray(IS_CAT), monotone=None,
        feature_mask=jnp.asarray(fm),
        cfg=JS.SplitConfig(has_monotone=False, extra_trees=rand is not None,
                           scan_tile=1, use_sorted_categorical=sorted_,
                           **kw),
        parent_output=None if pout is None else jnp.float32(pout),
        rand_bins=None if rand is None else jnp.asarray(rand, jnp.int32))


def _assert_best_equal(got, want, k=None):
    for name in S.BestSplit._fields:
        a = getattr(got, name)
        np.testing.assert_array_equal(
            (a if k is None else a[k]).numpy(),
            np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_per_child_inputs_bitwise_vs_jax(case):
    """Five children, each with its own feature mask and random bins, in
    one ``best_split_batch`` (untiled and in 2-column blocks) against five
    untiled JAX ``best_split`` calls; tolerance: none.  The port's tiles
    give its untiled bits; the JAX package's own tiled scan (a compiled
    ``lax.map``) rounds some sorted ``path_smooth`` gains 1 ulp away from
    its untiled one, so the untiled scan is the reference."""
    kw = SCAN_CASES[case]
    k = 5
    hists, tots = zip(*(_scan_hist(s) for s in range(k)))
    fm, rand = _child_inputs(k, seed=len(case))
    pout = np.array([0.25, -0.5, 0.0, 0.125, -0.25], np.float32)
    args = (torch.from_numpy(np.stack(hists)),
            *(torch.tensor(np.array(v)) for v in zip(*tots)),
            torch.from_numpy(pout))
    meta = dict(num_bins_per_feature=torch.from_numpy(NBPF),
                nan_bins=torch.from_numpy(NAN),
                is_categorical=torch.from_numpy(IS_CAT))
    want = [_jax_scan(hists[c], tots[c], fm[c], rand[c], kw, pout[c])
            for c in range(k)]
    for tile in (1, 2):
        cfg = S.SplitConfig(scan_tile=tile, **kw)
        got = S.best_split_batch(*args, cfg=cfg,
                                 feature_mask=torch.from_numpy(fm),
                                 rand_bins=torch.from_numpy(rand), **meta)
        for c in range(k):
            _assert_best_equal(got, want[c], c)
        # a (K, F) copy of the per-tree mask with no random bins is the
        # per-tree scan, bit for bit
        rows = torch.from_numpy(FMASK).expand(k, -1)
        plain = [S.best_split_batch(*args, cfg=cfg, feature_mask=m, **meta)
                 for m in (rows, rows[0])]
        for field in S.BestSplit._fields:
            assert torch.equal(getattr(plain[0], field),
                               getattr(plain[1], field)), field
    assert float(got.gain[2]) == float("-inf")        # every feature off
    assert np.isfinite(got.gain.numpy()).sum() >= 2


# --------------------------------------------------------- wave_plain
def _wave_inputs(w, seed, n_per=300, dtype=np.uint8, int8=False):
    """A wave of ``w`` slots over exact-sum rows of the scan's meta, its
    categorical features cut to 4 bins (one-hot: the wave gives sorted
    ones no candidate): bins below each feature's bins, each slot's
    smaller sibling the first rows of its segment.  ``int8``: levels
    (gradients x 2, hessians x 4) under ``scale3`` [0.5, 0.25, 1]."""
    rng = np.random.RandomState(seed)
    f = len(NBPF)
    nbpf = np.where(IS_CAT & (NBPF > 4), 4, NBPF).astype(np.int32)
    n = w * n_per
    bins = (rng.rand(n, f) * nbpf[None, :]).astype(dtype)
    g, h = exact_grads(n, seed=seed)
    vals = torch.from_numpy(np.stack([g, h, np.ones(n, np.float32)], 1))
    bins_t = torch.from_numpy(bins)
    scale3 = None
    if int8:
        scale3 = torch.tensor([0.5, 0.25, 1.0])
        levels = (vals / scale3).to(torch.int8)
    perm = torch.arange(n, dtype=torch.int32)
    starts = [i * n_per for i in range(w)]
    small_cnt = [int(rng.randint(20, n_per // 2)) for _ in range(w)]
    hv = vals if scale3 is None else levels
    parent = torch.stack([histogram_segment(
        bins_t[s:s + n_per], hv[s:s + n_per], num_bins=B)
        for s in starts])
    small_left = rng.rand(w) < 0.5
    sums = []
    for i, s in enumerate(starts):
        sm = vals[s:s + small_cnt[i]].sum(0)
        bg = vals[s + small_cnt[i]:s + n_per].sum(0)
        sums.append((sm, bg) if small_left[i] else (bg, sm))
    st = lambda j: torch.stack([torch.stack([a[j], b[j]]) for a, b in sums])
    out = torch.tensor(rng.randn(w, 2).astype(np.float32) * 0.25)
    stats = WV.wave_stats(st(0), st(1), st(2), out,
                          torch.from_numpy(small_left),
                          torch.ones(w, dtype=torch.bool))
    meta = WV.wave_meta(torch.from_numpy(nbpf), torch.from_numpy(NAN),
                        torch.from_numpy(IS_CAT), torch.from_numpy(FMASK))
    return dict(bins=bins_t, vals=hv, perm=perm, small_start=starts,
                small_cnt=small_cnt, parent=parent, stats=stats, meta=meta,
                num_bins=B, scale3=scale3), nbpf


def _node_for(w, nbpf, seed):
    """A (W, 2, F) node table: per-child masks and random bins (one child
    with every feature off, draws on the NaN bin and phantom bins)."""
    fm, rand = _child_inputs(2 * w, seed)
    rand = np.where(rand < NBPF, rand % np.maximum(nbpf, 1), rand)
    rand[0, 0] = NAN[0]
    table = WV.node_table(torch.from_numpy(fm), torch.from_numpy(rand))
    return table.reshape(w, 2, -1).contiguous()


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_wave_plain_node_table_bitwise_vs_jax(case):
    """Each child's payload of ``wave_plain`` with a node table against
    the JAX ``best_split`` of that child's histogram under its mask and
    random bins (the sorted scan off: the wave gives such features no
    candidate); tolerance: none."""
    kw = SCAN_CASES[case]
    cfg = S.SplitConfig(**kw)
    inp, nbpf = _wave_inputs(3, seed=5)
    node = _node_for(3, nbpf, seed=6)
    hists, pay = WV.wave_plain(cfg=cfg, node=node, **inp)
    got = WV.payload_to_best(pay.reshape(6, -1))
    for w in range(3):
        for c in range(2):
            # no entry is -1 (every bin): each is off or one bin
            nd = node[w, c].numpy()
            st = inp["stats"][w, c].numpy()
            want = _jax_scan(hists[w, c].numpy(), st[:3],
                             FMASK & (nd != WV.NODE_OFF),
                             np.where(nd < 0, 0, nd), kw, st[3],
                             sorted_=False, nbpf=nbpf)
            _assert_best_equal(got, want, 2 * w + c)
    assert np.isfinite(got.gain.numpy()).sum() >= 2
    # an all-(-1) table is no table, bit for bit
    every = torch.full_like(node, WV.NODE_ALL)
    _, p_every = WV.wave_plain(cfg=cfg, node=every, **inp)
    _, p_none = WV.wave_plain(cfg=cfg, **inp)
    assert torch.equal(p_every, p_none)


# -------------------------------------------------------------- the grower
def _draw_tables(f, seed=11):
    """Fixed draws: (32, F) ints in [0, 2**30) and float32 uniforms; rows
    1 and 5 sample no feature at fraction 0.5 (the keep-at-least-one
    rule)."""
    rng = np.random.RandomState(seed)
    ints = rng.randint(0, 1 << 30, (32, f)).astype(np.int64)
    unif = rng.rand(32, f).astype(np.float32)
    unif[[1, 5]] = np.float32(0.9)
    return ints, unif


@pytest.fixture
def injected(monkeypatch):
    """Patch both packages' draws to fixed tables cut to the asked shape:
    ``jax.random.randint`` / ``uniform`` (every call inside the JAX
    grower's trace returns the same rows) and the port's
    ``_node_draws``.  Returns a setter taking the feature count."""
    import jax
    import jax.numpy as jnp

    def setup(f):
        ints, unif = _draw_tables(f)

        def cut(table, shape):
            k = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            return table[:k].reshape(shape)

        monkeypatch.setattr(
            jax.random, "randint",
            lambda key, shape, minval, maxval, *a, **k: jnp.asarray(
                cut(ints, tuple(shape)), jnp.int32))
        monkeypatch.setattr(
            jax.random, "uniform",
            lambda key, shape=(), *a, **k: jnp.asarray(
                cut(unif, tuple(shape)), jnp.float32))
        monkeypatch.setattr(
            PG, "_node_draws",
            lambda gen, k, ff: (torch.from_numpy(ints[:k, :ff]),
                                torch.from_numpy(unif[:k, :ff])))
    return setup


BOTH = {"extra_trees": True, "feature_fraction_bynode": 0.5}
P = {"objective": "binary", "num_leaves": 31}


def _grow_pair(X, y, opts, g, h, kernels=("fused",), params=None,
               categorical=(), **kw):
    """The JAX grower and the port's (each wave kernel of ``kernels``) on
    the same rows and draws: trees and row_leaf bit for bit."""
    params = dict(P if params is None else params,
                  extra_trees=opts.get("extra_trees", False))
    ffb = opts.get("feature_fraction_bynode", 1.0)
    want, rl = jax_grow(X, y, params, g, h, categorical=categorical,
                        feature_fraction_bynode=ffb, **kw)
    for kernel in kernels:
        got, prl = port_grow(X, y, params, g, h, categorical=categorical,
                             wave_kernel=kernel, feature_fraction_bynode=ffb,
                             extra_trees=params["extra_trees"], **kw)
        assert_same_tree(want, got, rl, prl)
    return want


@pytest.mark.parametrize("opts,leaf_batch,kernels", [
    (BOTH, 16, ("fused", "unfused")),
    ({"extra_trees": True}, 1, ("fused",))])
def test_grower_wave_bitwise_vs_jax(injected, opts, leaf_batch, kernels):
    X, y = grown_data()
    injected(X.shape[1])
    g, h = exact_grads(len(y))
    want = _grow_pair(X, y, opts, g, h, kernels, leaf_batch=leaf_batch)
    assert want["num_leaves"] > 8


def test_grower_mask_layout_bitwise_vs_jax(injected):
    """feature_fraction_bynode alone, on the mask layout."""
    X, y = grown_data(n=2000)
    injected(X.shape[1])
    g, h = exact_grads(len(y), seed=4)
    _grow_pair(X, y, {"feature_fraction_bynode": 0.5}, g, h,
               params=dict(P, min_data_in_leaf=5), leaf_batch=4)


def test_grower_quantized_pool_and_tiles_bitwise_vs_jax(injected):
    """Quantized (deterministic rounding) at W = 4 with a pool of 2W + 1
    slots and 4-column scan blocks, fused and unfused."""
    X, y = grown_data()
    injected(X.shape[1])
    g, h = pow2_scale_grads(len(y))
    _grow_pair(X, y, BOTH, g, h, ("fused", "unfused"),
               params=dict(P, tpu_split_tile=4), quantized=True,
               stochastic_rounding=False, histogram_pool_size=0,
               leaf_batch=4)


def _cat_onehot_data(n=3 * 2560, seed=13):
    """Two one-hot blocks of 8 columns (values 1: they bundle), two normal
    columns and a 40-category column whose label signal is a hidden set
    of its categories (the sorted many-vs-many scan)."""
    rng = np.random.RandomState(seed)
    parts = []
    for _ in range(2):
        oh = np.zeros((n, 8))
        oh[np.arange(n), rng.randint(0, 8, n)] = 1.0
        parts.append(oh)
    cat = rng.randint(0, 40, n).astype(np.float64)
    X = np.column_stack(parts + [rng.randn(n, 2), cat])
    lift = ((np.arange(40) * 7 % 5) < 2)[cat.astype(int)]
    y = (lift ^ (X[:, 0] + X[:, 9] + X[:, 16] > 1.0)).astype(np.float64)
    return X, y


@pytest.mark.parametrize("bundled", [False, True])
def test_grower_sorted_categorical_and_efb_bitwise_vs_jax(injected,
                                                          bundled):
    X, y = _cat_onehot_data()
    injected(X.shape[1])
    g, h = exact_grads(len(y))
    kw = {"bundled": True} if bundled else {}
    want = _grow_pair(X, y, BOTH, g, h,
                      ("fused",) if bundled else ("fused", "unfused"),
                      categorical=[X.shape[1] - 1], leaf_batch=4, **kw)
    m = want["num_leaves"] - 1
    assert want["is_cat"][:m].any()


# ------------------------------------------------------ the node generator
def test_node_generator_seeding():
    draw = lambda gen: PG._node_draws(gen, 2, 5)
    a = draw(PG.node_generator(7, 3))
    assert all(torch.equal(x, y) for x, y in
               zip(a, draw(PG.node_generator(7, 3))))
    for other in (PG.node_generator(7, 4), PG.node_generator(8, 3),
                  PG.node_generator(7, 3, class_id=1)):
        assert not torch.equal(a[0], draw(other)[0])
    assert not torch.equal(draw(PG.node_generator(7, 3, class_id=0))[0],
                           draw(PG.node_generator(7, 3, class_id=1))[0])
    ints, unif = a
    assert ints.dtype == torch.int64 and unif.dtype == torch.float32
    assert int(ints.min()) >= 0 and int(ints.max()) < 1 << 30


def test_node_inputs_rules(monkeypatch):
    """The modulo by max(num_bins, 1), the AND with the per-tree mask and
    the keep-at-least-one rule (row 1: no feature drawn keeps the per-tree
    mask whole; row 2: only masked features drawn, likewise)."""
    ints = torch.tensor([[5, 7, 9, 11]] * 3)
    unif = torch.tensor([[0.1, 0.9, 0.2, 0.9], [0.9] * 4,
                         [0.9, 0.2, 0.9, 0.9]], dtype=torch.float32)
    monkeypatch.setattr(PG, "_node_draws", lambda gen, k, f: (ints[:k],
                                                              unif[:k]))
    cfg = PG.GrowerConfig(extra_trees=True, feature_fraction_bynode=0.5)
    fmask = torch.tensor([True, False, True, True])
    nbpf = torch.tensor([4, 0, 16, 3])
    fm, rand = PG.node_inputs(None, fmask, nbpf, 3, cfg)
    assert rand.tolist() == [[1, 0, 9, 2]] * 3
    assert fm.tolist() == [[True, False, True, False], fmask.tolist(),
                           fmask.tolist()]
    fm2, rand2 = PG.node_inputs(None, fmask, nbpf, 1, PG.GrowerConfig(
        feature_fraction_bynode=0.5))
    assert rand2 is None and fm2.tolist() == [[True, False, True, False]]


def _train_text(params, X, y, rounds=2):
    return lgt.train(dict(params, verbosity=-1), lgt.Dataset(X, label=y),
                     rounds, device="cpu").model_to_string()


def test_two_trainings_equal_text_and_extra_seed_moves_trees():
    X, y = grown_data(n=2600, f=6)
    p = {"objective": "binary", "num_leaves": 7, "tpu_leaf_batch": 2,
         **BOTH}
    a = _train_text(p, X, y)
    assert a == _train_text(p, X, y)
    assert a != _train_text(dict(p, extra_seed=9), X, y)
    assert a != _train_text(dict(p, feature_fraction_seed=9), X, y)


# ------------------------------- tests/test_categorical_sorted.py, ported
def _bst_mse(params, X, y, rounds=10):
    bst = lgt.train(params, lgt.Dataset(X, label=y), rounds, device="cpu")
    return float(np.mean((bst.predict(X) - y) ** 2)), bst


def test_extra_trees_randomizes_thresholds():
    rng = np.random.RandomState(2)
    X = rng.randn(1500, 6)
    y = X @ rng.randn(6) + 0.1 * rng.randn(1500)
    p = {"objective": "regression", "num_leaves": 15, "min_data_in_leaf": 5,
         "verbosity": -1, "deterministic": True}
    det, _ = _bst_mse(p, X, y)
    et1, _ = _bst_mse(dict(p, extra_trees=True, extra_seed=1), X, y)
    et2, _ = _bst_mse(dict(p, extra_trees=True, extra_seed=9), X, y)
    # extra randomness cannot beat exhaustive search on train MSE and
    # different seeds give different models
    assert det <= et1 + 1e-9
    assert et1 != et2
    # still learns
    assert et1 < np.var(y) * 0.5


def test_feature_fraction_bynode():
    rng = np.random.RandomState(4)
    X = rng.randn(1200, 8)
    y = X[:, 0] * 3 + 0.1 * rng.randn(1200)  # one dominant feature
    p = {"objective": "regression", "num_leaves": 15, "min_data_in_leaf": 5,
         "verbosity": -1, "deterministic": True}
    _, full = _bst_mse(p, X, y, rounds=3)
    _, bynode = _bst_mse(dict(p, feature_fraction_bynode=0.3,
                              feature_fraction_seed=3), X, y, rounds=3)

    # with per-node sampling some nodes must split on non-dominant features
    def feats(bst):
        out = []
        for cls in bst._gbdt.models:
            for t in cls:
                m = t.num_leaves - 1
                out += [int(v) for v in t.split_feature[:m]]
        return out
    assert set(feats(full)) == {0}
    assert len(set(feats(bynode))) > 1


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "int8", "bf16", "f32_packed4",
                                  "f32_uint16"])
def test_kernel_node_table_matches_plain(cuda_device, mode):
    """The wave kernel with a node table against its plain version on the
    same card, exact sums (int8: power-of-two scales): child histograms
    and payloads bit for bit; an all-(-1) table gives the payload of the
    launch without one."""
    from lightgbm_tpu_torch.ops.histogram import pack_bins4
    dev = cuda_device
    inp, nbpf = _wave_inputs(
        4, seed=8, n_per=4000, int8=mode == "int8",
        dtype=np.uint16 if mode == "f32_uint16" else np.uint8)
    node = _node_for(4, nbpf, seed=9)
    cfg = S.SplitConfig(min_data_in_leaf=1, min_sum_hessian_in_leaf=0.5)
    if mode == "bf16":
        inp["vals"] = inp["vals"].to(torch.bfloat16)
    if mode == "f32_packed4":
        inp.update(num_bins=16, parent=inp["parent"][:, :, :16].contiguous(),
                   bins=pack_bins4(inp["bins"]), packed4=True)
    kw = {k: (v.to(dev) if torch.is_tensor(v) else v)
          for k, v in inp.items()}
    node = node.to(dev)
    launches = WV.launches[mode]
    h, p = WV.fused_wave_call(cfg=cfg, node=node, **kw)
    hp, pp = WV.wave_plain(cfg=cfg, node=node, **kw)
    torch.cuda.synchronize()
    assert WV.launches[mode] == launches + 1
    assert torch.equal(h, hp) and torch.equal(p, pp)
    _, p_every = WV.fused_wave_call(cfg=cfg,
                                    node=torch.full_like(node, -1), **kw)
    _, p_none = WV.fused_wave_call(cfg=cfg, **kw)
    torch.cuda.synchronize()
    assert torch.equal(p_every, p_none)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_grower_on_the_card_matches_cpu(cuda_device, quantized):
    """The fused and unfused growers on the card against the CPU grower:
    the draws are made on the host, so trees and row_leaf are equal bit
    for bit on exact sums."""
    X, y = grown_data()
    g, h = (pow2_scale_grads if quantized else exact_grads)(len(y))
    kw = dict(extra_trees=True, feature_fraction_bynode=0.5, leaf_batch=16,
              quantized=quantized, stochastic_rounding=False)
    params = dict(P, extra_trees=True)
    want, rl = port_grow(X, y, params, g, h, **kw)
    for kernel in ("fused", "unfused"):
        got, prl = port_grow(X, y, params, g, h, device=cuda_device,
                             wave_kernel=kernel, **kw)
        assert_same_tree(want, got, rl, prl)
