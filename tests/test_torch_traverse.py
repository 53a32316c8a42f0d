"""Port parity: the quantized pack and the traversal (lightgbm_tpu_torch
models/tree.py and ops/traverse.py) against the JAX package.

- ``quantize_stack_trees`` equals JAX's array for array (int16 and int8),
  with the same scale, depth and error bound, on a carried-across booster;
- the plain walk ``_ensemble_sum_q`` equals JAX's ``_ensemble_sum_q`` and
  its interpret-mode Pallas ``fused_class_sums`` bit for bit, degenerate
  trees and multiclass included;
- the CUDA kernel's layout of a pack, ``walk_table`` (one 8-byte record a
  node, then the leaves), walked by a plain torch twin of the kernel's
  step, equals the plain walk and JAX's interpret-mode Pallas kernel bit
  for bit (int16 and int8 packs, categorical nodes, NaN rows,
  multiclass, degenerate and chain trees);
- on the card (``cuda`` marker), the CUDA kernel equals the plain walk at
  the full serving width (500 trees x 255 leaves x 28 features), and on
  the edge cases: degenerate and chain trees, categorical nodes, NaN
  rows, a tree axis split into blocks of unequal length, one row, int8
  leaves, 5,000-leaf trees, rows staged in shared memory and not.

The JAX package is imported inside fixtures, so the file collects on the
card too."""

import numpy as np
import pytest
import torch

from torch_port_util import P, cuda_device, messy_data, state_from_booster  # noqa: F401

from lightgbm_tpu_torch import model_from_arrays
from lightgbm_tpu_torch.models import tree as tt
from lightgbm_tpu_torch.ops import traverse


@pytest.fixture(scope="module")
def lgb():
    return pytest.importorskip("lightgbm_tpu")


@pytest.fixture(scope="module")
def boosters(lgb):
    X, y = messy_data()
    rng = np.random.RandomState(4)
    X3 = rng.randn(900, 5)
    X3[rng.rand(900, 5) < 0.05] = np.nan
    y3 = rng.randint(0, 3, 900)
    return {
        "binary": (lgb.train(P, lgb.Dataset(X, label=y), 8), X),
        "multiclass": (lgb.train({"objective": "multiclass", "num_class": 3,
                                  "num_leaves": 7, "verbosity": -1},
                                 lgb.Dataset(X3, label=y3), 4), X3),
    }


def _jax_packs(bst, mode):
    from lightgbm_tpu.models.tree import quantize_stack_trees
    g = bst._gbdt
    nb = g.train_data.binned.max_num_bins
    return [quantize_stack_trees(trees, g.cfg.num_leaves, nb, mode)
            if trees else None for trees in g.host_trees()]


def _port_packs(model, mode):
    nb = model.train_data.binned.max_num_bins
    return [tt.quantize_stack_trees(trees, model.cfg.num_leaves, nb, mode)
            if trees else None for trees in model.host_trees()]


@pytest.mark.parametrize("mode", ["int16", "int8"])
@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_quantized_pack_matches_jax(boosters, kind, mode):
    from lightgbm_tpu.models.tree import quantize_error_bound
    bst, _X = boosters[kind]
    model = model_from_arrays(state_from_booster(bst))
    for jp, tp in zip(_jax_packs(bst, mode), _port_packs(model, mode)):
        for k in tt._QPACK_ARRAYS:
            a, b = np.asarray(jp[k]), tp[k].numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        for k in ("scale", "bits", "depth", "num_bins"):
            assert jp[k] == tp[k], k
        assert quantize_error_bound(jp) == tt.quantize_error_bound(tp)


def test_pack_shape_gate_and_depth():
    """Encodings past int16 are refused; depth is the longest hop count."""
    tr = tt.Tree(split_feature=np.zeros(2, np.int32),
                 split_bin=np.zeros(2, np.int32),
                 default_left=np.zeros(2, bool), is_cat=np.zeros(2, bool),
                 cat_mask=np.zeros((2, 8), bool),
                 left_child=np.array([1, ~0], np.int32),
                 right_child=np.array([~2, ~1], np.int32),
                 leaf_value=np.array([0.5, -1.0, 2.0]), num_leaves=3)
    assert tt.quantize_stack_trees([tr], 40000, 8, "int16") is None
    assert tt.tree_max_depth(tr.left_child, tr.right_child) == 2
    assert tt.tree_max_depth(np.zeros(0, np.int32),
                             np.zeros(0, np.int32)) == 1
    pack = tt.quantize_stack_trees([tr], 3, 8, "int8")
    assert pack["depth"] == 2 and pack["leaf_q"].dtype == torch.int8
    np.testing.assert_array_equal(pack["leaf_q"].numpy(), [[32, -64, 127]])


def _with_degenerate_trees(bst):
    """The booster's trees with single-leaf trees interleaved, as JAX
    ``Tree``s and as the port's."""
    from lightgbm_tpu.models.tree import Tree as JTree
    trees = bst._gbdt.host_trees()[0]
    b = trees[0].cat_mask.shape[1]
    z = np.zeros(0)
    single = JTree(split_feature=z.astype(np.int32), split_bin=z.astype(
        np.int32), threshold=z, default_left=z.astype(bool),
        is_cat=z.astype(bool), cat_mask=np.zeros((0, b), bool),
        left_child=z.astype(np.int32), right_child=z.astype(np.int32),
        split_gain=z.astype(np.float32), internal_value=z.astype(np.float32),
        internal_count=z.astype(np.float32), leaf_value=np.array([-0.3]),
        leaf_count=np.ones(1, np.float32), leaf_weight=np.ones(1, np.float32),
        num_leaves=1)
    jtrees = [t for tr in trees for t in (tr, single)]
    state = state_from_booster(bst)
    one = {k: np.asarray(getattr(single, k)) for k in state["trees"][0][0]}
    one["num_leaves"] = 1
    state["trees"] = [[t for tr in state["trees"][0] for t in (tr, one)]]
    return jtrees, model_from_arrays(state).host_trees()[0]


@pytest.mark.parametrize("kind", ["binary", "multiclass", "degenerate"])
def test_plain_walk_matches_jax_walk_and_pallas_kernel(boosters, kind):
    """Port plain walk == JAX unfused walk == JAX Pallas kernel (interpret
    mode), as integers, for every class pack, including packs with
    sentinel-encoded single-leaf trees."""
    import jax.numpy as jnp
    from lightgbm_tpu.models.tree import _ensemble_sum_q
    from lightgbm_tpu.models.tree import \
        quantize_stack_trees as jax_quantize
    from lightgbm_tpu.ops.pallas_traverse import fused_class_sums

    bst, X = boosters["binary" if kind == "degenerate" else kind]
    binned = bst._gbdt.train_data.binned
    bins = binned.apply(X[:300]).astype(np.int32)
    nan_bins = np.asarray(binned.nan_bins, np.int32)
    if kind == "degenerate":
        jtrees, ttrees = _with_degenerate_trees(bst)
        args = (bst._gbdt.cfg.num_leaves, binned.max_num_bins, "int16")
        jpacks = [jax_quantize(jtrees, *args)]
        tpacks = [tt.quantize_stack_trees(ttrees, *args)]
    else:
        model = model_from_arrays(state_from_booster(bst))
        jpacks = _jax_packs(bst, "int16")
        tpacks = _port_packs(model, "int16")
    assert len(tpacks) == len(jpacks) == bst._gbdt.num_class
    for jp, tp in zip(jpacks, tpacks):
        want = np.asarray(_ensemble_sum_q(jp, jnp.asarray(bins),
                                          jnp.asarray(nan_bins)))
        kern = np.asarray(fused_class_sums(jp, jnp.asarray(bins),
                                           jnp.asarray(nan_bins),
                                           interpret=True))
        got = tt._ensemble_sum_q(tp, torch.from_numpy(bins),
                                 torch.from_numpy(nan_bins))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), kern)


def _walk_table_twin(pack, bins, nan_bins):
    """The CUDA kernel's walk in plain torch over the pack's walk table:
    per tree and step, one node record (word 0: feature, default_left at
    bit 15, split bin at 16, is_cat at 31; word 1: the int16 children),
    the row's bin and the feature's NaN bin, then the leaf quantum stored
    after the tree's records."""
    table = pack["walk_table"].long()
    t, m = pack["split_feature"].shape
    mp = tt.table_nodes(m)
    cats = pack["cat_bits"].long()
    bb = cats.shape[2]
    n = bins.shape[0]
    rows = torch.arange(n)
    acc = torch.zeros(n, dtype=torch.int32)
    for ti in range(t):
        tab = table[ti]
        node = torch.zeros(n, dtype=torch.long)
        leaf = torch.zeros(n, dtype=torch.long)
        walking = torch.ones(n, dtype=torch.bool)
        for _ in range(int(pack["depth"])):
            w0, w1 = tab[2 * node], tab[2 * node + 1]
            feat = w0 & 0x7FFF
            col = bins[rows, feat].long()
            byte = cats[ti, node, torch.clamp(col >> 3, max=bb - 1)]
            go_left = torch.where(
                w0 < 0, ((byte >> (col & 7)) & 1) > 0,
                torch.where(col == nan_bins[feat].long(), (w0 >> 15) & 1 > 0,
                            col <= (w0 >> 16) & 0x7FFF))
            nxt = torch.where(go_left, ((w1 & 0xFFFF) ^ 0x8000) - 0x8000,
                              w1 >> 16)
            leaf = torch.where(walking & (nxt < 0), ~nxt, leaf)
            walking = walking & (nxt >= 0)
            node = torch.where(walking, nxt, node)
        acc += tab[2 * mp + leaf].to(torch.int32)
    return acc


def _with_chain_tree(bst):
    """The booster's trees and a chain tree of ``num_leaves`` leaves (depth
    num_leaves - 1), as JAX ``Tree``s and as the port's."""
    import chip_smoke as cs
    from lightgbm_tpu.models.tree import Tree as JTree
    g = bst._gbdt
    binned = g.train_data.binned
    trees = g.host_trees()[0]
    chain = cs.chain_tree(np.random.RandomState(3), g.cfg.num_leaves,
                          binned.num_bins_per_feature,
                          trees[0].cat_mask.shape[1])
    m, leaves = chain["num_leaves"] - 1, chain["num_leaves"]
    jchain = JTree(threshold=np.zeros(m), split_gain=np.zeros(m, np.float32),
                   internal_value=np.zeros(m, np.float32),
                   internal_count=np.zeros(m, np.float32),
                   leaf_count=np.ones(leaves, np.float32),
                   leaf_weight=np.ones(leaves, np.float32), **chain)
    state = state_from_booster(bst)
    one = {k: np.asarray(getattr(jchain, k)) for k in state["trees"][0][0]}
    one["num_leaves"] = leaves
    state["trees"] = [state["trees"][0] + [one]]
    return trees + [jchain], model_from_arrays(state).host_trees()[0]


@pytest.mark.parametrize("mode", ["int16", "int8"])
@pytest.mark.parametrize("kind", ["binary", "multiclass", "degenerate",
                                  "chain"])
def test_walk_table_twin_matches_plain_walk_and_jax(boosters, kind, mode):
    """``walk_table`` walked by the kernel's plain twin == the port's plain
    walk == JAX's interpret-mode Pallas kernel, as integers, for every
    class pack: categorical nodes (feature 4) and NaN rows (binary),
    three classes, sentinel single-leaf trees, and a chain tree whose
    depth is num_leaves - 1."""
    import jax.numpy as jnp
    from lightgbm_tpu.models.tree import \
        quantize_stack_trees as jax_quantize
    from lightgbm_tpu.ops.pallas_traverse import fused_class_sums

    bst, X = boosters["multiclass" if kind == "multiclass" else "binary"]
    binned = bst._gbdt.train_data.binned
    bins = binned.apply(X[:300]).astype(np.int32)
    nan_bins = np.asarray(binned.nan_bins, np.int32)
    if kind in ("degenerate", "chain"):
        jtrees, ttrees = (_with_degenerate_trees(bst) if kind == "degenerate"
                          else _with_chain_tree(bst))
        args = (bst._gbdt.cfg.num_leaves, binned.max_num_bins, mode)
        jpacks = [jax_quantize(jtrees, *args)]
        tpacks = [tt.quantize_stack_trees(ttrees, *args)]
        if kind == "chain":
            assert tpacks[0]["depth"] == bst._gbdt.cfg.num_leaves - 1
    else:
        model = model_from_arrays(state_from_booster(bst))
        jpacks = _jax_packs(bst, mode)
        tpacks = _port_packs(model, mode)
    for jp, tp in zip(jpacks, tpacks):
        tb, tn = torch.from_numpy(bins), torch.from_numpy(nan_bins)
        got = _walk_table_twin(tp, tb, tn)
        kern = np.asarray(fused_class_sums(jp, jnp.asarray(bins),
                                           jnp.asarray(nan_bins),
                                           interpret=True))
        np.testing.assert_array_equal(got.numpy(), kern)
        np.testing.assert_array_equal(
            got.numpy(), tt._ensemble_sum_q(tp, tb, tn).numpy())


def test_walk_table_layout():
    """One tree's records and leaves where the kernel reads them: the
    flags in the spare high bits of feature and split bin, the children
    as int16 halves, a categorical node's split bin stored as 0, the
    leaves widened to int32 after the records (node count rounded up to
    even, the row to a multiple of 4 words); a numerical split bin past
    15 bits is refused."""
    tr = tt.Tree(split_feature=np.array([3, 32767], np.int32),
                 split_bin=np.array([5, 9], np.int32),
                 default_left=np.array([True, False]),
                 is_cat=np.array([False, True]),
                 cat_mask=np.zeros((2, 16), bool),
                 left_child=np.array([1, ~0], np.int32),
                 right_child=np.array([~2, ~1], np.int32),
                 leaf_value=np.array([0.5, -1.0, 2.0]), num_leaves=3)
    pack = tt.quantize_stack_trees([tr], 4, 16, "int8")
    table = pack["walk_table"].numpy().view(np.uint32)
    assert table.shape == (1, 12) and tt.table_nodes(3) == 4
    assert table[0, 0] == 3 | 1 << 15 | 5 << 16
    assert table[0, 1] == 1 | (~2 & 0xFFFF) << 16
    assert table[0, 2] == 32767 | 1 << 31
    assert table[0, 3] == (~0 & 0xFFFF) | (~1 & 0xFFFF) << 16
    assert table[0, 4:8].tolist() == [0, 0, 0, 0]
    np.testing.assert_array_equal(table[0, 8:11].view(np.int32),
                                  pack["leaf_q"][0, :3].numpy())
    bad = {k: v.clone() for k, v in pack.items() if torch.is_tensor(v)}
    bad["split_bin"][0, 0] = -1
    with pytest.raises(ValueError, match="split bins"):
        tt.walk_table(bad)


def test_degenerate_tree_pack_walks_to_leaf_zero():
    """A tree with one leaf is encoded with sentinel children and sums its
    single quantum for every row, in the plain walk and the wrapper."""
    tr = tt.Tree(split_feature=np.zeros(0, np.int32),
                 split_bin=np.zeros(0, np.int32),
                 default_left=np.zeros(0, bool), is_cat=np.zeros(0, bool),
                 cat_mask=np.zeros((0, 8), bool),
                 left_child=np.zeros(0, np.int32),
                 right_child=np.zeros(0, np.int32),
                 leaf_value=np.array([0.25]), num_leaves=1)
    pack = tt.quantize_stack_trees([tr, tr], 4, 8, "int16")
    bins = torch.randint(0, 8, (5, 3), dtype=torch.int32)
    nan_bins = torch.full((3,), 8, dtype=torch.int32)
    out = traverse.fused_class_sums(pack, bins, nan_bins)
    np.testing.assert_array_equal(out.numpy(), np.full(5, 2 * 32767))


def test_wrapper_checks_inputs(boosters):
    bst, X = boosters["binary"]
    model = model_from_arrays(state_from_booster(bst))
    pack = _port_packs(model, "int16")[0]
    binned = model.train_data.binned
    bins = torch.from_numpy(binned.apply(X[:10]).astype(np.int32))
    nan_bins = torch.from_numpy(binned.nan_bins)
    traverse.fused_class_sums(pack, bins, nan_bins)
    with pytest.raises(ValueError, match="int32"):
        traverse.fused_class_sums(pack, bins.to(torch.int64), nan_bins)
    with pytest.raises(ValueError, match="nan_bins"):
        traverse.fused_class_sums(pack, bins, nan_bins[:-1])
    with pytest.raises(ValueError, match="dtype"):
        traverse.fused_class_sums(dict(pack, leaf_q=pack["leaf_q"].float()),
                                  bins, nan_bins)
    with pytest.raises(ValueError, match="contiguous"):
        traverse.fused_class_sums(pack, bins.t().contiguous().t(), nan_bins)


# ------------------------------------------------------------ on the card
def _full_width_pack(device, mode, seed=0):
    import chip_smoke as cs
    from lightgbm_tpu_torch import bin_dataset
    rng = np.random.RandomState(seed)
    X, _ = cs.make_higgs_like(20_000, 28, seed)
    X = X.astype(np.float64)
    X[rng.rand(*X.shape) < 0.02] = np.nan
    binned = bin_dataset(X, max_bin=255)
    model = model_from_arrays(cs.random_model_state(rng, binned, 500, 255))
    pack = tt.quantize_stack_trees(model.host_trees()[0], 255,
                                   binned.max_num_bins, mode, device)
    return pack, binned, X


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int16", "int8"])
def test_kernel_matches_plain_full_width(cuda_device, mode):
    pack, binned, X = _full_width_pack(cuda_device, mode)
    nanb = torch.as_tensor(binned.nan_bins, dtype=torch.int32,
                           device=cuda_device)
    before = traverse.launches
    for n in (1, 33, 4096):
        bins = torch.from_numpy(binned.apply(X[:n]).astype(np.int32)).to(
            cuda_device)
        got = traverse.fused_class_sums(pack, bins, nanb)
        want = tt._ensemble_sum_q(pack, bins, nanb)
        torch.cuda.synchronize()
        assert torch.equal(got, want), n
    assert traverse.launches == before + 3


def _edge_pack(device, mode, num_trees, num_leaves, seed):
    """``chip_smoke.edge_case_trees`` over 12 features (3 and 7
    categorical, up to 64 bins, some features with a NaN bin), their pack,
    rows binned at random with a fifth of each NaN feature's rows in its
    NaN bin, and the NaN bins."""
    import chip_smoke as cs
    rng = np.random.RandomState(seed)
    f, b = 12, 64
    nbpf = rng.randint(8, b + 1, f)
    trees = cs.edge_case_trees(rng, nbpf, b, (3, 7), num_trees, num_leaves)
    pack = tt.quantize_stack_trees(trees, num_leaves, b, mode, device)
    nan_bins = np.where(rng.rand(f) < 0.5, nbpf - 1, b).astype(np.int32)

    def rows(n):
        bins = (rng.rand(n, f) * nbpf).astype(np.int32)
        nan = (rng.rand(n, f) < 0.2) & (nan_bins < b)
        bins[nan] = np.broadcast_to(nan_bins, (n, f))[nan]
        return torch.from_numpy(bins).to(device)
    return pack, rows, torch.from_numpy(nan_bins).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int16", "int8"])
@pytest.mark.parametrize("num_trees,num_leaves", [(21, 255), (3, 5000)])
def test_kernel_edge_cases(cuda_device, mode, num_trees, num_leaves,
                           monkeypatch):
    """The traversal kernel == the plain walk on categorical nodes, NaN
    rows, single-leaf and chain trees (depth num_leaves - 1), 5,000-leaf
    trees, at N = 1, 33, 4,096 and 70,000 (at 70,000 rows and T = 21 the
    tree axis is split into blocks of 2 trees, the last of 1), with the
    rows' bins staged in shared memory (every launch, here) and read
    from global memory."""
    pack, rows, nanb = _edge_pack(cuda_device, mode, num_trees, num_leaves,
                                  seed=num_leaves)
    assert traverse.launch_shape(70_000, 21, 12, 132) == (2, False)
    for stage in (True, False):
        monkeypatch.setattr(traverse, "ROW_STAGE_MIN_TREES",
                            1 if stage else 10 ** 9)
        assert traverse.launch_shape(1, num_trees, 12, 132)[1] == stage
        for n in (1, 33, 4096, 70_000):
            bins = rows(n)
            got = traverse.fused_class_sums(pack, bins, nanb)
            want = tt._ensemble_sum_q(pack, bins, nanb)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (n, stage)
