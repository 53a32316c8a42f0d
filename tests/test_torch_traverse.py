"""Port parity: the quantized pack and the traversal (lightgbm_tpu_torch
models/tree.py and ops/traverse.py) against the JAX package.

- ``quantize_stack_trees`` equals JAX's array for array (int16 and int8),
  with the same scale, depth and error bound, on a carried-across booster;
- the plain walk ``_ensemble_sum_q`` equals JAX's ``_ensemble_sum_q`` and
  its interpret-mode Pallas ``fused_class_sums`` bit for bit, degenerate
  trees and multiclass included;
- on the card (``cuda`` marker), the CUDA kernel equals the plain walk at
  the full serving width (500 trees x 255 leaves x 28 features).

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
