"""Split-search parity: the port's ``best_split`` and ``scan_tables`` +
``select_payload`` (the plain version of the wave kernel's scan stage)
against the JAX package's, on exact-sum histograms.

Histograms hold gradients in halves, hessians in quarters and integer
counts, so every cumulative sum is exact in any order and each gain is
the same float32 op sequence in both packages: every ``BestSplit`` field
is held bit for bit.  Cases cover NaN bins, one-hot categoricals,
``lambda_l1`` / ``lambda_l2``, ``path_smooth``, ``max_delta_step``,
``min_gain_to_split``, a masked feature and planted gain ties (a
duplicated feature: the lowest flat index must win)."""

import dataclasses

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import split as S
from torch_port_util import cuda_device  # noqa: F401

F, B = 6, 16
NBPF = np.array([16, 12, 16, 12, 4, 9], np.int32)
NAN = np.array([15, 16, 16, 11, 16, 8], np.int32)     # 16 = no NaN bin
IS_CAT = np.array([0, 0, 0, 0, 1, 0], bool)
FMASK = np.array([1, 1, 1, 1, 1, 0], bool)

CASES = {
    "plain": dict(min_data_in_leaf=1),
    "l1_l2": dict(min_data_in_leaf=3, lambda_l1=0.75, lambda_l2=1.5),
    "path_smooth": dict(min_data_in_leaf=2, path_smooth=3.0,
                        lambda_l2=0.5),
    "max_delta_step": dict(min_data_in_leaf=1, max_delta_step=0.05),
    "min_gain_hess": dict(min_data_in_leaf=5, min_gain_to_split=0.25,
                          min_sum_hessian_in_leaf=2.0),
    "no_split": dict(min_data_in_leaf=10 ** 6),
}


def _hist(seed):
    """Exact-sum (F, B, 3) histogram, zero outside each feature's bins;
    feature 3 duplicates feature 1 (gain ties)."""
    rng = np.random.RandomState(seed)
    cnt = rng.randint(0, 30, (F, B)).astype(np.float32)
    g = rng.randint(-20, 21, (F, B)).astype(np.float32) * 0.5
    hist = np.stack([g, cnt * 0.25, cnt], axis=-1)
    hist[np.arange(B)[None, :] >= NBPF[:, None]] = 0.0
    hist[3] = hist[1]
    # every feature sums to the same leaf totals (one row set)
    tot = hist[0].sum(axis=0)
    for j in range(1, F):
        hist[j, 0] += tot - hist[j].sum(axis=0)
    hist[3] = hist[1]
    return hist, tot


def _port_cfg(kw):
    return S.SplitConfig(has_nan=True, has_categorical=True, **kw)


def _jax_cfg(kw):
    from lightgbm_tpu.ops.split import SplitConfig
    return SplitConfig(has_nan=True, has_categorical=True,
                       use_sorted_categorical=False, has_monotone=False,
                       **kw)


def _meta_t():
    return dict(num_bins_per_feature=torch.from_numpy(NBPF),
                nan_bins=torch.from_numpy(NAN),
                is_categorical=torch.from_numpy(IS_CAT),
                feature_mask=torch.from_numpy(FMASK))


def _meta_j():
    import jax.numpy as jnp
    return dict(num_bins_per_feature=jnp.asarray(NBPF),
                nan_bins=jnp.asarray(NAN), is_categorical=jnp.asarray(IS_CAT),
                feature_mask=jnp.asarray(FMASK))


def _assert_best_equal(got, want):
    for name in S.BestSplit._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_best_split_bitwise_vs_jax(case, seed):
    import jax.numpy as jnp

    from lightgbm_tpu.ops.split import best_split as jbest
    hist, tot = _hist(seed)
    kw = CASES[case]
    pout = np.float32(0.125) if "path_smooth" in kw else None
    want = jbest(jnp.asarray(hist), *(jnp.asarray(v) for v in tot),
                 monotone=None, cfg=_jax_cfg(kw),
                 parent_output=None if pout is None else jnp.asarray(pout),
                 **_meta_j())
    got = S.best_split(torch.from_numpy(hist),
                       *(torch.tensor(v) for v in tot), cfg=_port_cfg(kw),
                       parent_output=(None if pout is None
                                      else torch.tensor(pout)),
                       **_meta_t())
    _assert_best_equal(got, want)
    if case == "no_split":
        assert float(got.gain) == float("-inf")
    else:
        assert np.isfinite(float(got.gain))


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_select_payload_bitwise_vs_jax(case):
    """The kernel's selection (select_payload over scan_tables) equals the
    JAX package's, and the port's two selectors agree."""
    import jax.numpy as jnp

    from lightgbm_tpu.ops import split as JS
    hist, tot = _hist(3)
    kw = CASES[case]
    jt = JS.scan_tables(*(jnp.asarray(hist[..., c]) for c in range(3)),
                        *(jnp.asarray(v) for v in tot), cfg=_jax_cfg(kw),
                        **_meta_j())
    want = JS.select_payload(jt, jnp.asarray(IS_CAT), _jax_cfg(kw))
    tt = S.scan_tables(*(torch.from_numpy(hist[..., c]) for c in range(3)),
                       *(torch.tensor(v) for v in tot), cfg=_port_cfg(kw),
                       **_meta_t())
    got = S.select_payload(tt, torch.from_numpy(IS_CAT), _port_cfg(kw))
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(i))
    np.testing.assert_array_equal(tt.gain_fb.numpy(), np.asarray(jt.gain_fb))
    ref = S._select_from_tables(tt, torch.from_numpy(IS_CAT), _port_cfg(kw))
    gain, bf, bb, dl, ic, *stats = got
    assert float(gain) == float(ref.gain) or (
        np.isinf(float(gain)) and np.isinf(float(ref.gain)))
    assert (int(bf), int(bb), bool(dl), bool(ic)) == (
        int(ref.feature), int(ref.bin), bool(ref.default_left),
        bool(ref.is_cat))
    for a, b in zip(stats, (ref.sum_grad_left, ref.sum_hess_left,
                            ref.count_left, ref.sum_grad_right,
                            ref.sum_hess_right, ref.count_right)):
        assert float(a) == float(b)


def test_planted_tie_goes_to_lowest_flat_index():
    """Feature 3 duplicates feature 1; with feature 1 the best, the
    winner must be feature 1, never 3."""
    hist, tot = _hist(0)
    hist[1, :, 0] = 0.0
    hist[1, 0, 0] = 40.0
    hist[1, 5, 0] = -40.0
    tot = hist[1].sum(axis=0)
    hist[3] = hist[1]
    for j in (0, 2, 4, 5):
        hist[j] = 0.0
        hist[j, 0] = tot
    cfg = _port_cfg(dict(min_data_in_leaf=1))
    got = S.best_split(torch.from_numpy(hist),
                       *(torch.tensor(v) for v in tot), cfg=cfg, **_meta_t())
    assert int(got.feature) == 1 and np.isfinite(float(got.gain))


def test_leaf_output_helpers_vs_jax():
    import jax.numpy as jnp

    from lightgbm_tpu.ops import split as JS
    rng = np.random.RandomState(5)
    g = (rng.randn(50) * 3).astype(np.float32)
    h = (rng.rand(50) * 4).astype(np.float32)
    c = rng.randint(1, 50, 50).astype(np.float32)
    pout = np.float32(-0.3)
    for kw in ({}, {"lambda_l1": 0.4, "lambda_l2": 2.0},
               {"max_delta_step": 0.2, "path_smooth": 5.0}):
        pc, jc = _port_cfg(dict(kw)), _jax_cfg(dict(kw))
        tg, th, tcnt = (torch.from_numpy(v) for v in (g, h, c))
        jg, jh, jcnt = (jnp.asarray(v) for v in (g, h, c))
        for got, want in (
                (S.leaf_output(tg, th, pc), JS.leaf_output(jg, jh, jc)),
                (S.leaf_gain(tg, th, pc), JS.leaf_gain(jg, jh, jc)),
                (S.smoothed_output(tg, th, tcnt, torch.tensor(pout), pc),
                 JS.smoothed_output(jg, jh, jcnt, jnp.asarray(pout), jc)),
                (S.child_gain(tg, th, tcnt, torch.tensor(pout), pc),
                 JS.child_gain(jg, jh, jcnt, jnp.asarray(pout), jc))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batch_matches_single():
    hist, tot = _hist(4)
    cfg = _port_cfg(dict(min_data_in_leaf=1))
    hists = torch.from_numpy(np.stack([hist, hist]))
    t = [torch.tensor(np.stack([v, v])) for v in tot]
    pout = torch.zeros(2)
    batch = S.best_split_batch(hists, *t, pout, cfg=cfg, **_meta_t())
    one = S.best_split(torch.from_numpy(hist),
                       *(torch.tensor(v) for v in tot), cfg=cfg,
                       parent_output=torch.tensor(0.0), **_meta_t())
    for name in S.BestSplit._fields:
        a = getattr(batch, name)
        b = getattr(one, name)
        assert torch.equal(a[0], b) and torch.equal(a[1], b), name


def test_split_config_defaults_match_jax():
    from lightgbm_tpu.ops.split import SplitConfig as JC
    port = dataclasses.asdict(S.SplitConfig())
    jax_defaults = dataclasses.asdict(JC())
    for k, v in port.items():
        assert jax_defaults[k] == v, k


@pytest.mark.cuda
@pytest.mark.parametrize("smooth", [0.0, 10.0])
def test_sorted_scan_card_matches_cpu(cuda_device, smooth):
    """The sorted categorical scan on the card gives the CPU's results
    bit for bit on exact sums, with the keys a device sort could order
    otherwise: 0 / 0 (empty bins at ``cat_smooth`` 0), -0.0 gradients,
    and equal keys (ties keep bin order)."""
    rng = np.random.RandomState(5)
    k, f, b = 6, 5, 64
    cnt = rng.randint(0, 30, (k, f, b)).astype(np.float32)
    cnt[rng.rand(k, f, b) < 0.2] = 0.0
    g = rng.randint(-3, 4, (k, f, b)).astype(np.float32) * 0.5
    g[cnt == 0] = 0.0
    g[:, :, ::7] = -0.0
    hists = torch.from_numpy(np.stack([g, cnt * 0.25, cnt], axis=-1))
    tot = hists[:, 0].sum(dim=1)
    pout = torch.zeros(k)
    in_feature = torch.arange(b)[None, :] < torch.tensor([[64], [40], [7],
                                                          [2], [64]])
    cfg = S.SplitConfig(cat_smooth=smooth, min_data_per_group=3,
                        min_data_in_leaf=1)
    want = S.sorted_categorical(hists, tot[:, 0], tot[:, 1], tot[:, 2], pout,
                                in_feature, cfg)
    got = S.sorted_categorical(
        hists.to(cuda_device), *(t.to(cuda_device) for t in (
            tot[:, 0], tot[:, 1], tot[:, 2], pout)),
        in_feature.to(cuda_device), cfg)
    assert torch.isfinite(want[0]).any()
    for a, w in zip(got, want):
        assert torch.equal(a.cpu(), w)
