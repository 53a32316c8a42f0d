"""Grower parity: the port's leaf-wise grower (CPU, plain versions of the
kernels) against the JAX package's ``make_grower``, on exact-sum
gradients (+-0.5, hessian 0.25: every histogram sum is exact in any
order), so trees and ``row_leaf`` are held bit for bit:

- the wave layout at leaf_batch 1, 4 and 16, the port's fused step
  (``ops/wave.py``, the plain version of the CUDA wave kernel) and its
  unfused step both against JAX ``wave_kernel="fused"`` (its Pallas
  kernel in interpret mode), and the unfused step against JAX
  ``"unfused"``;
- the mask layout (<= 2048 rows);
- a <= 16-bin dataset, which the JAX package stores as 4-bit nibble
  pairs (its default ``tpu_4bit_bins``) and the port unpacked;
- one-hot categorical splits, ``cat_mask`` routing included.

Quantized training (``quantized=True, stochastic_rounding=False``) on
gradients whose scales are powers of two (``pow2_scale_grads``): the
int8 levels round, and every scaled int32 sum is exact, so trees and
``row_leaf`` are held bit for bit against JAX ``quantized=True`` at
leaf_batch 1 and 16 (fused and unfused against its fused kernel in
interpret mode) and on the mask layout; ``quant_renew_leaf`` leaf values
within 1e-6 relative (f32 per-leaf sums; bitwise in practice, both sum
in row order).

4-bit bins (``packed4=True``: the bins are (N, ceil(F/2)) nibble pairs
on <= 16-bin data): trees and ``row_leaf`` bit for bit against JAX
``make_grower(packed4=True)`` at leaf_batch 1 and 16, f32 on exact sums
and quantized on power-of-two scales, the port's fused and unfused steps
against JAX's fused kernel (interpret mode), and on the mask layout
(which unpacks once).  bf16 values (``histogram_impl="flat_bf16"``):
JAX's own flat_bf16 path cannot run on the CPU (its root histogram calls
the Pallas kernel outside interpret mode), so the port's bf16 grower,
fused and unfused, is held against JAX ``histogram_impl="segment"`` on
exact-sum gradients, which bf16 represents exactly.

uint16 bins (``max_bin`` 1023: about 1,000 bins a feature): trees and
``row_leaf`` bit for bit against JAX ``make_grower`` at leaf_batch 1 and
16 on exact sums, the port's auto and unfused steps against JAX's auto
(unfused on the CPU) and its fused step against JAX's fused kernel
(interpret mode); quantized on power-of-two scales the same way, and on
the mask layout.  ``wave_fused_for`` fuses on CUDA at every bin count,
also where the JAX package's TPU ``wave_layout`` does not fit.

On the card (``cuda`` marker) the grower driven through both CUDA kernels
gives the CPU plain version's trees bit for bit, f32 and quantized, over
packed bins, with bf16 values and over uint16 bins (fused and unfused),
through the matching kernel modes, and with a sorted categorical
feature."""

import numpy as np
import pytest
import torch

from torch_port_util import (TREE_FIELDS, assert_same_tree,  # noqa: F401
                             cuda_device, exact_grads, grown_data, jax_grow,
                             port_grow, pow2_scale_grads)

from lightgbm_tpu_torch.models import grower as PG
from lightgbm_tpu_torch.ops import histogram_flat as HF
from lightgbm_tpu_torch.ops import wave as WV
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

P = {"objective": "binary", "num_leaves": 31}


@pytest.fixture(scope="module")
def grown():
    X, y = grown_data()
    g, h = exact_grads(len(y))
    return X, y, g, h


@pytest.mark.parametrize("leaf_batch", [1, 4, 16])
def test_wave_bitwise_vs_jax_fused(grown, leaf_batch):
    X, y, g, h = grown
    want, rl = jax_grow(X, y, P, g, h, leaf_batch=leaf_batch,
                        wave_kernel="fused")
    assert want["num_leaves"] == 31
    for kernel in ("fused", "unfused"):
        got, prl = port_grow(X, y, P, g, h, leaf_batch=leaf_batch,
                             wave_kernel=kernel)
        assert_same_tree(want, got, rl, prl)


def test_unfused_bitwise_vs_jax_unfused(grown):
    X, y, g, h = grown
    want, rl = jax_grow(X, y, P, g, h, leaf_batch=16, wave_kernel="unfused")
    got, prl = port_grow(X, y, P, g, h, leaf_batch=16, wave_kernel="unfused")
    assert_same_tree(want, got, rl, prl)


def test_mask_layout_bitwise_vs_jax(grown):
    X, y, _, _ = grown
    n = 2000
    g, h = exact_grads(n, seed=4)
    params = dict(P, min_data_in_leaf=5)
    want, rl = jax_grow(X[:n], y[:n], params, g, h)
    got, prl = port_grow(X[:n], y[:n], params, g, h, leaf_batch=4)
    assert want["num_leaves"] > 8
    assert_same_tree(want, got, rl, prl)


def test_16_bin_data_bitwise_vs_jax_packed4():
    rng = np.random.RandomState(11)
    n, f = 3 * 2560, 9
    X = np.round(rng.randn(n, f) * 2)           # few values -> <= 16 bins
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float64)
    g, h = exact_grads(n)
    params = dict(P, max_bin=15)
    want, rl = jax_grow(X, y, params, g, h, leaf_batch=4, packed4=True)
    got, prl = port_grow(X, y, params, g, h, leaf_batch=4,
                         wave_kernel="fused")
    assert want["num_leaves"] > 8
    assert_same_tree(want, got, rl, prl)


@pytest.fixture(scope="module")
def data16():
    """<= 16-bin rows (max_bin 15, few distinct values per feature, an odd
    F of 9): f32 exact-sum gradients and power-of-two-scale ones."""
    rng = np.random.RandomState(11)
    n, f = 3 * 2560, 9
    X = np.round(rng.randn(n, f) * 2)
    X[rng.rand(n) < 0.05, 4] = np.nan
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float64)
    return X, y, exact_grads(n), pow2_scale_grads(n)


P15 = dict(P, max_bin=15)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quantized"])
@pytest.mark.parametrize("leaf_batch", [1, 16])
def test_packed4_bitwise_vs_jax(data16, leaf_batch, quant):
    X, y, exact, pow2 = data16
    g, h = pow2 if quant else exact
    kw = dict(Q) if quant else {}
    if quant:                       # interpret-mode JAX growth is slow
        X, y, g, h = X[:3200], y[:3200], g[:3200], h[:3200]
    want, rl = jax_grow(X, y, P15, g, h, leaf_batch=leaf_batch,
                        wave_kernel="fused", packed4=True, **kw)
    assert want["num_leaves"] == 31
    for kernel in ("fused", "unfused"):
        got, prl = port_grow(X, y, P15, g, h, leaf_batch=leaf_batch,
                             wave_kernel=kernel, packed4=True, **kw)
        assert_same_tree(want, got, rl, prl)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quantized"])
def test_packed4_mask_layout_bitwise_vs_jax(data16, quant):
    X, y, exact, pow2 = data16
    n = 2000
    g, h = pow2 if quant else exact
    kw = dict(Q) if quant else {}
    params = dict(P15, min_data_in_leaf=5)
    want, rl = jax_grow(X[:n], y[:n], params, g[:n], h[:n], packed4=True,
                        **kw)
    got, prl = port_grow(X[:n], y[:n], params, g[:n], h[:n], leaf_batch=4,
                         packed4=True, **kw)
    assert want["num_leaves"] > 8
    assert_same_tree(want, got, rl, prl)


@pytest.mark.parametrize("leaf_batch", [1, 16])
def test_bf16_grower_bitwise_vs_jax_segment(grown, leaf_batch):
    X, y, g, h = grown
    want, rl = jax_grow(X, y, P, g, h, leaf_batch=leaf_batch,
                        histogram_impl="segment")
    for kernel in ("fused", "unfused"):
        got, prl = port_grow(X, y, P, g, h, leaf_batch=leaf_batch,
                             histogram_impl="flat_bf16", wave_kernel=kernel)
        assert_same_tree(want, got, rl, prl)


def test_onehot_categorical_bitwise_vs_jax():
    rng = np.random.RandomState(13)
    n = 3 * 2560
    cat = rng.randint(0, 6, n).astype(np.float64)
    X = np.column_stack([cat, rng.randn(n, 3)])
    y = (((cat == 2.0) | (cat == 5.0)) ^ (X[:, 1] > 1.0)).astype(np.float64)
    g, h = exact_grads(n)
    params = dict(P, max_cat_to_onehot=16)
    want, rl = jax_grow(X, y, params, g, h, categorical=[0], leaf_batch=4,
                        wave_kernel="fused")
    got, prl = port_grow(X, y, params, g, h, categorical=[0], leaf_batch=4,
                         wave_kernel="fused")
    assert want["is_cat"][: want["num_leaves"] - 1].any()
    assert_same_tree(want, got, rl, prl)


Q = dict(quantized=True, stochastic_rounding=False)


@pytest.fixture(scope="module")
def quant_data():
    """A smaller wave-layout dataset (interpret-mode JAX growth is slow)."""
    X, y = grown_data(n=3200, f=8, seed=17)
    g, h = pow2_scale_grads(len(y))
    return X, y, g, h


@pytest.mark.parametrize("leaf_batch", [1, 16])
def test_quantized_bitwise_vs_jax_fused(quant_data, leaf_batch):
    X, y, g, h = quant_data
    want, rl = jax_grow(X, y, P, g, h, leaf_batch=leaf_batch,
                        wave_kernel="fused", **Q)
    assert want["num_leaves"] == 31
    for kernel in ("fused", "unfused"):
        got, prl = port_grow(X, y, P, g, h, leaf_batch=leaf_batch,
                             wave_kernel=kernel, **Q)
        assert_same_tree(want, got, rl, prl)


def test_quantized_mask_layout_bitwise_vs_jax(quant_data):
    X, y, g, h = quant_data
    n = 2000
    params = dict(P, min_data_in_leaf=5)
    want, rl = jax_grow(X[:n], y[:n], params, g[:n], h[:n], **Q)
    got, prl = port_grow(X[:n], y[:n], params, g[:n], h[:n], leaf_batch=4,
                         **Q)
    assert want["num_leaves"] > 8
    assert_same_tree(want, got, rl, prl)


def test_quant_renew_leaf_vs_jax(quant_data):
    X, y, g, h = quant_data
    kw = dict(Q, quant_renew_leaf=True)
    want, rl = jax_grow(X, y, P, g, h, leaf_batch=4, **kw)
    got, prl = port_grow(X, y, P, g, h, leaf_batch=4, **kw)
    plain, _ = port_grow(X, y, P, g, h, leaf_batch=4, **Q)
    np.testing.assert_array_equal(prl, rl)
    for k in TREE_FIELDS:
        if k in ("leaf_value", "leaf_weight"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # renewal changes the outputs: quantized sums are not the true sums
    assert not np.array_equal(got["leaf_value"], plain["leaf_value"])


def test_wave_fused_gate():
    cfg = PG.GrowerConfig(leaf_batch=4)
    rep = lambda **kw: PG.GrowerConfig(**{**cfg.__dict__, **kw})
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not PG.wave_fused_for(cfg, cpu)        # auto: unfused on the CPU
    assert PG.wave_fused_for(cfg, cuda)           # ... the kernel on CUDA
    assert PG.wave_fused_for(rep(wave_kernel="fused"), cpu)
    assert not PG.wave_fused_for(rep(wave_kernel="unfused"), cuda)
    assert not PG.wave_fused_for(rep(histogram_impl="segment"), cuda)
    # flat_bf16: auto keeps the unfused wave (each smaller sibling through
    # the bf16 histogram), fused forces the bf16 wave kernel
    assert not PG.wave_fused_for(rep(histogram_impl="flat_bf16"), cuda)
    assert PG.wave_fused_for(rep(histogram_impl="flat_bf16",
                                 wave_kernel="fused"), cuda)
    with pytest.raises(ValueError, match="wave_kernel"):
        PG.wave_fused_for(rep(wave_kernel="bogus"), cpu)


P1023 = dict(P, max_bin=1023)


@pytest.mark.parametrize("leaf_batch", [1, 16])
def test_max_bin_1023_bitwise_vs_jax(grown, leaf_batch):
    """The port's auto and unfused steps against JAX's auto (unfused on
    the CPU), and its fused step (``fused_wave_call``'s plain version)
    against JAX's fused kernel (interpret mode; at F = 12 its wave_layout
    fits 1,023 bins)."""
    X, y, g, h = grown
    want, rl = jax_grow(X, y, P1023, g, h, leaf_batch=leaf_batch)
    assert want["num_leaves"] == 31
    assert int(want["split_bin"].max()) > 255
    for kernel in ("auto", "unfused"):
        got, prl = port_grow(X, y, P1023, g, h, leaf_batch=leaf_batch,
                             wave_kernel=kernel)
        assert_same_tree(want, got, rl, prl)
    want_f, rl_f = jax_grow(X, y, P1023, g, h, leaf_batch=leaf_batch,
                            wave_kernel="fused")
    got, prl = port_grow(X, y, P1023, g, h, leaf_batch=leaf_batch,
                         wave_kernel="fused")
    assert_same_tree(want_f, got, rl_f, prl)


@pytest.mark.parametrize("layout", ["wave", "mask", "fused_leaf_batch_1",
                                    "fused_leaf_batch_16"])
def test_max_bin_1023_quantized_bitwise_vs_jax(quant_data, layout):
    """Quantized at max_bin 1023: the default step (unfused on the CPU)
    and the mask layout against JAX's own, and the fused step against
    JAX's fused kernel (interpret mode) at leaf_batch 1 and 16."""
    X, y, g, h = quant_data
    kw = dict(Q, leaf_batch=16)
    params = P1023
    if layout == "mask":
        n = 2000
        X, y, g, h = X[:n], y[:n], g[:n], h[:n]
        params = dict(P1023, min_data_in_leaf=5)
    elif layout.startswith("fused"):
        kw = dict(Q, leaf_batch=int(layout.rsplit("_", 1)[1]),
                  wave_kernel="fused")
    want, rl = jax_grow(X, y, params, g, h, **kw)
    got, prl = port_grow(X, y, params, g, h, **kw)
    assert want["num_leaves"] > 8
    assert_same_tree(want, got, rl, prl)


def test_wave_fused_gate_above_256_bins():
    """``auto`` fuses on CUDA at every bin count the kernel takes (257 to
    65,536), ``fused`` forces the fused step on the CPU too and
    ``unfused`` keeps the unfused one.  The deliberate difference from
    the JAX package, whose gate fuses only where its TPU VMEM model
    ``wave_layout`` fits: at F = 28 it stays unfused at 1,023 bins, and
    at F = 64 (f32) even at 256, where the port fuses."""
    from lightgbm_tpu.ops.pallas_wave import wave_layout
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for b in (257, 511, 1023, 65536):
        assert PG.wave_fused_for(PG.GrowerConfig(num_bins=b), cuda)
        assert not PG.wave_fused_for(PG.GrowerConfig(num_bins=b), cpu)
        assert PG.wave_fused_for(
            PG.GrowerConfig(num_bins=b, wave_kernel="fused"), cpu)
        assert not PG.wave_fused_for(
            PG.GrowerConfig(num_bins=b, wave_kernel="unfused"), cuda)
    assert PG.wave_fused_for(PG.GrowerConfig(num_bins=256), cuda)
    assert not wave_layout(28, 1023, "f32")["fits"]
    assert not wave_layout(64, 256, "f32")["fits"]


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_batch", [1, 16])
def test_kernel_path_matches_plain(grown, cuda_device, leaf_batch):
    """The grower on the card (histogram kernel for the root, wave kernel
    for every wave) gives the CPU plain version's trees bit for bit."""
    X, y, g, h = grown
    want, rl = port_grow(X, y, P, g, h, leaf_batch=leaf_batch,
                         wave_kernel="fused")
    h0, w0 = HF.launches["f32"], WV.launches["f32"]
    got, prl = port_grow(X, y, P, g, h, leaf_batch=leaf_batch,
                         device=cuda_device)
    assert HF.launches["f32"] == h0 + 1 and WV.launches["f32"] > w0
    assert_same_tree(want, got, rl, prl)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quantized"])
def test_sorted_categorical_kernel_path_matches_plain(cuda_device, quant):
    """A 40-category feature (the sorted many-vs-many scan merged into
    each wave's payload on the card): the fused kernel path and the
    unfused path on the card give the CPU plain version's trees bit for
    bit."""
    rng = np.random.RandomState(13)
    n = 3 * 2560
    cat = rng.randint(0, 40, n).astype(np.float64)
    X = np.column_stack([cat, rng.randn(n, 3)])
    y = (((np.arange(40) * 7 % 5) < 2)[cat.astype(int)]
         ^ (X[:, 1] > 1.0)).astype(np.float64)
    g, h = pow2_scale_grads(n) if quant else exact_grads(n)
    kw = dict(categorical=[0], leaf_batch=4,
              **(dict(quantized=True, stochastic_rounding=False)
                 if quant else {}))
    want, rl = port_grow(X, y, P, g, h, wave_kernel="fused", **kw)
    m = want["num_leaves"] - 1
    assert (want["cat_mask"][:m][want["is_cat"][:m]].sum(axis=1) > 1).any()
    mode = "int8" if quant else "f32"
    w0 = WV.launches[mode]
    got, prl = port_grow(X, y, P, g, h, device=cuda_device, **kw)
    assert WV.launches[mode] > w0
    assert_same_tree(want, got, rl, prl)
    got, prl = port_grow(X, y, P, g, h, device=cuda_device,
                         wave_kernel="unfused", **kw)
    assert_same_tree(want, got, rl, prl)


@pytest.mark.cuda
@pytest.mark.parametrize("leaf_batch", [1, 16])
def test_quantized_kernel_path_matches_plain(quant_data, cuda_device,
                                             leaf_batch):
    """Quantized growth on the card (the int8 modes of both kernels, no
    f32 launch) gives the CPU plain version's trees bit for bit."""
    X, y, g, h = quant_data
    want, rl = port_grow(X, y, P, g, h, leaf_batch=leaf_batch,
                         wave_kernel="fused", **Q)
    before = (HF.launches["f32"], WV.launches["f32"], HF.launches["int8"],
              WV.launches["int8"])
    got, prl = port_grow(X, y, P, g, h, leaf_batch=leaf_batch,
                         device=cuda_device, **Q)
    assert (HF.launches["f32"], WV.launches["f32"]) == before[:2]
    assert HF.launches["int8"] == before[2] + 1
    assert WV.launches["int8"] > before[3]
    assert_same_tree(want, got, rl, prl)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quantized"])
def test_packed4_kernel_path_matches_plain(data16, cuda_device, quant):
    """Growth over packed bins on the card runs only the packed4 modes of
    both kernels and gives the CPU plain version's trees bit for bit."""
    X, y, exact, pow2 = data16
    g, h = pow2 if quant else exact
    kw = dict(Q, packed4=True) if quant else dict(packed4=True)
    mode = "int8_packed4" if quant else "f32_packed4"
    want, rl = port_grow(X, y, P15, g, h, leaf_batch=16,
                         wave_kernel="fused", **kw)
    hist0, wave0 = dict(HF.launches), dict(WV.launches)
    got, prl = port_grow(X, y, P15, g, h, leaf_batch=16, device=cuda_device,
                         **kw)
    hist_new = {k: HF.launches[k] - hist0[k] for k in HF.MODES}
    wave_new = {k: WV.launches[k] - wave0[k] for k in WV.MODES}
    assert hist_new == {**dict.fromkeys(HF.MODES, 0), mode: 1}
    assert wave_new[mode] > 0 and sum(wave_new.values()) == wave_new[mode]
    assert_same_tree(want, got, rl, prl)


@pytest.mark.cuda
@pytest.mark.parametrize("wave_kernel", ["auto", "fused"])
def test_bf16_kernel_path_matches_plain(grown, cuda_device, wave_kernel):
    """flat_bf16 growth on the card: ``auto`` builds the root and every
    smaller sibling with the bf16 histogram, ``fused`` runs the bf16 wave
    kernel; both give the CPU plain version's trees bit for bit."""
    X, y, g, h = grown
    want, rl = port_grow(X, y, P, g, h, leaf_batch=16,
                         histogram_impl="flat_bf16")
    hist0, wave0 = HF.launches["bf16"], WV.launches["bf16"]
    got, prl = port_grow(X, y, P, g, h, leaf_batch=16, device=cuda_device,
                         histogram_impl="flat_bf16", wave_kernel=wave_kernel)
    if wave_kernel == "fused":
        assert HF.launches["bf16"] == hist0 + 1
        assert WV.launches["bf16"] > wave0
    else:
        assert HF.launches["bf16"] > hist0 + 1
        assert WV.launches["bf16"] == wave0
    assert_same_tree(want, got, rl, prl)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,wave_kernel", [
    ("f32", "auto"), ("int8", "auto"), ("bf16", "fused"), ("f32", "unfused"),
    ("int8", "unfused"), ("bf16", "auto")])
@pytest.mark.parametrize("leaf_batch", [1, 16])
def test_uint16_kernel_path_matches_plain(grown, quant_data, cuda_device,
                                          mode, wave_kernel, leaf_batch):
    """Growth over uint16 bins (max_bin 1023) on the card gives the CPU
    plain version's trees bit for bit.  Fused (``auto`` in f32 and int8,
    ``fused`` for bf16) it launches the histogram kernel's uint16 mode of
    its value type once (the root) and the wave kernel's in every wave;
    unfused (``unfused``, and ``auto`` under flat_bf16) the histogram once
    per root and smaller sibling and no wave kernel."""
    X, y, g, h = quant_data if mode == "int8" else grown
    kw = dict(Q) if mode == "int8" else {}
    if mode == "bf16":
        kw["histogram_impl"] = "flat_bf16"
    want, rl = port_grow(X, y, P1023, g, h, leaf_batch=leaf_batch, **kw)
    hist0, wave0 = dict(HF.launches), dict(WV.launches)
    got, prl = port_grow(X, y, P1023, g, h, leaf_batch=leaf_batch,
                         device=cuda_device, wave_kernel=wave_kernel, **kw)
    key = f"{mode}_uint16"
    hist_new = {k: HF.launches[k] - hist0[k] for k in HF.MODES}
    wave_new = {k: WV.launches[k] - wave0[k] for k in WV.MODES}
    fused = wave_kernel == "fused" or (wave_kernel == "auto"
                                       and mode != "bf16")
    assert hist_new == {**dict.fromkeys(HF.MODES, 0),
                        key: 1 if fused else got["num_leaves"]}
    if fused:
        assert wave_new[key] > 0 and sum(wave_new.values()) == wave_new[key]
    else:
        assert not any(wave_new.values())
    assert_same_tree(want, got, rl, prl)
