"""Fused wave step parity: ``ops/wave.py::fused_wave_call`` on a CPU
tensor (the plain version of the CUDA wave kernel ``ops/csrc/wave.cu``)
against the same step assembled from the JAX package's ops — its
``histogram_segment`` for each smaller sibling, parent subtraction, the
(left, right) order, then ``scan_tables`` + ``select_payload`` per child —
bit for bit on exact-sum values, with inactive slots (gain -inf); and
its int8 mode (int8 levels, int32 histograms, the scan reading each cell
times its channel's scale) against the same JAX ops on power-of-two
scales, where every scaled sum is exact.  The bf16 and packed4 modes
(bf16, f32_packed4, bf16_packed4, int8_packed4) of ``wave_plain`` against
the JAX package's ``fused_wave_call`` itself (interpret mode, F = 7: the
packed4 nibble planes with a phantom feature), its outputs mapped back
through ``hist_from_flat``: child histograms and payloads bitwise on
exact sums.

On the card (``cuda`` marker): the kernel against its plain version at
W in {1, 16}, sibling sizes from 1 row to 100k rows, child histograms and
payloads bitwise on exact-sum values; on random values run-to-run bitwise
and held by ``chip_smoke.py``'s ``wave_agreement`` (child histograms
within 1e-5 relative of the float64 sum of the same cells, payloads to
the plain version; its own checks are pinned here on the CPU).  int8
mode: child histograms bitwise on any levels, payloads bitwise on
power-of-two scales and within ``wave_agreement`` on random scales.  The
bf16 and packed4 modes against their plain versions the same way at F =
28 and 27, and bitwise against the kernel's own f32 launch on the
bf16-rounded values and unpacked launch on the same rows.

uint16 bins (more than 256 bins): on the CPU ``fused_wave_call`` (its
plain version) is the JAX ops' step bit for bit at B = 511 in f32, int8
and bf16; ``wave_plain``'s three uint16 modes are JAX
``fused_wave_call``'s (interpret mode, F = 7, B = 511) bit for bit on
exact sums, and so is the chunked twin.  On the card the uint16 kernel
modes against their plain versions and twins at B from 257 to 8,193 and
65,536, W = 1, 4 and 16, F = 28 and 27; an exact gain tie across two of
the scan's blocks, which must select the lower key; and waves with no
valid split.  On the CPU, the chunk layout the uint16 kernels' sums
depend on."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device  # noqa: F401
from torch_port_util import order_sensitive_vals, sequential_chunk_hist

from lightgbm_tpu_torch.ops import wave as WV
from lightgbm_tpu_torch.ops.histogram import (histogram_segment, pack_bins4,
                                              unpack_bins4)
from lightgbm_tpu_torch.ops.split import SplitConfig


#: int8 mode channel scales: powers of two (every scaled sum exact), and
#: ordinary ones
POW2_SCALES = np.array([2.0 ** -6, 2.0 ** -9, 1.0], np.float32)
RANDOM_SCALES = np.array([0.0123, 0.00391, 1.0], np.float32)


def wave_inputs(n, f, b, sizes, seed, exact, device="cpu", scales=None,
                mode="f32", edit=None):
    """A wave over a random permutation: slot w's parent is the perm range
    [start_w, start_w + 2 * size_w) (clipped to n), its smaller sibling the
    first ``size_w`` positions (or the last, for odd w); slot 2 is
    inactive.  With ``scales`` (int8 mode) the values are int8 levels, the
    parents int32 and the stats the scaled sums.  A ``mode`` starting with
    bf16 rounds the values to bf16 (exact ones are k/256, exact in bf16
    and in every f32 sum) and passes them as bf16; one ending in packed4
    packs the bins (``aux`` keeps them unpacked).  ``edit(bins,
    nan_feats)`` may change the bins and which features have a NaN bin, in
    place, before the parents are summed."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, b, (n, f)).astype(np.uint8 if b <= 256
                                            else np.uint16)
    nan_feats = rng.rand(f) < 0.5
    bins[(rng.rand(n, f) < 0.05) & nan_feats[None, :]] = b - 1
    if edit is not None:
        edit(bins, nan_feats)
    if scales is not None:
        g = rng.randint(-127, 128, n)
        h = rng.randint(0, 128, n)
        vals = np.stack([g, h, np.ones(n, np.int64)], axis=1).astype(np.int8)
    else:
        if exact and mode.startswith("bf16"):
            g = (rng.randint(-255, 256, n) / 256.0).astype(np.float32)
            h = (rng.randint(13, 256, n) / 256.0).astype(np.float32)
        elif exact:
            g = rng.choice([-0.5, 0.5], n).astype(np.float32)
            h = np.full(n, 0.25, np.float32)
        else:
            g = rng.randn(n).astype(np.float32)
            h = (rng.rand(n) + 0.05).astype(np.float32)
        vals = np.stack([g, h, np.ones(n, np.float32)], axis=1)
        if mode.startswith("bf16"):
            vals = torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
    perm = rng.permutation(n).astype(np.int32)
    w = len(sizes)
    starts, small_start, small_cnt, parents, stats = [], [], [], [], []
    pos = 0
    for j, s in enumerate(sizes):
        cnt = min(2 * s, n - pos)
        rows = perm[pos:pos + cnt]
        parent = histogram_segment(torch.from_numpy(bins[rows]),
                                   torch.from_numpy(vals[rows]),
                                   num_bins=b)
        small_left = j % 2 == 0
        s0 = pos if small_left else pos + cnt - s
        lrows = perm[pos:pos + s] if small_left else perm[pos:pos + cnt - s]
        left = vals[lrows].sum(axis=0, dtype=np.float64).astype(np.float32)
        tot = parent[0].sum(dim=0).numpy()
        if scales is not None:
            left = left * scales
            tot = tot.astype(np.float32) * scales
        right = tot - left
        out_l = -left[0] / (left[1] + np.float32(1e-15))
        out_r = -right[0] / (right[1] + np.float32(1e-15))
        stats.append([[left[0], left[1], left[2], out_l, float(small_left),
                       float(j != 2), 0, 0],
                      [right[0], right[1], right[2], out_r,
                       float(small_left), float(j != 2), 0, 0]])
        small_start.append(s0)
        small_cnt.append(s)
        parents.append(parent)
        pos += cnt
    nbpf = np.full(f, b, np.int32)
    nanb = np.where(nan_feats, b - 1, b).astype(np.int32)
    is_cat = np.zeros(f, bool)
    fmask = np.ones(f, bool)
    fmask[-1] = False
    t = lambda a: torch.as_tensor(a, device=device)
    meta = WV.wave_meta(t(nbpf), t(nanb), t(is_cat), t(fmask))
    packed4 = mode.endswith("packed4")
    tbins = pack_bins4(t(bins)) if packed4 else t(bins)
    tvals = t(vals).to(torch.bfloat16) if mode.startswith("bf16") else t(vals)
    inp = dict(bins=tbins, vals=tvals, perm=t(perm), packed4=packed4,
               small_start=small_start, small_cnt=small_cnt,
               parent=torch.stack(parents).to(device),
               stats=t(np.asarray(stats, np.float32)), meta=meta,
               num_bins=b)
    if scales is not None:
        inp["scale3"] = t(scales)
    return inp, (nbpf, nanb, is_cat, fmask, bins, vals, perm)


CFG = SplitConfig(min_data_in_leaf=1, min_sum_hessian_in_leaf=0.5,
                  lambda_l2=0.25, has_categorical=False)


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_plain_wave_bitwise_vs_jax_ops(mode):
    _check_wave_vs_jax_ops(mode, 40, WV.fused_wave_call)


@pytest.mark.parametrize("mode", ["f32", "int8", "bf16"])
def test_uint16_plain_wave_bitwise_vs_jax_ops(mode):
    """Over uint16 bins (B = 511) ``fused_wave_call`` on the CPU (its
    plain version) is the JAX ops' step bit for bit, and so is the
    unfused step ``wave_plain`` with them; uint8 bins cannot hold 511
    bins."""
    inp = _check_wave_vs_jax_ops(mode, 511, WV.fused_wave_call)
    assert inp["bins"].dtype == torch.uint16
    hist, pay = WV.fused_wave_call(cfg=CFG, **inp)
    hp, pp = WV.wave_plain(cfg=CFG, **inp)
    assert torch.equal(hist, hp) and torch.equal(pay, pp)
    with pytest.raises(ValueError, match="num_bins=511"):
        WV.fused_wave_call(cfg=CFG, **dict(inp, bins=inp["bins"].to(
            torch.uint8)))


def _check_wave_vs_jax_ops(mode, b, wave):
    """``wave(cfg, **inputs)`` over ``b`` bins against the step assembled
    from the JAX package's ops, bit for bit on exact sums (bf16: exact in
    bf16 too, the JAX ops summing the rounded values in f32); returns the
    inputs."""
    import jax.numpy as jnp

    from lightgbm_tpu.ops import split as JS
    from lightgbm_tpu.ops.histogram import histogram_segment as jseg
    sizes = [700, 1, 33, 2048, 5]
    scales = POW2_SCALES if mode == "int8" else None
    inp, (nbpf, nanb, is_cat, fmask, bins, vals, perm) = wave_inputs(
        9000, 5, b, sizes, seed=1, exact=True, scales=scales, mode=mode)
    hist, pay = wave(cfg=CFG, **inp)
    assert hist.dtype == (torch.int32 if scales is not None
                          else torch.float32)
    jcfg = JS.SplitConfig(min_data_in_leaf=1, min_sum_hessian_in_leaf=0.5,
                          lambda_l2=0.25, has_categorical=False,
                          use_sorted_categorical=False, has_monotone=False)
    stats = inp["stats"].numpy()
    for j, (s0, s) in enumerate(zip(inp["small_start"], inp["small_cnt"])):
        rows = perm[s0:s0 + s]
        small = np.asarray(jseg(jnp.asarray(bins[rows]),
                                jnp.asarray(vals[rows]), num_bins=b))
        big = inp["parent"][j].numpy() - small
        pair = (small, big) if stats[j, 0, 4] > 0.5 else (big, small)
        np.testing.assert_array_equal(hist[j, 0].numpy(), pair[0])
        np.testing.assert_array_equal(hist[j, 1].numpy(), pair[1])
        for c in range(2):
            st = stats[j, c]
            child = pair[c] if scales is None else (
                np.asarray(jnp.asarray(pair[c]).astype(jnp.float32)
                           * jnp.asarray(scales)))
            t = JS.scan_tables(
                *(jnp.asarray(child[..., k]) for k in range(3)),
                *(jnp.asarray(v) for v in st[:3]),
                num_bins_per_feature=jnp.asarray(nbpf),
                nan_bins=jnp.asarray(nanb),
                is_categorical=jnp.asarray(is_cat),
                feature_mask=jnp.asarray(fmask), cfg=jcfg,
                parent_output=jnp.asarray(st[3]))
            want = [np.float32(v) for v in
                    JS.select_payload(t, jnp.asarray(is_cat), jcfg)]
            if st[5] < 0.5:
                want[0] = np.float32("-inf")
            np.testing.assert_array_equal(pay[j, c, :11].numpy(),
                                          np.asarray(want, np.float32))
            assert not pay[j, c, 11:].any()      # pad lanes, no categorical
    best = WV.payload_to_best(WV.split_payload(pay))
    assert best.gain.shape == (2 * len(sizes),)
    assert np.isinf(float(best.gain[2])) and np.isinf(float(best.gain[7]))
    return inp


NEW_MODES = ["bf16", "f32_packed4", "bf16_packed4", "int8_packed4"]


def jax_fused_wave(inp, aux, dtype, scales=None, rows_block=1024):
    """The JAX package's ``fused_wave_call`` (interpret mode) on the same
    wave: each smaller sibling's rows gathered (padded with a zero row),
    the parents in its flat plane layout, its own ``wave_meta``, row
    blocks of at most ``rows_block``; outputs mapped back to (W, 2, F, B,
    3) original-order histograms and the (W, 2, 16 + B) payload."""
    import jax.numpy as jnp

    from lightgbm_tpu.ops import pallas_wave as PW
    from lightgbm_tpu.ops import split as JS
    from lightgbm_tpu.ops.pallas_common import C_PAD
    nbpf, nanb, is_cat, fmask, bins, vals, perm = aux
    n, f = bins.shape
    b, packed4 = inp["num_bins"], inp["packed4"]
    lay = PW.wave_layout(f, b, dtype, 0, packed4)
    order, inverse = PW.plane_order(f, packed4)
    meta = PW.wave_meta(jnp.asarray(nbpf), jnp.asarray(nanb),
                        jnp.asarray(is_cat), jnp.asarray(fmask), features=f,
                        num_bins=b, packed4=packed4)
    parent = PW.hist_to_flat(jnp.asarray(inp["parent"].numpy()),
                             lay["ftile"], lay["b_pad"], order)
    jb = inp["bins"].numpy()
    jb = np.concatenate([jb, np.zeros((1, jb.shape[1]), np.uint8)])
    jv = np.concatenate([vals, np.zeros((1, 3), vals.dtype)])
    s = max(inp["small_cnt"])
    rows = np.full((len(inp["small_cnt"]), s), n, np.int64)
    for w, (s0, c) in enumerate(zip(inp["small_start"], inp["small_cnt"])):
        rows[w, :c] = perm[s0:s0 + c]
    gvals = jnp.pad(jnp.asarray(jv[rows]), ((0, 0), (0, 0), (0, C_PAD - 3)))
    jcfg = JS.SplitConfig(min_data_in_leaf=1, min_sum_hessian_in_leaf=0.5,
                          lambda_l2=0.25, has_categorical=False,
                          use_sorted_categorical=False, has_monotone=False)
    scale3 = (None if scales is None else jnp.asarray(
        np.append(scales, 0).reshape(1, 4).astype(np.float32)))
    hist, pay = PW.fused_wave_call(
        jnp.asarray(jb[rows]), jnp.transpose(gvals, (0, 2, 1)), parent,
        jnp.asarray(inp["stats"].numpy()), meta, scale3, num_bins=b,
        features=f, rows_block=min(rows_block, s), dtype=dtype,
        packed4=packed4,
        scfg=jcfg, interpret=True)
    return (np.asarray(PW.hist_from_flat(hist, f, b, lay["b_pad"], inverse)),
            np.asarray(pay))


@pytest.mark.parametrize("mode", NEW_MODES)
def test_new_modes_plain_bitwise_vs_jax_fused_wave_call(mode):
    packed4 = mode.endswith("packed4")
    scales = POW2_SCALES if mode.startswith("int8") else None
    inp, aux = wave_inputs(3000, 7, 16 if packed4 else 40,
                           [300, 1, 33, 200, 5], seed=1, exact=True,
                           scales=scales, mode=mode)
    assert inp["bins"].shape[1] == (4 if packed4 else 7)
    hist, pay = WV.fused_wave_call(cfg=CFG, **inp)
    want_h, want_p = jax_fused_wave(inp, aux, mode.split("_")[0], scales)
    np.testing.assert_array_equal(hist.numpy(), want_h)
    np.testing.assert_array_equal(pay.numpy(), want_p)
    assert np.isfinite(want_p[:, :, 0]).sum() >= 4   # real splits compared
    # the plain wave of a mode is the f32 / unpacked one on the same rows
    f32, _ = wave_inputs(3000, 7, 16 if packed4 else 40, [300, 1, 33, 200, 5],
                         seed=1, exact=True, scales=scales,
                         mode="bf16" if mode.startswith("bf16") else "f32")
    f32["vals"] = f32["vals"].float() if scales is None else f32["vals"]
    f32["packed4"] = False
    h32, p32 = WV.fused_wave_call(cfg=CFG, **f32)
    assert torch.equal(hist, h32) and torch.equal(pay, p32)


U16_MODES = ["f32_uint16", "bf16_uint16", "int8_uint16"]


@pytest.mark.parametrize("mode", U16_MODES)
def test_uint16_modes_plain_bitwise_vs_jax_fused_wave_call(mode):
    """The uint16 modes (B = 511) of ``wave_plain`` against the JAX
    package's ``fused_wave_call`` itself (interpret mode, F = 7; bf16 at
    128-row blocks, the only size its CPU path runs): child histograms
    and payloads bit for bit on exact sums."""
    kind = mode.split("_")[0]
    scales = POW2_SCALES if kind == "int8" else None
    inp, aux = wave_inputs(3000, 7, 511, [300, 1, 33, 200, 5], seed=2,
                           exact=True, scales=scales, mode=kind)
    assert inp["bins"].dtype == torch.uint16
    hist, pay = WV.wave_plain(cfg=CFG, **inp)
    want_h, want_p = jax_fused_wave(inp, aux, kind, scales,
                                    rows_block=128 if kind == "bf16" else 1024)
    np.testing.assert_array_equal(hist.numpy(), want_h)
    np.testing.assert_array_equal(pay.numpy(), want_p)
    assert np.isfinite(want_p[:, :, 0]).sum() >= 4   # real splits compared
    assert int(want_p[:, :, 2].max()) > 255           # past the uint8 range


TWIN_MODES = ["f32", "bf16", "f32_packed4", "bf16_packed4"]
HIST_ARGS = ("bins", "vals", "perm", "small_start", "small_cnt", "parent",
             "stats", "num_bins")


@pytest.mark.parametrize("mode", TWIN_MODES + ["f32_uint16", "bf16_uint16"])
def test_wave_chunked_twin_vs_plain_and_jax(mode):
    """``wave_hists_chunked`` (the plain twin of the kernel's summation
    order: segment_table's chunks, the subtraction, the (left, right)
    order) equals ``wave_plain``'s child histograms and JAX
    ``fused_wave_call``'s bit for bit on exact sums, and the plain
    version's within 1e-5 relative on random values; over uint16 bins at
    B = 511.  Slot 0's smaller sibling spans two chunks."""
    packed4 = mode.endswith("packed4")
    b = 16 if packed4 else 511 if mode.endswith("uint16") else 40
    for exact in (True, False):
        inp, aux = wave_inputs(3000, 7, b, [1100, 1, 33, 200, 5], seed=5,
                               exact=exact, mode=mode)
        got = WV.wave_hists_chunked(*(inp[k] for k in HIST_ARGS),
                                    packed4=packed4)
        hp, _ = WV.wave_plain(cfg=CFG, **inp)
        assert got.shape == hp.shape and got.dtype == torch.float32
        if exact:
            assert torch.equal(got, hp)
            want_h, _ = jax_fused_wave(inp, aux, mode.split("_")[0])
            np.testing.assert_array_equal(got.numpy(), want_h)
        else:
            scale = float(hp[..., :2].abs().max())
            assert float((got - hp).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("mode", ["f32", "bf16_packed4"])
def test_wave_chunked_twin_keeps_segment_table_chunking(mode):
    """On values whose f32 sums depend on their order, the twin's smaller
    siblings equal the summation order written out as loops over each
    perm range in ``segment_table``'s chunks (one of 2,500 rows spans
    three), the larger siblings parent - smaller."""
    packed4 = mode.endswith("packed4")
    b = 16 if packed4 else 40
    sizes = [2500, 1, 33, 1100, 5]
    inp, aux = wave_inputs(9000, 5, b, sizes, seed=6, exact=False, mode=mode)
    vals = order_sensitive_vals(9000, seed=6)
    if mode.startswith("bf16"):
        vals = torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
    inp["vals"] = torch.from_numpy(vals).to(inp["vals"].dtype)
    got = WV.wave_hists_chunked(*(inp[k] for k in HIST_ARGS),
                                packed4=packed4)
    chunk_rows, offs = WV.segment_table(sizes, 5, b)
    assert chunk_rows == WV.MIN_CHUNK_ROWS and offs[1] == 3
    bins, perm = aux[4], aux[6]
    for w, (s0, cnt) in enumerate(zip(inp["small_start"], sizes)):
        rows = perm[s0:s0 + cnt]
        small = sequential_chunk_hist(bins[rows], vals[rows], b, chunk_rows)
        big = inp["parent"][w].numpy() - small
        left_small = bool(inp["stats"][w, 0, 4] > 0.5)
        np.testing.assert_array_equal(got[w, 0 if left_small else 1].numpy(),
                                      small)
        np.testing.assert_array_equal(got[w, 1 if left_small else 0].numpy(),
                                      big)


def test_shape_and_device_checks():
    inp, _ = wave_inputs(3000, 3, 16, [10, 20], seed=2, exact=True)
    bad = dict(inp, small_cnt=[10])
    with pytest.raises(ValueError, match="wave shapes"):
        WV.fused_wave_call(cfg=CFG, **bad)
    with pytest.raises(ValueError, match="scale3"):
        WV.fused_wave_call(cfg=CFG, **inp, scale3=torch.ones(3))
    q, _ = wave_inputs(3000, 3, 16, [10, 20], seed=2, exact=True,
                       scales=POW2_SCALES)
    with pytest.raises(ValueError, match="scale3"):
        WV.fused_wave_call(cfg=CFG, **dict(q, scale3=None))
    with pytest.raises(ValueError, match="wave shapes"):
        WV.fused_wave_call(cfg=CFG, **dict(q, scale3=torch.ones(4)))
    p4, _ = wave_inputs(3000, 5, 16, [10, 20], seed=2, exact=True,
                        mode="f32_packed4")
    with pytest.raises(ValueError, match="wave shapes"):
        WV.fused_wave_call(cfg=CFG, **dict(p4, packed4=False))
    with pytest.raises(ValueError, match="columns"):
        WV.fused_wave_call(cfg=CFG, **dict(p4, bins=inp["bins"][:, :2],
                                           vals=p4["vals"]))
    rows, offs = WV.segment_table([1, 0, 100_000], 28, 255, int8=True)
    assert rows >= WV.MIN_CHUNK_ROWS_INT8 and offs[-1] <= WV.MAX_CHUNKS
    chunk_rows, offs = WV.segment_table([1, 0, 100_000], 28, 255)
    assert offs[0] == 0 and offs[2] == offs[1] + 0 and offs[-1] >= 1
    assert chunk_rows >= WV.MIN_CHUNK_ROWS


ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _fault(cs, h, p, kind):
    """A copy of a wave's ``(hists, payload)`` with one planted fault."""
    bound = cs.wave_gain_bound(p.reshape(-1, p.shape[-1]),
                               h.reshape(-1, *h.shape[-3:]))
    h, p = h.clone(), p.clone()
    k = int(torch.isfinite(p[:, :, 0]).reshape(-1).nonzero()[0])
    pk = p.reshape(-1, p.shape[-1])
    if kind == "hist_grad":
        h[0, 1, 0, 3, 0] += 1e-3 * h[..., 0].abs().max()
    elif kind == "hist_count":
        h[0, 0, 1, 2, 2] += 1.0
    elif kind == "gain":
        pk[k, 0] += 2 * bound[k]
    elif kind == "winner_count":
        pk[k, 7] += 1.0
    elif kind == "winner_sum":
        pk[k, 5] += 1e-3 * pk[:, [5, 6, 8, 9]].abs().max()
    elif kind == "split_set":
        pk[k, 0] = float("-inf")
    elif kind == "other_winner_same_gain":
        pk[k, 2] += 1.0
        pk[k, 5:11] += 1.0                 # another winner's sums may differ
    return h, p


def test_int8_wave_agrees_with_f32_wave_on_the_scaled_values():
    """On ordinary scales the int8 wave (int32 sums, then one multiply per
    cell) and the f32 wave on the values times the scales (f32 sums) round
    differently; ``wave_agreement`` holds them together: scaled histograms
    within 1e-5, counts equal, gains within the scan's rounding bound."""
    q, _ = wave_inputs(9000, 5, 40, [700, 33, 2048, 5], seed=6, exact=True,
                       scales=RANDOM_SCALES)
    h8, p8 = WV.wave_plain(cfg=CFG, **q)
    f = dict(q, vals=q["vals"].float() * q["scale3"],
             parent=WV.scale_hist(q["parent"], q["scale3"]))
    del f["scale3"]
    h32, p32 = WV.wave_plain(cfg=CFG, **f)
    got = _chip_smoke().wave_agreement(WV.scale_hist(h8, q["scale3"]), p8,
                                       h32, p32, q)
    assert got["splitting_children"] > 0


@pytest.mark.parametrize("kind", ["none", "other_winner_same_gain",
                                  "hist_grad", "hist_count", "gain",
                                  "winner_count", "winner_sum", "split_set"])
def test_wave_agreement_catches_faults(kind):
    """The tolerance check of the kernel on random values passes a wave
    that equals its plain version, and one whose winner differs at an
    equal gain; it raises on each other planted fault (a gain off by twice
    its rounding bound among them)."""
    cs = _chip_smoke()
    inp, _ = wave_inputs(9000, 5, 40, [700, 33, 2048, 5], seed=4,
                         exact=False)
    h, p = WV.wave_plain(cfg=CFG, **inp)
    hf, pf = _fault(cs, h, p, kind)
    if kind in ("none", "other_winner_same_gain"):
        got = cs.wave_agreement(hf, pf, h, p, inp)
        assert got["other_winner"] == (kind != "none")
        assert got["gain_err_over_bound"] == 0.0
        assert 0 < got["splitting_children"] <= 6  # slot 2 is inactive
    else:
        with pytest.raises(AssertionError):
            cs.wave_agreement(hf, pf, h, p, inp)


def test_bounds_count_what_the_function_needs():
    """Histogram: N*F*3 adds, so bytes bound it at the bench shape.  Wave:
    the siblings' adds, the subtraction and the scan of this run's live
    features, bins and NaN directions.  The bytes count the bins as
    stored (packed: ceil(F/2) a row; uint16: 2F) and the values' own
    width (bf16: 6 bytes a row)."""
    cs = _chip_smoke()
    nbytes, ops = cs.hist_bound_ms(200_000, 28, 255)
    assert nbytes == pytest.approx((200_000 * 40 + 28 * 255 * 12)
                                   / cs.HBM_BYTES_PER_S * 1e3)
    assert ops == pytest.approx(200_000 * 28 * 3 / cs.SCALAR_OPS_PER_S * 1e3)
    assert nbytes > ops
    gen = torch.Generator().manual_seed(0)
    inp = cs.wave_case(gen, torch.device("cpu"), [30, 7], exact=False, f=6,
                       b=10, inactive=(1,))
    _, ops = cs.wave_bound_ms(inp)
    # features 0-5: 3 is one-hot categorical (4 bins, one direction), 5 is
    # masked out; 0, 2, 4 have a NaN bin (two directions)
    cells, cands = 10 * 4 + 4, 10 * 2 * 3 + 10 + 4
    want = (37 * 6 * 3 + 2 * 6 * 10 * 3 + 2 * (
        cells * cs.SCAN_OPS_PER_BIN + cands * cs.SCAN_OPS_PER_DIRECTION))
    assert ops == pytest.approx(want / cs.SCALAR_OPS_PER_S * 1e3)
    # bf16 values (6 bytes a row) and packed bins (ceil(F/2) bytes a row)
    nbytes, _ = cs.hist_bound_ms(200_000, 28, 16, val_bytes=6, bin_bytes=14)
    assert nbytes == pytest.approx((200_000 * 20 + 28 * 16 * 12)
                                   / cs.HBM_BYTES_PER_S * 1e3)
    packed = cs.wave_case(gen, torch.device("cpu"), [30, 7], exact=False,
                          f=7, b=10, mode="bf16_packed4")
    assert packed["bins"].shape == (74, 4) and packed["packed4"]
    nbytes, _ = cs.wave_bound_ms(packed)
    hist = 7 * 10 * 12
    assert nbytes == pytest.approx((37 * (4 + 6 + 4) + 3 * 2 * hist + 2 * 2
                                    * (WV.PAYLOAD_SCALARS + 10) * 4)
                                   / cs.HBM_BYTES_PER_S * 1e3)
    # uint16 bins: two bytes a feature
    wide = cs.wave_case(gen, torch.device("cpu"), [30, 7], exact=False, f=6,
                        b=300)
    assert wide["bins"].dtype == torch.uint16
    nbytes, _ = cs.wave_bound_ms(wide)
    hist = 6 * 300 * 12
    assert nbytes == pytest.approx((37 * (2 * 6 + 12 + 4) + 3 * 2 * hist
                                    + 2 * 2 * (WV.PAYLOAD_SCALARS + 300) * 4)
                                   / cs.HBM_BYTES_PER_S * 1e3)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [[100_000], [1, 5, 0, 2047, 2048, 12_500,
                                               40_000, 3, 900, 1, 77, 4096,
                                               100_000, 10, 250, 6]],
                         ids=["W1", "W16"])
def test_kernel_matches_plain(cuda_device, sizes):
    sizes = [max(s, 1) for s in sizes]
    for exact in (True, False):
        inp, _ = wave_inputs(sum(2 * s for s in sizes), 28, 255, sizes,
                             seed=len(sizes), exact=exact,
                             device=cuda_device)
        launches = WV.launches["f32"]
        h1, p1 = WV.fused_wave_call(cfg=CFG, **inp)
        h2, p2 = WV.fused_wave_call(cfg=CFG, **inp)
        torch.cuda.synchronize()
        assert WV.launches["f32"] == launches + 2
        assert torch.equal(h1, h2) and torch.equal(p1, p2)
        hp, pp = WV.wave_plain(cfg=CFG, **inp)
        if exact:
            assert torch.equal(h1, hp) and torch.equal(p1, pp)
        else:
            _chip_smoke().wave_agreement(h1, p1, hp, pp, inp)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [[100_000], [1, 5, 0, 2047, 2048, 12_500,
                                               40_000, 3, 900, 1, 77, 4096,
                                               100_000, 10, 250, 6]],
                         ids=["W1", "W16"])
def test_int8_kernel_matches_plain(cuda_device, sizes):
    """int8 mode: child histograms bitwise always; payloads bitwise on
    power-of-two scales, within ``wave_agreement`` on ordinary ones."""
    sizes = [max(s, 1) for s in sizes]
    for scales in (POW2_SCALES, RANDOM_SCALES):
        inp, _ = wave_inputs(sum(2 * s for s in sizes), 28, 255, sizes,
                             seed=len(sizes), exact=True, device=cuda_device,
                             scales=scales)
        launches = WV.launches["int8"]
        h1, p1 = WV.fused_wave_call(cfg=CFG, **inp)
        h2, p2 = WV.fused_wave_call(cfg=CFG, **inp)
        torch.cuda.synchronize()
        assert WV.launches["int8"] == launches + 2
        assert torch.equal(h1, h2) and torch.equal(p1, p2)
        hp, pp = WV.wave_plain(cfg=CFG, **inp)
        assert h1.dtype == torch.int32 and torch.equal(h1, hp)
        if scales is POW2_SCALES:
            assert torch.equal(p1, pp)
        else:
            scaled = WV.scale_hist(hp, inp["scale3"])
            _chip_smoke().wave_agreement(scaled, p1, scaled, pp, inp)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", NEW_MODES)
@pytest.mark.parametrize("sizes", [[100_000], [1, 5, 0, 2047, 2048, 12_500,
                                               40_000, 3, 900, 1, 77, 4096,
                                               100_000, 10, 250, 6]],
                         ids=["W1", "W16"])
def test_new_mode_kernels_match_plain(cuda_device, mode, sizes):
    """bf16 / packed4 modes at F = 28 and 27: child histograms and
    payloads bitwise on exact sums (int8: histograms always, payloads on
    power-of-two scales), ``wave_agreement`` on random values, run-to-run
    bitwise, and bitwise equal to the kernel's own f32 launch on the
    bf16-rounded values and unpacked launch on the same rows."""
    sizes = [max(s, 1) for s in sizes]
    packed4 = mode.endswith("packed4")
    b = 16 if packed4 else 255
    int8 = mode.startswith("int8")
    for f in (28, 27):
        for exact in ((True,) if int8 else (True, False)):
            inp, _ = wave_inputs(sum(2 * s for s in sizes), f, b, sizes,
                                 seed=len(sizes) + f, exact=exact,
                                 device=cuda_device, mode=mode,
                                 scales=POW2_SCALES if int8 else None)
            launches = WV.launches[mode]
            h1, p1 = WV.fused_wave_call(cfg=CFG, **inp)
            h2, p2 = WV.fused_wave_call(cfg=CFG, **inp)
            base = dict(inp, packed4=False,
                        bins=unpack_bins4(inp["bins"], f).contiguous()
                        if packed4 else inp["bins"],
                        vals=inp["vals"] if int8 else inp["vals"].float())
            hb, pb = WV.fused_wave_call(cfg=CFG, **base)
            torch.cuda.synchronize()
            assert WV.launches[mode] == launches + 2
            assert torch.equal(h1, h2) and torch.equal(p1, p2)
            assert torch.equal(h1, hb) and torch.equal(p1, pb)
            hp, pp = WV.wave_plain(cfg=CFG, **inp)
            if exact:
                assert torch.equal(h1, hp) and torch.equal(p1, pp)
            else:
                _chip_smoke().wave_agreement(h1, p1, hp, pp, inp)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", TWIN_MODES)
@pytest.mark.parametrize("sizes", [[100_000], [1, 5, 0, 2047, 2048, 12_500,
                                               40_000, 3, 900, 1, 77, 4096,
                                               100_000, 10, 250, 6]],
                         ids=["W1", "W16"])
def test_kernel_child_hists_equal_chunked_twin(cuda_device, mode, sizes):
    """On random values the kernel's child histograms equal the twin of
    its summation order bit for bit (slot 2 inactive); its payloads stay
    within ``wave_agreement`` of the plain version."""
    sizes = [max(s, 1) for s in sizes]
    packed4 = mode.endswith("packed4")
    inp, _ = wave_inputs(sum(2 * s for s in sizes), 28, 16 if packed4 else 255,
                         sizes, seed=len(sizes) + 1, exact=False,
                         device=cuda_device, mode=mode)
    h, p = WV.fused_wave_call(cfg=CFG, **inp)
    want = WV.wave_hists_chunked(*(inp[k] for k in HIST_ARGS),
                                 packed4=packed4)
    hp, pp = WV.wave_plain(cfg=CFG, **inp)
    torch.cuda.synchronize()
    assert torch.equal(h, want)
    _chip_smoke().wave_agreement(h, p, hp, pp, inp)


@pytest.mark.cuda
@pytest.mark.parametrize("f,b", [(100, 255), (65, 16)])
def test_kernel_wide_features_equal_chunked_twin(cuda_device, f, b):
    """F cut into several feature groups (packed: odd F): child histograms
    bit for bit the twin on random values; payloads bitwise the plain
    version on exact sums."""
    packed4 = b == 16
    sizes = [3000, 1, 700, 2500]
    for exact in (False, True):
        inp, _ = wave_inputs(sum(2 * s for s in sizes), f, b, sizes,
                             seed=f, exact=exact, device=cuda_device,
                             mode="f32_packed4" if packed4 else "f32")
        h, p = WV.fused_wave_call(cfg=CFG, **inp)
        want = WV.wave_hists_chunked(*(inp[k] for k in HIST_ARGS),
                                     packed4=packed4)
        hp, pp = WV.wave_plain(cfg=CFG, **inp)
        torch.cuda.synchronize()
        assert torch.equal(h, want)
        if exact:
            assert torch.equal(h, hp) and torch.equal(p, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "int8", "f32_uint16", "bf16_uint16",
                                  "int8_uint16"])
def test_kernel_all_minus_inf_children(cuda_device, mode):
    """No child has a valid split (min_data_in_leaf above every count):
    every gain is -inf and each payload is key 0's candidate (feature 0,
    bin 0), bit for bit the plain version's; uint16 modes at B = 1,023,
    2,047 and 65,536 (a child's features spread over the scan's blocks,
    whose bests tie at -inf)."""
    none = SplitConfig(min_data_in_leaf=10 ** 9, min_sum_hessian_in_leaf=0.5,
                       lambda_l2=0.25, has_categorical=False)
    sizes = [5000, 1, 33, 2048]
    kind = mode.split("_")[0]
    for b in (1023, 2047, 65536) if mode.endswith("uint16") else (255,):
        inp, _ = wave_inputs(sum(2 * s for s in sizes), 28, b, sizes,
                             seed=9, exact=True, device=cuda_device,
                             scales=POW2_SCALES if kind == "int8" else None,
                             mode=kind)
        h, p = WV.fused_wave_call(cfg=none, **inp)
        hp, pp = WV.wave_plain(cfg=none, **inp)
        torch.cuda.synchronize()
        assert bool(torch.isinf(p[:, :, 0]).all())
        assert not bool(p[:, :, 1:3].any())
        assert torch.equal(h, hp) and torch.equal(p, pp)


#: uint16 waves on the card: W = 1, and W = 4 and 16 with slot 2 inactive
U16_WAVES = {"W1": [20_000], "W4": [2000, 1, 700, 1500],
             "W16": [1, 5, 1, 2047, 2048, 12_500, 3, 900, 1, 77, 4096, 10,
                     250, 6, 300, 40]}


def _check_uint16_kernel(mode, b, f, sizes, exact, device, seed):
    """One uint16 wave: run-to-run bitwise; on exact sums (int8: on
    power-of-two scales) child histograms and payloads bitwise the plain
    version; on random values child histograms bitwise the chunked twin
    (int8, random scales: the plain version's) and payloads within
    ``wave_agreement``."""
    kind = mode.split("_")[0]
    scales = None
    if kind == "int8":
        scales = POW2_SCALES if exact else RANDOM_SCALES
    inp, _ = wave_inputs(sum(2 * s for s in sizes), f, b, sizes, seed=seed,
                         exact=exact or kind == "int8", device=device,
                         scales=scales, mode=kind)
    assert inp["bins"].dtype == torch.uint16
    n0 = WV.launches[mode]
    h1, p1 = WV.fused_wave_call(cfg=CFG, **inp)
    h2, p2 = WV.fused_wave_call(cfg=CFG, **inp)
    hp, pp = WV.wave_plain(cfg=CFG, **inp)
    torch.cuda.synchronize()
    assert WV.launches[mode] == n0 + 2
    assert torch.equal(h1, h2) and torch.equal(p1, p2)
    if exact:
        assert torch.equal(h1, hp) and torch.equal(p1, pp)
    elif kind == "int8":
        assert torch.equal(h1, hp)
        scaled = WV.scale_hist(hp, inp["scale3"])
        _chip_smoke().wave_agreement(scaled, p1, scaled, pp, inp)
    else:
        want = WV.wave_hists_chunked(*(inp[k] for k in HIST_ARGS))
        assert torch.equal(h1, want)
        _chip_smoke().wave_agreement(h1, p1, hp, pp, inp)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [257, 511, 1023, 2047, 4095, 8192, 8193])
@pytest.mark.parametrize("mode", U16_MODES)
def test_uint16_kernel_matches_plain_and_twin(cuda_device, mode, b):
    """The uint16 modes at F = 28 and 27, W = 1, 4 and 16 (slot 2
    inactive), exact sums and random values (``_check_uint16_kernel``);
    past B = 4,096 the scan runs in tiles, at 8,193 stage 1 in two bin
    tiles."""
    for f in (28, 27):
        for name, sizes in U16_WAVES.items():
            for exact in (True, False):
                _check_uint16_kernel(mode, b, f, sizes, exact, cuda_device,
                                     seed=b + f + len(sizes))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", U16_MODES)
def test_uint16_kernel_65536_bins(cuda_device, mode):
    """B = 65,536 at W = 1 and a few hundred rows: stage 1 in eight bin
    tiles, the scan in 48."""
    for exact in (True, False):
        _check_uint16_kernel(mode, 65536, 28, [300], exact, cuda_device,
                             seed=11)


def _tie_edit(a, z):
    """Features ``a`` and ``z`` hold the same bins and NaN bin; every other
    feature one bin (no valid split)."""
    def edit(bins, nan_feats):
        keep = bins[:, a].copy()
        bins[:] = 0
        bins[:, a] = bins[:, z] = keep
        nan_feats[z] = nan_feats[a]
    return edit


@pytest.mark.cuda
@pytest.mark.parametrize("b", [257, 1023, 4095])
@pytest.mark.parametrize("mode", U16_MODES)
def test_uint16_scan_tie_across_blocks(cuda_device, mode, b):
    """An exact gain tie between features 1 and 25, which the uint16 scan
    puts in different blocks (a block per feature at F = 28 from B = 336;
    two features a block at 257): every splitting child selects feature 1,
    the lower key, bit for bit the plain version (exact sums, W = 1, 4 and
    16)."""
    kind = mode.split("_")[0]
    for name, sizes in U16_WAVES.items():
        inp, _ = wave_inputs(sum(2 * s for s in sizes), 28, b, sizes,
                             seed=b + len(sizes), exact=True,
                             device=cuda_device,
                             scales=POW2_SCALES if kind == "int8" else None,
                             mode=kind, edit=_tie_edit(1, 25))
        h, p = WV.fused_wave_call(cfg=CFG, **inp)
        hp, pp = WV.wave_plain(cfg=CFG, **inp)
        torch.cuda.synchronize()
        assert torch.equal(h, hp) and torch.equal(p, pp)
        split = torch.isfinite(p[..., 0])
        assert bool(split.any())
        assert bool((p[..., 1][split] == 1).all())


@pytest.mark.parametrize("pattern", ["one_bin", "runs_of_32", "pairs", "tie"])
def test_smoke_lane_patterns(pattern):
    """``chip_smoke.py``'s phase-29 waves that push the uint16 kernels:
    along the permutation every row of a feature in one bin, runs of 32
    rows or pairs on one bin; or features 1 and 25 tied, whose plain
    payloads then select feature 1 in every splitting child.  The
    categorical feature keeps its 4 bins."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(3)
    inp = cs.wave_case(gen, torch.device("cpu"), [700, 40, 300], exact=True,
                       f=28, b=1023, inactive=(1,), mode="f32",
                       edit=cs.lane_pattern(pattern, 1023))
    bins, perm = inp["bins"].long(), inp["perm"].long()
    along = bins[perm]
    assert bool((bins[:, 3] < 4).all())
    if pattern == "one_bin":
        assert bool((bins == bins[0]).all())
    elif pattern == "runs_of_32":
        runs = along[: len(along) // 32 * 32].reshape(-1, 32, 28)
        assert bool((runs == runs[:, :1]).all())
    elif pattern == "pairs":
        assert torch.equal(along[0::2], along[1::2])
    else:
        assert torch.equal(bins[:, 1], bins[:, 25])
        _h, p = WV.fused_wave_call(cfg=CFG, **inp)
        split = torch.isfinite(p[..., 0])
        assert bool(split.any()) and bool((p[..., 1][split] == 1).all())


@pytest.mark.parametrize("sizes,f,b,rows,chunks", [
    ([12_500] * 16, 28, 1023, 1024, [13] * 16),
    ([100_000], 28, 1023, 1024, [98]),
    ([1] * 16, 28, 65536, 1024, [1] * 16),
    ([200_000, 0, 5], 28, 1023, 1024, [196, 0, 1]),
])
def test_uint16_chunk_layout(sizes, f, b, rows, chunks):
    """The chunk layout the uint16 kernels' f32 sums depend on (each cell
    summed in row order within a chunk, then the chunks in order): the
    wave's ``segment_table`` at the bench wave (W = 16 x 12,500, F = 28, B
    = 1,023: chunks of 1,024 rows, 13 a sibling) and the histogram's
    ``chunking`` of 200,000 rows (196 chunks) stay as they are."""
    chunk_rows, offs = WV.segment_table(sizes, f, b)
    assert chunk_rows == rows
    assert np.diff(offs).tolist() == chunks
    assert WV.chunking(200_000, 28 * 1023) == (1024, 196)


def _int8_hot_edit(pattern, b):
    """A ``wave_inputs`` edit on which the int8 stage 1's lanes meet on
    one cell: ``one_bin`` every row of a feature in one bin, ``nan_bin``
    every other row in the NaN bin b - 1 of every feature."""
    def edit(bins, nan_feats):
        if pattern == "one_bin":
            bins[:] = (np.arange(bins.shape[1]) * 37 + b // 2) % b
        else:
            bins[::2] = b - 1
            nan_feats[:] = True
    return edit


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["one_bin", "nan_bin"])
@pytest.mark.parametrize("mode,b,w", [
    ("int8", 255, 1), ("int8", 255, 4), ("int8", 255, 16),
    ("int8_packed4", 16, 1), ("int8_packed4", 16, 16),
    ("int8", 1023, 1), ("int8", 1023, 16), ("int8", 65536, 1)])
def test_int8_stage1_hot_bins(cuda_device, mode, b, w, pattern):
    """The int8 wave's stage 1 (the int8 accumulation through the
    permutation) on bins whose lanes meet on one cell, at W = 1, 4 and
    16 siblings of 3,000 rows (300 at B = 65,536), F = 28 (27 packed):
    child histograms bit for bit the plain version's, payloads too on
    power-of-two scales."""
    sizes = [300 if b == 65536 else 3000] * w
    f = 27 if mode.endswith("packed4") else 28
    inp, _ = wave_inputs(sum(2 * s for s in sizes), f, b, sizes, seed=w + b,
                         exact=True, device=cuda_device, scales=POW2_SCALES,
                         mode=mode, edit=_int8_hot_edit(pattern, b))
    h1, p1 = WV.fused_wave_call(cfg=CFG, **inp)
    hp, pp = WV.wave_plain(cfg=CFG, **inp)
    torch.cuda.synchronize()
    assert h1.dtype == torch.int32 and torch.equal(h1, hp)
    assert torch.equal(p1, pp)


@pytest.mark.parametrize("sizes,b,rows,chunks,blocks", [
    ([12_500] * 16, 255, 1516, [9] * 16, 576),
    ([12_500] * 4, 255, 512, [25] * 4, 400),
    ([12_500], 255, 512, [25], 100),
    ([12_500] * 16, 1023, 4167, [3] * 16, 336),
    ([1, 0, 100_000], 255, 758, [1, 0, 132], 532),
])
def test_int8_chunk_layout(sizes, b, rows, chunks, blocks):
    """The int8 wave's stage-1 blocks from shapes alone (F = 28): the
    smaller siblings' rows together in ``int8_chunk_rows`` chunks (one
    block per chunk, feature group and bin tile; at B = 1,023, uint16
    bins in groups of 4 features, the int32 partials cap the chunks), so
    a wave of W = 1, 4 or 16 siblings of 12,500 rows puts 100, 400 or 576
    blocks on the card (the first design's 2,048-row chunks over every
    feature: 7, 28 and 112)."""
    chunk_rows, offs = WV.segment_table(sizes, 28, b, int8=True,
                                        wide=b > 256)
    assert chunk_rows == rows
    assert np.diff(offs).tolist() == chunks
    _, groups, _, tiles = WV.int8_shape(28, b, b > 256)
    assert int(offs[-1]) * groups * tiles == blocks
