"""Histogram parity: the port's plain histogram (``histogram_segment``,
the plain version of the CUDA kernel ``ops/csrc/histogram.cu``) against
the JAX package's ``histogram_flat`` (its Pallas kernel, in interpret
mode) and ``histogram_segment``.

- Bitwise on exact-sum values (+-0.5, 0.25, 1): every sum is exact in any
  order.
- Within 1e-5 relative on random float32 values (the JAX kernel's matmul
  and the scatter-add sum in different orders).
- int8 values (quantized training): the int32 histogram bitwise equal to
  JAX ``histogram_flat(dtype="int8")`` and ``histogram_segment`` (integer
  sums are exact in any order), the dispatch of integer values to the
  int8 mode, and the int32 overflow guard, bounded by the run's largest
  level (``num_grad_quant_bins``).
- uint16 bins (more than 256 bins) at B = 257, 511 and 1,023: the plain
  version bitwise equal to JAX ``histogram_flat(interpret=True)`` and
  ``histogram_segment`` on exact sums (f32), on any int8 levels, and in
  bf16 at 128-row blocks on k/256 values; the chunk-ordered twin bitwise
  equal to the plain version at B = 65,536 (the kernel's bin tiles).
- 4-bit bins: ``pack_bins4`` / ``unpack_bins4`` byte-equal to JAX's (odd
  F, N = 0); packed ``histogram_segment`` / ``histogram_onehot`` bitwise
  equal to JAX's, f32 and int32.
- The bf16 and packed4 modes (bf16, f32_packed4, bf16_packed4,
  int8_packed4) of the plain version against JAX ``histogram_flat(dtype=
  ..., packed4=..., interpret=True)``: bitwise on exact sums (values k/256,
  exact in bf16 and in any f32 order), within 1e-5 relative on random
  values (in bf16 mode both round the values to bf16 first).

On the card (``cuda`` marker) the kernel equals its plain version bitwise
on exact-sum values at the bench shape, is run-to-run bitwise on random
values, and stays within 1e-5 relative of the plain version there; its
int8 mode equals its plain version bitwise at N in {1, 1,000, 200,000}.
Its bf16 and packed4 modes equal their plain versions the same way (F =
28 and 27), and bitwise the kernel's own f32 launch on the bf16-rounded
values and unpacked launch on the same rows.  Its uint16 modes equal
their twins on random values, and their plain versions on exact sums on
bins that push the lane grouping (a bin per feature, runs of 32 rows and
pairs on one bin, the edges of the bin tiles), B from 257 to 65,536."""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device  # noqa: F401
from torch_port_util import order_sensitive_vals, sequential_chunk_hist

from lightgbm_tpu_torch.ops import histogram_flat as HF
from lightgbm_tpu_torch.ops.histogram import (histogram_chunked,
                                              histogram_from_vals,
                                              histogram_onehot,
                                              histogram_segment, pack_bins4,
                                              pack_values, read_bins,
                                              subtract_histogram,
                                              unpack_bins4)
from lightgbm_tpu_torch.ops.quantize import max_level

# (rows, features, bins): N not a multiple of any block, N = 1, F = 1
SHAPES = [(1, 28, 255), (1, 1, 4), (777, 3, 17), (3001, 5, 64),
          (2049, 1, 255)]


def _data(n, f, b, seed, exact):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, b, (n, f)).astype(np.uint8)
    bins[rng.rand(n, f) < 0.1] = b - 1            # the NaN bin, often
    if exact:
        g = rng.choice([-0.5, 0.5], n).astype(np.float32)
        h = np.full(n, 0.25, np.float32)
    else:
        g = rng.randn(n).astype(np.float32)
        h = rng.rand(n).astype(np.float32)
    vals = np.stack([g, h, np.ones(n, np.float32)], axis=1)
    return bins, vals


def _int8_vals(n, seed):
    """int8 levels as quantized training makes them: grad in +-127 (zero
    often), hess in 0..127, in-bag 0/1."""
    rng = np.random.RandomState(seed)
    g = rng.randint(-127, 128, n)
    g[rng.rand(n) < 0.2] = 0
    h = rng.randint(0, 128, n)
    c = (rng.rand(n) < 0.9).astype(np.int64)
    return np.stack([g, h, c], axis=1).astype(np.int8)


def _jax_flat(bins, vals, b, dtype="f32", packed4=False, features=0):
    """JAX ``histogram_flat`` in interpret mode.  The CPU backend cannot
    run the bf16 kernel's dot when the call is a single row block (XLA's
    DotThunk has no BF16 x BF16 = F32), so bf16 calls use 128-row blocks,
    and a bf16 call of one block runs the f32 kernel on the bf16-rounded
    values: the same function (bf16 products are exact in f32)."""
    import jax.numpy as jnp

    from lightgbm_tpu.ops.pallas_histogram import histogram_flat
    if vals.dtype == np.int8:
        dtype = "int8"
    rows_block = 0
    if dtype == "bf16":
        rows_block = 128
        if bins.shape[0] <= rows_block:
            dtype = "f32"
            vals = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16)
                              .astype(jnp.float32))
    return np.asarray(histogram_flat(jnp.asarray(bins), jnp.asarray(vals),
                                     num_bins=b, dtype=dtype, interpret=True,
                                     packed4=packed4, features=features,
                                     rows_block=rows_block))


def _jax_segment(bins, vals, b):
    import jax.numpy as jnp

    from lightgbm_tpu.ops.histogram import histogram_segment as js
    return np.asarray(js(jnp.asarray(bins), jnp.asarray(vals), num_bins=b))


def _port(bins, vals, b):
    return histogram_flat_cpu(torch.from_numpy(bins), torch.from_numpy(vals),
                              b).numpy()


def histogram_flat_cpu(bins, vals, b):
    out = HF.histogram_flat(bins, vals, num_bins=b)
    assert out.shape == (bins.shape[1], b, 3) and out.dtype == torch.float32
    return out


@pytest.mark.parametrize("n,f,b", SHAPES)
def test_plain_bitwise_vs_jax_on_exact_sums(n, f, b):
    bins, vals = _data(n, f, b, seed=n + f, exact=True)
    got = _port(bins, vals, b)
    np.testing.assert_array_equal(got, _jax_flat(bins, vals, b))
    np.testing.assert_array_equal(got, _jax_segment(bins, vals, b))


@pytest.mark.parametrize("n,f,b", SHAPES[2:])
def test_plain_within_1e5_vs_jax_on_random_f32(n, f, b):
    bins, vals = _data(n, f, b, seed=7 * n + f, exact=False)
    got = _port(bins, vals, b)
    for want in (_jax_flat(bins, vals, b), _jax_segment(bins, vals, b)):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,f,b", SHAPES)
def test_int8_plain_bitwise_vs_jax(n, f, b):
    bins, _ = _data(n, f, b, seed=3 * n + f, exact=True)
    vals = _int8_vals(n, seed=n + 2 * f)
    got = HF.histogram_flat(torch.from_numpy(bins), torch.from_numpy(vals),
                            num_bins=b)
    assert got.shape == (f, b, 3) and got.dtype == torch.int32
    got = got.numpy()
    np.testing.assert_array_equal(got, _jax_flat(bins, vals, b))
    np.testing.assert_array_equal(got, _jax_segment(bins, vals, b))


def test_int8_dispatch_and_overflow_guard():
    """Every impl gives the int32 histogram of integer values (flat_bf16
    means the int8 mode then, as in the JAX package); N * max_level must
    fit int32, max_level being the run's largest level: at the default
    num_grad_quant_bins of 4, 536,870,911 rows pass and one more raises
    (the check used to take every level as 127 and refuse 16,909,321)."""
    bins, _ = _data(700, 4, 32, seed=2, exact=True)
    tb = torch.from_numpy(bins)
    tv = torch.from_numpy(_int8_vals(700, seed=2))
    want = histogram_segment(tb, tv, num_bins=32)
    assert want.dtype == torch.int32
    for impl in ("auto", "pallas", "flat", "flat_bf16", "segment", "onehot"):
        got = histogram_from_vals(tb, tv, num_bins=32, impl=impl,
                                  rows_block=128)
        assert got.dtype == torch.int32 and torch.equal(got, want), impl
    level = max_level(4)
    assert level == 4
    HF.check_int8_rows(536_870_911, level)
    with pytest.raises(ValueError, match="overflow"):
        HF.check_int8_rows(536_870_912, level)
    # any int8 level (the default): 127 * N must fit
    HF.check_int8_rows(16_909_320)
    huge = 16_909_321
    with pytest.raises(ValueError, match="overflow"):
        HF.histogram_flat(torch.zeros(1, 1, dtype=torch.uint8).expand(huge, 1),
                          torch.zeros(1, 3, dtype=torch.int8).expand(huge, 3),
                          num_bins=4)
    # with the run's level the same rows pass the check
    HF.check_inputs(torch.zeros(1, 1, dtype=torch.uint8).expand(huge, 1),
                    torch.zeros(1, 3, dtype=torch.int8).expand(huge, 3), 4,
                    max_level=level)
    # f32 values may have any row count
    HF.check_inputs(torch.zeros(1, 1, dtype=torch.uint8).expand(huge, 1),
                    torch.zeros(1, 3).expand(huge, 3), 4)


def test_dispatch_on_cpu_and_bf16_refusal():
    """Every impl on a CPU tensor runs the plain version; ``flat_bf16``
    with f32 values takes the bf16 mode's plain version: the f32 sums of
    the values rounded to bf16 (it used to raise), which on random values
    is not the f32 histogram."""
    bins, vals = _data(500, 4, 32, seed=1, exact=True)
    tb, tv = torch.from_numpy(bins), torch.from_numpy(vals)
    want = histogram_segment(tb, tv, num_bins=32)
    for impl in ("auto", "pallas", "flat", "segment", "onehot"):
        got = histogram_from_vals(tb, tv, num_bins=32, impl=impl,
                                  rows_block=128)
        assert torch.equal(got, want), impl
    _, rv = _data(500, 4, 32, seed=1, exact=False)
    rv = torch.from_numpy(rv)
    got = histogram_from_vals(tb, rv, num_bins=32, impl="flat_bf16")
    want = histogram_segment(tb, rv.to(torch.bfloat16).float(), num_bins=32)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert not torch.equal(got, histogram_segment(tb, rv, num_bins=32))
    with pytest.raises(ValueError, match="unknown"):
        histogram_from_vals(tb, tv, num_bins=32, impl="bogus")


@pytest.mark.parametrize("n,f", [(0, 5), (1, 1), (777, 28), (3001, 27)])
def test_pack_unpack_bins4_byte_equal_to_jax(n, f):
    import jax.numpy as jnp

    from lightgbm_tpu.ops import histogram as jh
    bins = np.random.RandomState(n + f).randint(0, 16, (n, f)).astype(
        np.uint8)
    got = pack_bins4(torch.from_numpy(bins))
    want = np.asarray(jh.pack_bins4(jnp.asarray(bins)))
    assert got.dtype == torch.uint8 and got.shape == (n, (f + 1) // 2)
    np.testing.assert_array_equal(got.numpy(), want)
    back = unpack_bins4(got, f)
    np.testing.assert_array_equal(back.numpy(), bins)
    if n:          # JAX's unpack cannot reshape zero rows; the port's can
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jh.unpack_bins4(jnp.asarray(want), f)))
    if f % 2:
        assert not (got[:, -1] >> 4).any()          # the phantom nibble


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("n,f", [(1, 1), (777, 27), (3001, 6)])
def test_packed4_segment_and_onehot_bitwise_vs_jax(n, f, int8):
    import jax.numpy as jnp

    from lightgbm_tpu.ops import histogram as jh
    bins, vals = _data(n, f, 16, seed=5 * n + f, exact=True)
    if int8:
        vals = _int8_vals(n, seed=n)
    packed = pack_bins4(torch.from_numpy(bins))
    tv = torch.from_numpy(vals)
    jb, jv = jnp.asarray(packed.numpy()), jnp.asarray(vals)
    kw = dict(num_bins=16, packed4=True, features=f)
    seg = histogram_segment(packed, tv, **kw)
    onehot = histogram_onehot(packed, tv, rows_block=256, **kw)
    assert seg.dtype == (torch.int32 if int8 else torch.float32)
    np.testing.assert_array_equal(
        seg.numpy(), np.asarray(jh.histogram_segment(jb, jv, **kw)))
    np.testing.assert_array_equal(
        onehot.numpy(), np.asarray(jh.histogram_onehot(jb, jv,
                                                       rows_block=256, **kw)))
    np.testing.assert_array_equal(
        seg.numpy(), histogram_segment(torch.from_numpy(bins), tv,
                                       num_bins=16).numpy())


def _mode_case(mode, n, f, seed, exact):
    """(bins, vals, num_bins, histogram_flat kwargs) of one bf16 / packed4
    mode: packed modes at 16 bins, bf16 at 255; exact values are k/256
    (exact in bf16, every sum exact in f32), random ones ordinary f32."""
    packed4 = mode.endswith("packed4")
    b = 16 if packed4 else 255
    bins, vals = _data(n, f, b, seed=seed, exact=exact)
    if exact:
        rng = np.random.RandomState(seed)
        vals[:, 0] = rng.randint(-255, 256, n) / 256.0
        vals[:, 1] = rng.randint(1, 256, n) / 256.0
    if mode.startswith("int8"):
        vals = _int8_vals(n, seed=seed)
    kw = dict(dtype="bf16" if mode.startswith("bf16") else "f32",
              packed4=packed4, features=f if packed4 else 0)
    if packed4:
        bins = pack_bins4(torch.from_numpy(bins)).numpy()
    return bins, vals, b, kw


NEW_MODES = ["bf16", "f32_packed4", "bf16_packed4", "int8_packed4"]


@pytest.mark.parametrize("mode", NEW_MODES)
@pytest.mark.parametrize("n,f", [(1, 28), (777, 27), (3001, 5)])
def test_new_modes_plain_vs_jax_flat(mode, n, f):
    for exact in (True, False):
        bins, vals, b, kw = _mode_case(mode, n, f, seed=n + f, exact=exact)
        got = HF.histogram_flat(torch.from_numpy(bins),
                                torch.from_numpy(vals), num_bins=b, **kw)
        want = _jax_flat(bins, vals, b, **kw)
        assert got.shape == (f, b, 3)
        if exact or mode.startswith("int8"):
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())


TWIN_MODES = ["f32", "bf16", "f32_packed4", "bf16_packed4"]


def _twin_inputs(mode, bins, vals):
    """Torch inputs of a mode's ``histogram_flat`` call (bf16 values
    rounded, as the wrapper rounds them) and the twin's layout kwargs."""
    tv = torch.from_numpy(vals)
    if mode.startswith("bf16"):
        tv = tv.to(torch.bfloat16)
    return torch.from_numpy(bins), tv


@pytest.mark.parametrize("mode", TWIN_MODES)
@pytest.mark.parametrize("n,f", [(1, 28), (777, 27), (3001, 5)])
def test_chunked_twin_vs_segment_and_jax(mode, n, f):
    """The plain twin of the kernel's summation order equals the
    scatter-add plain version and JAX ``histogram_flat`` (interpret mode)
    bit for bit on exact sums, and the plain version within 1e-5 relative
    on random values; chunks of 256 rows, so several chunks are summed."""
    for exact in (True, False):
        bins, vals, b, kw = _mode_case(mode, n, f, seed=2 * n + f,
                                       exact=exact)
        tb, tv = _twin_inputs(mode, bins, vals)
        lay = dict(packed4=kw["packed4"], features=f)
        got = histogram_chunked(tb, tv, num_bins=b, chunk_rows=256, **lay)
        want = histogram_segment(tb, tv, num_bins=b, **lay)
        assert got.shape == (f, b, 3) and got.dtype == torch.float32
        if exact:
            assert torch.equal(got, want)
            np.testing.assert_array_equal(got.numpy(),
                                          _jax_flat(bins, vals, b, **kw))
        else:
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("n,chunk_rows", [(2500, None), (700, 64),
                                          (1, None)])
def test_chunked_twin_keeps_the_wrappers_chunking(n, chunk_rows):
    """On values whose f32 sums depend on their order, the twin equals the
    summation order written out as loops, with ``chunking()``'s chunk rows
    by default; another chunking gives other bits (the check bites)."""
    rng = np.random.RandomState(n)
    bins = rng.randint(0, 3, (n, 2)).astype(np.uint8)
    vals = order_sensitive_vals(n, seed=n)
    rows = chunk_rows or HF.chunking(n)[0]
    got = histogram_chunked(torch.from_numpy(bins), torch.from_numpy(vals),
                            num_bins=3, chunk_rows=chunk_rows).numpy()
    np.testing.assert_array_equal(got, sequential_chunk_hist(bins, vals, 3,
                                                             rows))
    if n > 1:
        assert not np.array_equal(got, sequential_chunk_hist(bins, vals, 3,
                                                             rows - 1))
    # packed bins and bf16 values: the same sums of the same rows
    packed = pack_bins4(torch.from_numpy(bins))
    got4 = histogram_chunked(packed, torch.from_numpy(vals), num_bins=3,
                             chunk_rows=chunk_rows, packed4=True, features=2)
    np.testing.assert_array_equal(got4.numpy(), got)
    half = torch.from_numpy(vals).to(torch.bfloat16)
    np.testing.assert_array_equal(
        histogram_chunked(torch.from_numpy(bins), half, num_bins=3,
                          chunk_rows=chunk_rows).numpy(),
        sequential_chunk_hist(bins, half.float().numpy(), 3, rows))


def test_chunked_twin_drops_bins_past_num_bins():
    """A bin id >= num_bins is dropped, as the kernel drops it."""
    bins = np.array([[0], [5], [1], [2]], np.uint8)
    vals = np.ones((4, 3), np.float32)
    got = histogram_chunked(torch.from_numpy(bins), torch.from_numpy(vals),
                            num_bins=3).numpy()
    np.testing.assert_array_equal(got[0, :, 2], [1, 1, 1])


def test_new_mode_names_and_layout_checks():
    tb = torch.zeros(4, 3, dtype=torch.uint8)
    f32, bf16, i8 = (torch.zeros(4, 3, dtype=t) for t in
                     (torch.float32, torch.bfloat16, torch.int8))
    assert [HF.mode_name(v.dtype, p) for p in (False, True)
            for v in (f32, bf16, i8)] == [
        "f32", "bf16", "int8", "f32_packed4", "bf16_packed4", "int8_packed4"]
    assert sorted(HF.launches) == sorted(HF.MODES)
    got = HF.histogram_flat(tb, bf16, num_bins=8, dtype="f32")
    assert got.dtype == torch.float32 and got.shape == (3, 8, 3)
    with pytest.raises(ValueError, match="columns"):
        HF.histogram_flat(tb, f32, num_bins=8, packed4=True, features=3)
    with pytest.raises(ValueError, match="at most 16"):
        HF.histogram_flat(tb, f32, num_bins=17, packed4=True, features=6)
    with pytest.raises(ValueError, match="dtype"):
        HF.histogram_flat(tb, f32, num_bins=8, dtype="int8")


def test_pack_values_and_subtract_vs_jax():
    import jax.numpy as jnp

    from lightgbm_tpu.ops import histogram as jh
    rng = np.random.RandomState(2)
    g = rng.randn(64).astype(np.float32)
    h = rng.rand(64).astype(np.float32)
    m = (rng.rand(64) > 0.3).astype(np.float32)
    got = pack_values(torch.from_numpy(g), torch.from_numpy(h),
                      torch.from_numpy(m)).numpy()
    want = np.asarray(jh.pack_values(jnp.asarray(g), jnp.asarray(h),
                                     jnp.asarray(m)))
    np.testing.assert_array_equal(got, want)
    a, b = rng.randn(2, 3, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(
        subtract_histogram(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jh.subtract_histogram(jnp.asarray(a), jnp.asarray(b))))


def test_wrapper_input_checks_and_chunking():
    bins, vals = _data(10, 2, 8, seed=0, exact=True)
    tb, tv = torch.from_numpy(bins), torch.from_numpy(vals)
    with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
        HF.histogram_flat(tb, tv.double(), num_bins=8)
    with pytest.raises(ValueError, match="vals"):
        HF.histogram_flat(tb, tv[:, :2], num_bins=8)
    with pytest.raises(ValueError, match="num_bins"):
        HF.histogram_flat(tb, tv, num_bins=257)
    # the chunking is a function of N and F * B alone: sums keep one
    # order per shape
    assert HF.chunking(1) == (HF.MIN_CHUNK_ROWS, 1)
    rows, chunks = HF.chunking(10_500_000)
    assert chunks <= HF.MAX_CHUNKS and rows * chunks >= 10_500_000
    # the bench shape (F * B = 28 * 255) is under the partials' cap
    assert HF.chunking(10_500_000, 28 * 255) == (rows, chunks)


def _u16_case(mode, n, f, b, seed):
    """uint16 bins of ``b`` bins (the NaN bin b - 1 often) and values of
    one value mode: f32 exact sums (+-0.5, 0.25), bf16 k/256 values
    (exact in bf16 and in any f32 order), int8 levels."""
    bins, vals = _data(n, f, 256, seed=seed, exact=True)
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, b, (n, f)).astype(np.uint16)
    bins[rng.rand(n, f) < 0.1] = b - 1
    if mode == "bf16":
        vals[:, 0] = rng.randint(-255, 256, n) / 256.0
        vals[:, 1] = rng.randint(1, 256, n) / 256.0
    if mode == "int8":
        vals = _int8_vals(n, seed=seed)
    return bins, vals


@pytest.mark.parametrize("b", [257, 511, 1023])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_uint16_plain_bitwise_vs_jax(mode, b):
    """The plain version on (N, F) uint16 bins equals JAX
    ``histogram_flat`` (interpret mode; bf16 at 128-row blocks) and JAX
    ``histogram_segment`` bit for bit, and so does the chunk-ordered twin
    (chunks of 128 rows): every sum here is exact."""
    n, f = 777, 5
    bins, vals = _u16_case(mode, n, f, b, seed=b + n)
    tb, tv = torch.from_numpy(bins), torch.from_numpy(vals)
    dtype = "bf16" if mode == "bf16" else "f32"
    got = HF.histogram_flat(tb, tv, num_bins=b, dtype=dtype)
    assert got.shape == (f, b, 3)
    assert got.dtype == (torch.int32 if mode == "int8" else torch.float32)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_flat(bins, vals, b, dtype=dtype))
    np.testing.assert_array_equal(got.numpy(), _jax_segment(bins, vals, b))
    if mode != "int8":
        twin_vals = tv.to(torch.bfloat16) if mode == "bf16" else tv
        twin = histogram_chunked(tb, twin_vals, num_bins=b, chunk_rows=128)
        assert torch.equal(twin, got)


@pytest.mark.parametrize("chunk_rows", [None, 7])
def test_chunked_twin_bin_tiles_at_65536_bins(chunk_rows):
    """At B = 65,536 (the kernel cuts the bin axis into 8 tiles) the twin
    equals the plain version bit for bit on exact sums, with ids above
    32,767 (whose int16 view is negative) and the last bin, and on values
    whose sums depend on their order it equals the order written out as
    loops."""
    rng = np.random.RandomState(65)
    n, f, b = 60, 3, 65536
    bins = rng.randint(0, b, (n, f)).astype(np.uint16)
    bins[:5] = b - 1
    bins[5:9] = 40_000
    _, vals = _data(n, f, 4, seed=3, exact=True)
    tb = torch.from_numpy(bins)
    got = histogram_chunked(tb, torch.from_numpy(vals), num_bins=b,
                            chunk_rows=chunk_rows)
    assert torch.equal(got, histogram_segment(tb, torch.from_numpy(vals),
                                              num_bins=b))
    ov = order_sensitive_vals(n, seed=4)
    rows = chunk_rows or HF.chunking(n, f * b)[0]
    np.testing.assert_array_equal(
        histogram_chunked(tb, torch.from_numpy(ov), num_bins=b,
                          chunk_rows=chunk_rows).numpy(),
        sequential_chunk_hist(bins.astype(np.int64), ov, b, rows))


def test_uint16_modes_layout_checks_and_chunking():
    """uint16 bins take 1..65,536 bins and name their own modes; uint8
    bins stay at 256 and packed ones at 16 (and uint8); the chunk
    partials stay within SCRATCH_BYTES, which leaves the bench shape's
    chunking as it was and caps it at F * B = 28 * 1,023; ``read_bins``
    reads ids above 32,767."""
    u16 = torch.zeros(4, 3, dtype=torch.uint16)
    f32, bf16, i8 = (torch.zeros(4, 3, dtype=t) for t in
                     (torch.float32, torch.bfloat16, torch.int8))
    assert [HF.mode_name(v.dtype, False, torch.uint16)
            for v in (f32, bf16, i8)] == ["f32_uint16", "bf16_uint16",
                                          "int8_uint16"]
    assert set(HF.MODES) == set(HF.BYTE_MODES) | {
        "f32_uint16", "bf16_uint16", "int8_uint16"}
    assert HF.check_layout(u16, 65536, False, 0) == 3
    with pytest.raises(ValueError, match="1..65536"):
        HF.check_layout(u16, 65537, False, 0)
    with pytest.raises(ValueError, match="1..256"):
        HF.check_layout(u16.to(torch.uint8), 257, False, 0)
    with pytest.raises(ValueError, match="uint16"):
        HF.check_layout(u16, 16, True, 6)
    got = HF.histogram_flat(u16, torch.ones(4, 3), num_bins=1023)
    assert got.shape == (3, 1023, 3) and float(got[:, 0, 2].sum()) == 12.0
    # chunking: 196 chunks of 1,024 rows at 200k either way; at 10.5M rows
    # the 28 x 1,023 partials cap the chunks at 780
    assert HF.chunking(200_000, 28 * 1023) == HF.chunking(200_000) == (
        1024, 196)
    rows, chunks = HF.chunking(10_500_000, 28 * 1023)
    assert chunks == HF.SCRATCH_BYTES // (28 * 1023 * 12) == 780
    assert rows * chunks >= 10_500_000
    assert HF.chunking(1000, 28 * 65536) == (1024, 1)
    ids = np.array([[0, 255, 256, 32_767, 32_768, 65_535]], np.uint16)
    np.testing.assert_array_equal(
        read_bins(torch.from_numpy(ids), torch.tensor([0])).numpy(),
        ids.astype(np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 200_000])
def test_kernel_matches_plain_bench_shape(cuda_device, n):
    """Bitwise on exact sums; run-to-run bitwise and within 1e-5 relative
    of the plain version on random values (F = 28, B = 255, NaN bins)."""
    for exact in (True, False):
        bins, vals = _data(n, 28, 255, seed=n, exact=exact)
        tb = torch.from_numpy(bins).to(cuda_device)
        tv = torch.from_numpy(vals).to(cuda_device)
        launches = HF.launches["f32"]
        got = HF.histogram_flat(tb, tv, num_bins=255)
        again = HF.histogram_flat(tb, tv, num_bins=255)
        want = histogram_segment(tb, tv, num_bins=255)
        torch.cuda.synchronize()
        assert HF.launches["f32"] == launches + 2
        assert torch.equal(got, again)
        if exact:
            assert torch.equal(got, want)
        else:
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 200_000])
def test_int8_kernel_matches_plain_bench_shape(cuda_device, n):
    """int8 mode: bitwise equal to the plain int32 histogram (F = 28,
    B = 255, NaN bins)."""
    bins, _ = _data(n, 28, 255, seed=n, exact=True)
    tb = torch.from_numpy(bins).to(cuda_device)
    tv = torch.from_numpy(_int8_vals(n, seed=n)).to(cuda_device)
    launches = HF.launches["int8"]
    got = HF.histogram_flat(tb, tv, num_bins=255)
    want = histogram_segment(tb, tv, num_bins=255)
    torch.cuda.synchronize()
    assert HF.launches["int8"] == launches + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", NEW_MODES)
@pytest.mark.parametrize("n", [1, 1000, 200_000])
def test_new_mode_kernels_match_plain(cuda_device, mode, n):
    """Each bf16 / packed4 mode at F = 28 and 27: bitwise equal to its
    plain version on exact sums and within 1e-5 relative on random
    values, as the f32 mode (bitwise in integer modes), run-to-run bitwise, and bitwise
    equal to the kernel's own unpacked launch on the same rows and (bf16)
    its f32 launch on the bf16-rounded values."""
    for f in (28, 27):
        for exact in (True, False):
            bins, vals, b, kw = _mode_case(mode, n, f, seed=n + f,
                                           exact=exact)
            tb = torch.from_numpy(bins).to(cuda_device)
            tv = torch.from_numpy(vals).to(cuda_device)
            launches = HF.launches[mode]
            got = HF.histogram_flat(tb, tv, num_bins=b, **kw)
            again = HF.histogram_flat(tb, tv, num_bins=b, **kw)
            plain = histogram_segment(
                tb, tv.to(torch.bfloat16) if kw["dtype"] == "bf16" else tv,
                num_bins=b, packed4=kw["packed4"], features=f)
            base_bins = unpack_bins4(tb, f) if kw["packed4"] else tb
            base_vals = (tv.to(torch.bfloat16).float()
                         if kw["dtype"] == "bf16" else tv)
            base = HF.histogram_flat(base_bins.contiguous(), base_vals,
                                     num_bins=b)
            torch.cuda.synchronize()
            assert HF.launches[mode] == launches + 2
            assert torch.equal(got, again) and torch.equal(got, base)
            if exact or mode.startswith("int8"):
                assert torch.equal(got, plain)
            else:
                scale = float(plain.abs().max())
                assert float((got - plain).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("mode", TWIN_MODES)
@pytest.mark.parametrize("n", [1, 1000, 20_000, 200_000])
def test_kernel_equals_chunked_twin_on_random_values(cuda_device, mode, n):
    """The f32 / bf16 kernel keeps the twin's summation order: bit for
    bit on random values (F = 28, and odd F = 27 packed)."""
    packed4 = mode.endswith("packed4")
    for f in (28, 27) if packed4 else (28,):
        bins, vals, b, kw = _mode_case(mode, n, f, seed=n + f, exact=False)
        tb, tv = (t.to(cuda_device) for t in _twin_inputs(mode, bins, vals))
        got = HF.histogram_flat(tb, tv, num_bins=b, **kw)
        want = histogram_chunked(tb, tv, num_bins=b, packed4=packed4,
                                 features=f)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (mode, n, f)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_bin", "one_bin_packed4", "B1", "B256",
                                  "packed4_F1", "packed4_F3", "F100",
                                  "packed4_F65"])
def test_kernel_edge_shapes_equal_chunked_twin(cuda_device, case):
    """Every row in one bin (each step's 32 lanes one group), B = 1 and
    B = 256, odd F packed, and F wide enough to cut the features into
    groups: bit for bit the twin on random values."""
    n = 20_000
    f = {"F100": 100, "packed4_F1": 1, "packed4_F3": 3,
         "packed4_F65": 65}.get(case, 28)
    b = {"B1": 1, "B256": 256}.get(case, 16 if "packed4" in case else 255)
    rng = np.random.RandomState(f + b)
    bins = rng.randint(0, b, (n, f)).astype(np.uint8)
    if case.startswith("one_bin"):
        bins[:] = 0
    _, vals = _data(n, f, b, seed=b, exact=False)
    packed4 = "packed4" in case
    tb = torch.from_numpy(bins).to(cuda_device)
    if packed4:
        tb = pack_bins4(tb)
    tv = torch.from_numpy(vals).to(cuda_device)
    kw = dict(num_bins=b, packed4=packed4, features=f if packed4 else 0)
    got = HF.histogram_flat(tb, tv, **kw)
    want = histogram_chunked(tb, tv, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), case


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b", [257, 511, 1023, 4095, 65536])
def test_uint16_kernel_equals_twin(cuda_device, mode, b):
    """The uint16 modes on random values at F = 28: f32 / bf16 bit for
    bit the chunk-ordered twin, int8 bit for bit the plain version, in
    storage order and through a permutation; one launch of the mode per
    call (B = 65,536: eight bin tiles, at N <= 1,000)."""
    key = f"{mode}_uint16"
    for n in (1, 1000) if b == 65536 else (1, 1000, 20_000):
        rng = np.random.RandomState(n + b)
        bins = torch.from_numpy(rng.randint(0, b, (n, 28)).astype(
            np.uint16)).to(cuda_device)
        vals = (_int8_vals(n, seed=n) if mode == "int8"
                else order_sensitive_vals(n, seed=n))
        tv = torch.from_numpy(vals).to(cuda_device)
        if mode == "bf16":
            tv = tv.to(torch.bfloat16)
        perm = torch.from_numpy(rng.permutation(n)).to(cuda_device)
        for tb, v in ((bins, tv), (bins.index_select(0, perm), tv[perm])):
            launches = HF.launches[key]
            got = HF.histogram_flat(tb, v, num_bins=b)
            want = (histogram_segment if mode == "int8"
                    else histogram_chunked)(tb, v, num_bins=b)
            torch.cuda.synchronize()
            assert HF.launches[key] == launches + 1
            assert torch.equal(got, want), (mode, b, n)


def _bin_tile(b, budget=96 * 1024):
    """``hist_common.cuh::bin_tile``: the uint16 accumulation's bins per
    block (12 bytes a bin within 96 KB: every bin up to B = 8,192)."""
    tiles = -(-b * 12 // budget)
    return -(-b // tiles)


def _lane_pattern_bins(pattern, n, f, b, rng):
    """(n, f) uint16 bins that push the uint16 accumulation's lane
    grouping: ``one_bin`` every row of a feature in one bin (each step's
    32 lanes one group); ``runs_of_32`` each 32-row step on one bin;
    ``pairs`` rows 2k and 2k + 1 on one bin (16 groups of two a step);
    ``tile_edges`` only the first and last bins of the accumulation's bin
    tiles (``_bin_tile``), of the scan's tiles of 4,096 and of B."""
    if pattern == "one_bin":
        bins = np.broadcast_to((np.arange(f) * 37 + b // 2) % b, (n, f))
    elif pattern == "runs_of_32":
        bins = rng.randint(0, b, (-(-n // 32), f)).repeat(32, axis=0)[:n]
    elif pattern == "pairs":
        bins = rng.randint(0, b, (-(-n // 2), f)).repeat(2, axis=0)[:n]
    else:
        edges = {0, b - 1}
        for t in (_bin_tile(b), 4096):
            for k in range(t, b, t):
                edges |= {k - 1, k}
        bins = rng.choice(sorted(edges), (n, f))
    return np.ascontiguousarray(bins, dtype=np.uint16)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["one_bin", "runs_of_32", "pairs",
                                     "tile_edges"])
@pytest.mark.parametrize("b", [257, 511, 1023, 2047, 4095, 8192, 8193,
                               65536])
def test_uint16_accumulation_lane_patterns(cuda_device, b, pattern):
    """The uint16 accumulation on bins that push its lane grouping and bin
    tiles, F = 28 (9 past B = 8,192), rows in storage order and through a
    permutation: f32, bf16 and int8 bit for bit the plain version on exact
    sums (k/256 values, exact in bf16 and in every f32 order), f32 and bf16
    bit for bit the chunk-ordered twin on random values."""
    n, f = 5000, 28 if b <= 8192 else 9
    rng = np.random.RandomState(b + len(pattern))
    bins = torch.from_numpy(_lane_pattern_bins(pattern, n, f, b,
                                               rng)).to(cuda_device)
    perm = torch.from_numpy(rng.permutation(n)).to(cuda_device)
    exact = np.stack([rng.randint(-255, 256, n) / 256.0,
                      rng.randint(1, 256, n) / 256.0, np.ones(n)],
                     axis=1).astype(np.float32)
    cases = [("int8", _int8_vals(n, seed=b), histogram_segment)]
    for kind in ("f32", "bf16"):
        cases += [(kind, exact, histogram_segment),
                  (kind, order_sensitive_vals(n, seed=b), histogram_chunked)]
    for kind, vals, want_fn in cases:
        tv = torch.from_numpy(vals).to(cuda_device)
        if kind == "bf16":
            tv = tv.to(torch.bfloat16)
        for tb, v in ((bins, tv), (bins.index_select(0, perm), tv[perm])):
            got = HF.histogram_flat(tb, v, num_bins=b)
            want = want_fn(tb, v, num_bins=b)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kind, want_fn.__name__)


# ------------------------------------------- the int8 accumulation (B1d)
def test_int8_block_layout():
    """The int8 accumulation's blocks: groups of 8 features over byte and
    nibble bins (an odd F's last group shorter, packed4 groups starting
    on even features), of 4 over uint16 bins; every bin in one tile of
    int32 cells (12 bytes a bin in 96 KB) up to B = 2,048 over uint16
    bins, equal tiles past it."""
    assert HF.int8_shape(28, 255) == (8, 4, 255, 1)
    assert HF.int8_shape(27, 16) == (8, 4, 16, 1)
    assert HF.int8_shape(5, 255) == (5, 1, 255, 1)
    assert HF.int8_shape(28, 1023, wide=True) == (4, 7, 1023, 1)
    assert HF.int8_shape(28, 2048, wide=True) == (4, 7, 2048, 1)
    assert HF.int8_shape(28, 2049, wide=True) == (4, 7, 1025, 2)
    assert HF.int8_shape(28, 65536, wide=True) == (4, 7, 2048, 32)
    assert HF.int8_shape(3, 65536, wide=True) == (3, 1, 2622, 25)


@pytest.mark.parametrize("n,f,b,rows,blocks", [
    (200_000, 28, 255, 1516, 528),
    (10_500_000, 28, 255, 79_546, 528),
    (1000, 28, 255, 512, 8),
    (200_000, 28, 1023, 4167, 336),
    (200_000, 3, 255, 512, 391),
])
def test_int8_chunk_layout(n, f, b, rows, blocks):
    """The int8 histogram's blocks from its shape alone: chunks of
    ``int8_chunk_rows`` (INT8_BLOCKS blocks across the feature groups and
    bin tiles, no more than INT8_PARTIAL_BYTES of int32 partials, at
    least MIN_CHUNK_ROWS_INT8 rows) times the groups and tiles (B = 1,023:
    uint16 bins).  The first design ran 98 blocks at 200,000 rows, 264 at
    10,500,000."""
    chunk_rows = HF.int8_chunk_rows(n, f, b, b > 256)
    _, groups, _, tiles = HF.int8_shape(f, b, b > 256)
    assert chunk_rows == rows
    assert -(-n // chunk_rows) * groups * tiles == blocks


def _hot_int8(pattern, n, f, b, rng):
    """(n, f) bins on which the int8 accumulation's lanes meet on one
    cell: ``one_bin`` every row of a feature in one bin, ``nan_bin``
    every other row in the NaN bin b - 1, ``runs_of_32`` each 32 rows on
    one bin, ``random`` none in particular; and int8 levels at the field
    limit's edge (+-127 and 0/1 counts)."""
    if pattern == "one_bin":
        bins = np.broadcast_to((np.arange(f) * 37 + b // 2) % b, (n, f))
    elif pattern == "runs_of_32":
        bins = rng.randint(0, b, (-(-n // 32), f)).repeat(32, axis=0)[:n]
    else:
        bins = rng.randint(0, b, (n, f))
        if pattern == "nan_bin":
            bins[::2] = b - 1
    bins = np.ascontiguousarray(bins, np.uint16 if b > 256 else np.uint8)
    vals = _int8_vals(n, seed=n + b)
    vals[rng.rand(n) < 0.3, 0] = rng.choice([-127, 127])
    return bins, vals


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["one_bin", "nan_bin", "runs_of_32",
                                     "random"])
@pytest.mark.parametrize("b", [16, 255, 1023, 65536])
def test_int8_accumulation_hot_bins(cuda_device, b, pattern):
    """The int8 accumulation on bins whose lanes meet on one cell, F = 28
    and 27, rows in storage order and through a permutation, at B = 16
    (also packed4), 255, 1,023 and 65,536 (43 bin tiles): bit for bit the
    plain int32 histogram."""
    rng = np.random.RandomState(b + len(pattern))
    for f in (28, 27):
        n = 5000 if b == 65536 else 30_000
        bins, vals = _hot_int8(pattern, n, f, b, rng)
        tb = torch.from_numpy(bins).to(cuda_device)
        tv = torch.from_numpy(vals).to(cuda_device)
        perm = torch.from_numpy(rng.permutation(n)).to(cuda_device)
        for pb, pv in ((tb, tv), (tb.index_select(0, perm), tv[perm])):
            want = histogram_segment(pb, pv, num_bins=b)
            got = HF.histogram_flat(pb, pv, num_bins=b)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (f, "perm" if pb is not tb
                                            else "storage")
            if b == 16:
                p4 = pack_bins4(pb)
                got4 = HF.histogram_flat(p4, pv, num_bins=b, packed4=True,
                                         features=f)
                torch.cuda.synchronize()
                assert torch.equal(got4, want), (f, "packed4")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [255, 1023])
def test_int8_accumulation_extreme_levels(cuda_device, b):
    """1,100,000 rows of every feature in one bin with levels +-127: each
    block's int32 cells and chunk partials, and the combine's sums, reach
    1,100,000 * 127 * 6/7 without wrapping: bit for bit the plain
    version."""
    n, f = 1_100_000, 28
    bins = np.ascontiguousarray(np.broadcast_to(
        (np.arange(f) * 37 + b // 2) % b, (n, f)),
        np.uint16 if b > 256 else np.uint8)
    vals = np.tile(np.array([[127, -127, 1]], np.int8), (n, 1))
    vals[::7] = (-127, 127, 0)
    tb = torch.from_numpy(bins).to(cuda_device)
    tv = torch.from_numpy(vals).to(cuda_device)
    got = HF.histogram_flat(tb, tv, num_bins=b)
    want = histogram_segment(tb, tv, num_bins=b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [255, 1023])
def test_int8_launcher_checks_block_layout(cuda_device, b):
    """The int8 block layout is the wrapper's (``int8_shape``), passed to
    the kernel: the launcher takes it, and refuses with
    cudaErrorInvalidValue (1) a group wider than the kernel's words hold
    (8 features over byte bins, 4 over uint16 bins), an empty group, and
    a tile wider than the bins."""
    from lightgbm_tpu_torch.ops._build import load_library
    n, f = 4096, 28
    wide = b > 256
    bins = torch.zeros(n, f, dtype=torch.uint16 if wide else torch.uint8,
                       device=cuda_device)
    vals = torch.ones(n, 3, dtype=torch.int8, device=cuda_device)
    partial = torch.empty(1, f, b, 3, dtype=torch.int32, device=cuda_device)
    out = torch.empty(f, b, 3, dtype=torch.int32, device=cuda_device)
    lib = load_library()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream

    def launch(fpb, tile):
        head = (bins.data_ptr(), vals.data_ptr(), n, f, b, n, 1, fpb, tile)
        tail = (partial.data_ptr(), out.data_ptr(), stream)
        if wide:
            return lib.lgbt_histogram_i8_u16(*head, *tail)
        return lib.lgbt_histogram_i8(*head, 0, *tail)

    fpb, _, tile, _ = HF.int8_shape(f, b, wide)
    assert launch(fpb, tile) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, histogram_segment(bins, vals, num_bins=b))
    widest = HF.INT8_GROUP_UINT16 if wide else HF.INT8_GROUP
    for bad in ((widest + 1, tile), (0, tile), (fpb, b + 1), (fpb, 0)):
        assert launch(*bad) == 1, bad
