"""Gradient discretization parity: the port's ``ops/quantize.py`` against
the JAX package's.

- ``gradient_scales``: bitwise, at every level cap (num_grad_quant_bins
  from 2 to 128, where the hessian levels cap at 127).
- ``discretize_gradients(stochastic=False)``: bitwise, half-way values
  included (both round half to even), and levels clipped to +-127.
- Stochastic rounding draws from a ``torch.Generator``, not a
  ``jax.random`` key, so it is held to its contract instead: an exact zero
  stays zero, the levels are unbiased (mean of q * scale within 4 standard
  errors of x), one generator seed gives one set of levels, and levels are
  clipped.
- ``quant_generator``: one generator per (seed, iteration), repeatable,
  and different for another iteration or seed.
- ``quant_levels`` / ``max_level``: the JAX package's levels, and the
  int32 histogram's row bound at the largest of them."""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram_flat as HF
from lightgbm_tpu_torch.ops import quantize as PQ
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)


def _jax_q():
    from lightgbm_tpu.ops import quantize as JQ
    return JQ


def _grads(n=4000, seed=0):
    rng = np.random.RandomState(seed)
    g = (rng.randn(n) * 0.3).astype(np.float32)
    h = rng.rand(n).astype(np.float32)
    g[:5] = 0.0
    h[5:8] = 0.0
    return g, h


@pytest.mark.parametrize("num_bins", [2, 3, 4, 16, 127, 128])
def test_scales_and_deterministic_levels_bitwise_vs_jax(num_bins):
    import jax
    import jax.numpy as jnp
    JQ = _jax_q()
    g, h = _grads(seed=num_bins)
    jg, jh = JQ.gradient_scales(jnp.asarray(g), jnp.asarray(h), num_bins)
    pg, ph = PQ.gradient_scales(torch.from_numpy(g), torch.from_numpy(h),
                                num_bins)
    assert pg.dtype == ph.dtype == torch.float32
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    want = JQ.discretize_gradients(jnp.asarray(g), jnp.asarray(h), jg, jh,
                                   jax.random.PRNGKey(0), stochastic=False)
    got = PQ.discretize_gradients(torch.from_numpy(g), torch.from_numpy(h),
                                  pg, ph, stochastic=False)
    for w, p in zip(want, got):
        assert p.dtype == torch.int8
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))


def test_half_way_values_round_to_even_and_clip_like_jax():
    import jax
    import jax.numpy as jnp
    JQ = _jax_q()
    g = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 300.0, -300.0, 0.0],
                 np.float32)
    h = np.array([0.5, 1.5, 2.5, 3.5, 126.5, 127.5, 1e6, 0.0, 0.0],
                 np.float32)
    one = np.float32(1.0)
    want = JQ.discretize_gradients(jnp.asarray(g), jnp.asarray(h),
                                   jnp.asarray(one), jnp.asarray(one),
                                   jax.random.PRNGKey(0), stochastic=False)
    got = PQ.discretize_gradients(torch.from_numpy(g), torch.from_numpy(h),
                                  torch.tensor(one), torch.tensor(one),
                                  stochastic=False)
    np.testing.assert_array_equal(got[0].numpy(),
                                  [0, 2, 2, 0, -2, -2, 127, -127, 0])
    np.testing.assert_array_equal(got[1].numpy(),
                                  [0, 2, 2, 4, 126, 127, 127, 0, 0])
    for w, p in zip(want, got):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))


def test_stochastic_rounding_contract():
    n = 200_000
    g = torch.full((n,), 0.3)
    h = torch.full((n,), 0.7)
    g[:1000] = 0.0
    h[:1000] = 0.0
    one = torch.tensor(1.0)
    gen = torch.Generator().manual_seed(5)
    gq, hq = PQ.discretize_gradients(g, h, one, one, gen)
    assert gq.dtype == hq.dtype == torch.int8
    assert not gq[:1000].any() and not hq[:1000].any()     # zero stays zero
    assert set(gq[1000:].unique().tolist()) == {0, 1}      # floor(x + U)
    for q, x in ((gq, 0.3), (hq, 0.7)):
        mean = float(q[1000:].double().mean())
        stderr = (x * (1 - x) / (n - 1000)) ** 0.5
        assert abs(mean - x) < 4 * stderr, (mean, x)
    again = PQ.discretize_gradients(g, h, one, one,
                                    torch.Generator().manual_seed(5))
    other = PQ.discretize_gradients(g, h, one, one,
                                    torch.Generator().manual_seed(6))
    assert torch.equal(again[0], gq) and torch.equal(again[1], hq)
    assert not torch.equal(other[0], gq)
    big = torch.tensor([500.0, -500.0, 126.9])
    cq, _ = PQ.discretize_gradients(big, big.abs(), one, one,
                                    torch.Generator().manual_seed(0))
    assert cq[:2].tolist() == [127, -127] and cq[2] in (126, 127)
    with pytest.raises(ValueError, match="Generator"):
        PQ.discretize_gradients(g, h, one, one, None)


def test_quant_generator_per_iteration():
    dev = torch.device("cpu")
    draw = lambda s, i: torch.rand(8, generator=PQ.quant_generator(s, i, dev))
    assert torch.equal(draw(0, 3), draw(0, 3))
    assert not torch.equal(draw(0, 3), draw(0, 4))
    assert not torch.equal(draw(0, 3), draw(1, 3))
    assert torch.equal(draw(-7, 0), draw(-7, 0))       # negative seeds work


@pytest.mark.parametrize("num_bins,levels,level", [
    (4, (2, 4), 4), (1, (1, 1), 1), (7, (3, 7), 7), (64, (32, 64), 64),
    (300, (127, 127), 127)])
def test_levels_and_the_int32_row_bound(num_bins, levels, level):
    """The levels of ``num_grad_quant_bins`` are the JAX package's (its
    scales put the largest |gradient| at exactly that many levels), and
    the int32 histogram bound counts rows against the largest of them:
    536,870,911 rows at the default 4 bins."""
    import jax.numpy as jnp

    from lightgbm_tpu.ops.quantize import gradient_scales as jax_scales
    assert PQ.quant_levels(num_bins) == levels
    assert PQ.max_level(num_bins) == level
    g = np.array([-3.0, 0.5], np.float32)
    h = np.array([0.25, 2.0], np.float32)
    js = [float(v) for v in jax_scales(jnp.asarray(g), jnp.asarray(h),
                                       num_bins)]
    assert js == [float(np.float32(3.0) / np.float32(levels[0])),
                  float(np.float32(2.0) / np.float32(levels[1]))]
    HF.check_int8_rows((2 ** 31 - 1) // level, level)
    with pytest.raises(ValueError, match="overflow"):
        HF.check_int8_rows((2 ** 31 - 1) // level + 1, level)
