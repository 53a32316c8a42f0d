"""Gradient discretization for quantized training (``use_quantized_grad``).

The port of the JAX package's ``ops/quantize.py`` (reference
``GradientDiscretizer``, ``gradient_discretizer.hpp:128``): gradients and
hessians become int8 levels under per-iteration scales, histograms
accumulate them in int32, and the split scan rescales each cell to f32.

Stochastic rounding draws from an explicit ``torch.Generator`` where the
JAX package draws from a ``jax.random`` key: the two streams differ, so
stochastic levels match the JAX package's in distribution, not bit for
bit.  Deterministic rounding (``stochastic=False``) is bitwise the JAX
package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_EPS = 1e-30


def quant_levels(num_bins: int) -> Tuple[int, int]:
    """(grad, hess) levels of ``num_grad_quant_bins`` = ``num_bins``:
    ``num_bins // 2`` signed gradient levels and ``num_bins`` hessian
    levels, each capped at 127 (int8 storage)."""
    return min(max(num_bins // 2, 1), 127), min(max(num_bins, 1), 127)


def max_level(num_bins: int) -> int:
    """The largest level any channel of a quantized row holds (the count
    channel's is 1): N rows' int32 histogram sums stay exact while
    N * max_level <= 2^31 - 1."""
    return max(*quant_levels(num_bins), 1)


def gradient_scales(grad: torch.Tensor, hess: torch.Tensor,
                    num_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 scales mapping grad and hess onto their ``quant_levels``."""
    g_levels, h_levels = quant_levels(num_bins)
    g_scale = torch.clamp_min(grad.abs().max() / g_levels, _EPS)
    h_scale = torch.clamp_min(hess.abs().max() / h_levels, _EPS)
    return g_scale.to(torch.float32), h_scale.to(torch.float32)


def discretize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                         g_scale: torch.Tensor, h_scale: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         stochastic: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 (grad, hess) levels.  Stochastic: ``floor(x / scale + U[0,1))``
    with the uniforms drawn from ``generator`` (grad's first, then hess's),
    so E[q * scale] = x and an exact zero stays zero.  Deterministic:
    round half to even.  Both clip to +-127."""
    gs = grad / g_scale
    hs = hess / h_scale
    if stochastic:
        if generator is None:
            raise ValueError("stochastic rounding needs a torch.Generator")
        ug = torch.rand(gs.shape, generator=generator, dtype=gs.dtype,
                        device=gs.device)
        uh = torch.rand(hs.shape, generator=generator, dtype=hs.dtype,
                        device=hs.device)
        gq = torch.floor(gs + ug)
        hq = torch.floor(hs + uh)
    else:
        gq = torch.round(gs)
        hq = torch.round(hs)
    gq = torch.clamp(gq, -127, 127).to(torch.int8)
    hq = torch.clamp(hq, -127, 127).to(torch.int8)
    return gq, hq


def _splitmix64(x: int) -> int:
    """splitmix64's finalizer: neighbouring inputs get unrelated outputs."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def quant_generator(seed: int, iteration: int, device: torch.device,
                    class_id: Optional[int] = None) -> torch.Generator:
    """The generator of one boosting iteration's stochastic rounding: a
    ``torch.Generator`` on ``device`` seeded from ``(seed, iteration)``
    (the JAX package folds the iteration into ``PRNGKey(seed)``).  With K
    trees an iteration each class ``class_id`` draws from its own stream,
    seeded from ``(seed, iteration, class_id)`` (the JAX package folds the
    class in as well); ``class_id=None`` keeps the one-tree stream."""
    x = _splitmix64((int(seed) & 0xFFFFFFFF) << 32
                    | (int(iteration) & 0xFFFFFFFF))
    if class_id is not None:
        x = _splitmix64(x ^ (int(class_id) & 0xFFFFFFFF))
    gen = torch.Generator(device=device)
    gen.manual_seed(x)
    return gen
