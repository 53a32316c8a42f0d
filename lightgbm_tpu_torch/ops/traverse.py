"""Quantized tree-ensemble traversal: the wrapper of the hand-written CUDA
kernel ``ops/csrc/traverse.cu`` (the port of the JAX package's
``ops/pallas_traverse.py::fused_class_sums``).

On a CUDA tensor ``fused_class_sums`` launches the kernel on PyTorch's
current stream, or raises.  On a CPU tensor it runs the kernel's plain
version, ``models/tree._ensemble_sum_q``.  The TPU kernel's VMEM fit gate,
lane padding and i32 widening have no counterpart: the kernel reads the
int16/uint8 pack as ``quantize_stack_trees`` emits it.
"""

from __future__ import annotations

import torch

from ..models.tree import _QPACK_ARRAYS, _ensemble_sum_q

#: kernel launches made by ``fused_class_sums`` in this process (a plain
#: int; chip_smoke.py zeroes it before driving the serving path)
launches = 0

_BLOCK_ROWS = 128
#: resident blocks per SM the tree-axis split aims for on small batches
_BLOCKS_PER_SM = 8
_MAX_GRID_Y = 65535

_DTYPES = {
    "split_feature": (torch.int16,), "split_bin": (torch.int16,),
    "default_left": (torch.bool,), "is_cat": (torch.bool,),
    "cat_bits": (torch.uint8,), "left_child": (torch.int16,),
    "right_child": (torch.int16,), "leaf_q": (torch.int16, torch.int8),
}


def _check(pack: dict, bins: torch.Tensor, nan_bins: torch.Tensor) -> None:
    if bins.dim() != 2 or bins.dtype != torch.int32:
        raise ValueError(f"bins must be (N, F) int32, got {tuple(bins.shape)} "
                         f"{bins.dtype}")
    if (nan_bins.dim() != 1 or nan_bins.dtype != torch.int32
            or nan_bins.shape[0] != bins.shape[1]):
        raise ValueError(f"nan_bins must be ({bins.shape[1]},) int32, got "
                         f"{tuple(nan_bins.shape)} {nan_bins.dtype}")
    t, m = pack["split_feature"].shape
    for k in _QPACK_ARRAYS:
        a = pack[k]
        if a.dtype not in _DTYPES[k]:
            raise ValueError(f"pack[{k!r}] has dtype {a.dtype}, expected "
                             f"{_DTYPES[k]}")
        if a.device != bins.device or not a.is_contiguous():
            raise ValueError(f"pack[{k!r}] must be contiguous on {bins.device}")
        if a.shape[0] != t or (k != "leaf_q" and a.shape[1] != m):
            raise ValueError(f"pack[{k!r}] has shape {tuple(a.shape)}, "
                             f"expected ({t}, {m}, ...)")
    if pack["cat_bits"].dim() != 3:
        raise ValueError("pack['cat_bits'] must be (T, M, ceil(B/8))")
    for name, a in (("bins", bins), ("nan_bins", nan_bins)):
        if a.device != bins.device or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {bins.device}")


def fused_class_sums(pack: dict, bins: torch.Tensor,
                     nan_bins: torch.Tensor) -> torch.Tensor:
    """(N,) int32 sums of leaf quanta for one quantized pack."""
    _check(pack, bins, nan_bins)
    if bins.device.type == "cpu":
        return _ensemble_sum_q(pack, bins, nan_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"unsupported device {bins.device}")
    return _launch(pack, bins, nan_bins)


def _launch(pack: dict, bins: torch.Tensor,
            nan_bins: torch.Tensor) -> torch.Tensor:
    global launches
    from ._build import load_library
    lib = load_library()
    n, f = bins.shape
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=bins.device)
    t, m = pack["split_feature"].shape
    bb = pack["cat_bits"].shape[2]
    leaf = pack["leaf_q"]
    row_blocks = -(-n // _BLOCK_ROWS)
    sms = torch.cuda.get_device_properties(bins.device).multi_processor_count
    split = max(1, min(t, -(-sms * _BLOCKS_PER_SM // max(row_blocks, 1))))
    trees_per_block = max(-(-t // split), -(-t // _MAX_GRID_Y), 1)
    split = -(-t // trees_per_block)
    out = (torch.zeros if split > 1 else torch.empty)(
        n, dtype=torch.int32, device=bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    with torch.cuda.device(bins.device):
        err = lib.lgbt_traverse_sums(
            bins.data_ptr(), nan_bins.data_ptr(),
            pack["split_feature"].data_ptr(), pack["split_bin"].data_ptr(),
            pack["default_left"].data_ptr(), pack["is_cat"].data_ptr(),
            pack["cat_bits"].data_ptr(), pack["left_child"].data_ptr(),
            pack["right_child"].data_ptr(), leaf.data_ptr(),
            8 * leaf.element_size(), out.data_ptr(),
            n, f, t, m, bb, int(leaf.shape[1]), int(pack["depth"]),
            trees_per_block, _BLOCK_ROWS, stream)
    if err != 0:
        raise RuntimeError(f"traverse kernel launch failed: CUDA error {err}")
    launches += 1
    return out
