"""Device resolution for the port's entry points.

Every entry point runs on the CUDA card unless its caller asks for the CPU
(``device="cpu"``, as the tests do).  There is no silent CPU fallback: a
request for the card on a machine without one raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises if no card is visible); ``"cpu"`` only
    when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lightgbm_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
