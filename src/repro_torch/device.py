"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for ``cpu``;
nothing falls back from one to the other."""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``device`` (default ``cuda``) as a ``torch.device``. Raises when a
    CUDA device is asked for and none is available, rather than running on
    the CPU behind the caller's back."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev} is neither cuda nor cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def exact_float32() -> None:
    """Keep float32 products in full float32: the reference computes in
    float32, and TF32 (about three decimal digits) would change results."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
