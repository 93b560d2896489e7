"""Learning-rate schedules for the port's SGD (momentum) trainer. Only the
constant schedule the megabatch trainer uses is ported so far."""
from __future__ import annotations

from typing import Callable

import torch


def constant_lr(lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """``step -> lr`` as float32, shaped and placed like ``step``."""
    return lambda step: torch.full(step.shape, lr, dtype=torch.float32,
                                   device=step.device)
