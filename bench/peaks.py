"""Published peaks of the card the benchmark runs on, from NVIDIA's data
sheet (dense rates, no sparsity). The rates hold at the card's full power
limit (700 W for the H100 SXM); a card set below it runs slower under load,
so every result carries the limit that ``nvidia-smi`` reads beside it.

Columns: the name ``torch.cuda.get_device_name()`` gives, HBM bytes/s,
float32 FLOP/s on the CUDA cores, bf16 FLOP/s on the tensor cores, label.
A card not in the table reads no share of a peak."""
from __future__ import annotations

from typing import NamedTuple, Optional

PEAKS = (("NVIDIA H100 80GB HBM3", 3.35e12, 67e12, 989e12, "H100 SXM"),)


class Peaks(NamedTuple):
    hbm_bytes_per_s: float
    float32: float
    bfloat16: float
    label: str

    def flops(self, dtype: str) -> float:
        """The peak at a precision named as the traffic files name it."""
        return {"float32": self.float32, "bfloat16": self.bfloat16}[dtype]


def card_peaks(name: str) -> Optional[Peaks]:
    """The peaks of the card called ``name``, or None for a card that is
    not in the table."""
    for key, *rates, label in PEAKS:
        if key == name:
            return Peaks(*rates, label)
    return None
