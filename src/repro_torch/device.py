"""Where the port runs: the CUDA card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. A CUDA device with no card present raises:
    the port never carries on quietly on the CPU; pass ``device="cpu"`` to
    run there on purpose."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"the port runs on cuda or cpu (meta: shapes "
                         f"only, for counts and specs), not {dev}")
    return dev

