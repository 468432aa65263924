"""Device resolution for the port's entry points."""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device` or, when None, the CUDA card. Raises if a CUDA device is asked
    for (explicitly or by default) and none is present: the port never falls
    back to the CPU unless the caller passes `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' to "
                           "run the port on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index` (launch plans size
    their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
