"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when CUDA is asked for (or left as the default) and
    there is none: an entry point never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def on_card(t: torch.Tensor, op: str) -> bool:
    """A kernel wrapper's route: True for a CUDA tensor (launch the kernel),
    False for a CPU tensor (the plain PyTorch version). Any other device
    raises: there is no silent fallback."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{op} has no kernel for device {t.device}")


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE division on every device. On CUDA, PyTorch
    applies a Python-number divisor as a multiply by its reciprocal; a 0-d
    tensor on the same device keeps it a division, bit-identical to the
    host path and to the JAX package (x / 3 != x * (1 / 3) in fp32). The
    divisor is filled on the device, so nothing waits for the stream."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)
