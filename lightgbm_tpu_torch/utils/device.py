"""Device resolution for the port's entry points.

The port runs on the card unless the caller asks for the CPU: with no
device named it takes ``cuda``, and without a card that is an error, never
a quiet fall back to the CPU.
"""
from __future__ import annotations

import torch

from .log import LightGBMError


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise LightGBMError(
                "no CUDA device is available; lightgbm_tpu_torch runs on the "
                "card by default (pass device='cpu' to run its plain "
                "PyTorch versions on the CPU)")
    elif dev.type != "cpu":
        raise LightGBMError("device must be 'cuda' or 'cpu', got %r"
                            % (device,))
    return dev


def is_device_error(exc: BaseException) -> bool:
    """Whether `exc` came from the card (out of memory, a failed launch or
    copy, an illegal address, no card at all): the faults a control loop
    must raise, where it logs a bad model file and carries on."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    text = str(exc)
    if isinstance(exc, LightGBMError):
        return "no CUDA device" in text
    return isinstance(exc, RuntimeError) and ("CUDA" in text
                                              or "cuda" in text)
