"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device`` with its index; ``None`` means the
    GPU.  With no GPU, ``None`` raises: the CPU runs only when the caller
    asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain torch versions on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_devices(devices=None) -> list[torch.device]:
    """A device list, each entry as :func:`resolve_device` gives it (a list
    may repeat a device); ``None`` means every visible GPU.  With no GPU,
    ``None`` raises: the CPU runs only when the caller asks for it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] to run the "
                               "plain torch versions on the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("the device list is empty")
    return out
