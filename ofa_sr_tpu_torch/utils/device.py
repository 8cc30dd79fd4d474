"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; a CUDA device must exist, and comes back
    with its index ("cuda" as "cuda:<current>"), so it compares equal to a
    tensor's device.

    The port runs on the GPU unless the caller asks for the CPU: there is no
    silent fallback when no GPU is present.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU" % str(device))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_name(device="cuda") -> str:
    """The card's name (`torch.cuda.get_device_name`), or "cpu"; raises
    as `resolve_device` does."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
