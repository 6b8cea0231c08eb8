"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(spec: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) / ``"cpu"`` -> a ``torch.device``.

    A CUDA device that this process cannot see raises: the port never falls
    back to the CPU behind the caller's back — a CPU run is something the
    caller asks for by name.
    """
    dev = torch.device(spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(spec)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' to run on the host")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(spec)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {spec!r}")
    return dev
