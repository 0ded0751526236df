"""Device selection shared by the port's entry points.

Every entry point takes a ``device``. Left unset it means ``"cuda"``; the
port never carries on quietly on the CPU when a GPU was expected.

``torch`` is imported when a device is resolved, not with this module, so
that the FUSE daemon (``repro_torch.fs.fusebridge``), whose userspace
binding launches no kernel, starts without loading it."""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Union

if TYPE_CHECKING:
    import torch

DeviceLike = Optional[Union[str, "torch.device"]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``: ``None`` means CUDA. Raises when a
    CUDA device is asked for (explicitly or by default) and none is
    present, and for device types the port has no path for."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
