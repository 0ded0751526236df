"""Device selection shared by the port's entry points.

Every entry point takes a ``device``. Left unset it means ``"cuda"``; the
port never carries on quietly on the CPU when a GPU was expected.

``torch`` is imported when a device is resolved, not with this module, so
that the FUSE daemon (``repro_torch.fs.fusebridge``), whose userspace
binding launches no kernel, starts without loading it."""

from __future__ import annotations

import os
import sys
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


def takes_kernels(t: "torch.Tensor") -> bool:
    """Whether ``t`` goes down the card's path of the model code (the CUDA
    kernels in place of their plain versions): a CUDA tensor, or a meta
    tensor, on which ``launch.dryrun`` traces the card's programs without
    data or a device (each kernel's operator then allocates its outputs
    and launches nothing). CPU tensors take the plain path."""
    return t.is_cuda or t.is_meta


ALLOC_CONF = "expandable_segments:True"


def configure_allocator() -> str:
    """Lets PyTorch's CUDA caching allocator grow its segments in place
    (``expandable_segments``) unless the caller has set
    ``PYTORCH_CUDA_ALLOC_CONF``, and returns the setting in force. A
    training step frees and takes tensors of many sizes (the recompute
    backwards): with fixed segments llama-3.2-vision-11b's step at depth
    5 ran out of an 80 GB card with 8.5 GiB reserved but unusable. The
    allocator reads the setting when CUDA starts, so this raises if CUDA
    has started with no setting."""
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    if conf is not None:
        return conf
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError("configure_allocator() must run before CUDA "
                           "starts in the process")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = ALLOC_CONF
    return ALLOC_CONF
