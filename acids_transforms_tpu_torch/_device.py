"""Device resolution for the port: the card by default, the CPU only on request.

Every constructor and entry point takes ``device=None``, which means
``"cuda"``.  Without a CUDA device that raises: nothing in this package moves
work to the CPU on its own.  An input tensor that lies on another device than
the transform it is given to raises as well.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "check_device", "same_device", "under_fake_tensors"]

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "acids_transforms_tpu_torch runs on a CUDA device by default "
                "and none is available; pass device='cpu' to run the plain "
                "PyTorch formulation on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def under_fake_tensors() -> bool:
    """Whether a fake-tensor trace (a shape probe, ``torch.export``) is
    running: no kernel may be launched there and no tensor cached."""
    try:
        return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None
    except AttributeError:  # a torch without the mode keys has no such trace either
        return False


def same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    return a.index is None or b.index is None or a.index == b.index


def check_device(x: torch.Tensor, device: torch.device, what: str = "input") -> None:
    """Raise when ``x`` does not lie on ``device`` (no silent transfer)."""
    if not same_device(x.device, device):
        raise ValueError(
            "%s lies on %s but the transform was built for %s; move one of "
            "them explicitly" % (what, x.device, device)
        )
