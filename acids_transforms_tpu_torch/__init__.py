"""acids_transforms_tpu_torch -- the PyTorch/CUDA port of ``acids_transforms_tpu``.

Composable, invertible audio transforms as ``torch.nn.Module``s, with the hot
paths (fused log-mel / DGT-magnitude forward and its fit statistics for any
window, the two-channel Polar / PolarIF / Cartesian forward and its
statistics, the Griffin-Lim steps for any window, the PGHI recurrence and
synthesis, the whole-session streaming encode, roundtrips and decode) as
hand-written CUDA kernels for Hopper under ``csrc/``.  The port is built slice
by slice; what is not ported yet raises ``NotImplementedError`` naming its
ROADMAP item.

Everything runs on a CUDA device unless the caller passes ``device="cpu"``:
constructors take ``device=None`` meaning ``"cuda"`` and raise without a card.
"""
from . import convert, fuse, ops, regions, streaming, transforms
from ._device import resolve_device
from .fuse import fuse_fit, fuse_forward
from .streaming import chunk_signal, scan_forward, scan_invert, scan_roundtrip
from .transforms import *  # noqa: F401,F403
from .transforms import __all__ as _transforms_all
from .version import __version__

__all__ = [
    "transforms",
    "ops",
    "fuse",
    "convert",
    "regions",
    "streaming",
    "fuse_forward",
    "fuse_fit",
    "chunk_signal",
    "scan_forward",
    "scan_invert",
    "scan_roundtrip",
    "resolve_device",
    "__version__",
] + list(_transforms_all)
