"""acids_transforms_tpu_torch -- the PyTorch/CUDA port of ``acids_transforms_tpu``.

Composable, invertible audio transforms as ``torch.nn.Module``s, with the hot
paths (fused log-mel / DGT-magnitude forward and its fit statistics for any
window, the two-channel Polar / PolarIF / Cartesian forward and its
statistics, the Griffin-Lim steps for any window, the PGHI recurrence and
synthesis, the whole-session streaming encode, roundtrips and decode) as
hand-written CUDA kernels for Hopper under ``csrc/``.  Shapes beyond a
kernel's limits raise ``NotImplementedError`` on a CUDA tensor, naming the
kernel's ROADMAP item.

The deployment surface: ``serving.CompiledTransform`` (the bucketed server),
``serving.StreamingSession`` (the live chunk-by-chunk session),
``export.save_transform`` / ``load_transform`` (npz checkpoints in the JAX
package's format) and ``export.export_program`` / ``load_program``
(``torch.export``, with kernel A as a registered operator), every entry point
with ``mesh=`` over a ``torch.distributed`` device mesh (``parallel``: batch
sharding and the sequence-parallel STFT / ISTFT).  ``utils`` holds audio IO,
bucketing, profiling, numerical guards and the collective recorder;
``native`` the C++ host layer (exact heap PGHI, WAV IO, resampler), built with
``g++`` at first use.

Everything runs on a CUDA device unless the caller passes ``device="cpu"``:
constructors take ``device=None`` meaning ``"cuda"`` and raise without a card.
"""
from . import convert, export, fuse, native, ops, parallel, regions, serving, streaming, transforms, utils
from ._device import resolve_device
from .export import export_program, invert_with_phase_fn, load_program, load_transform, save_transform
from .fuse import fuse_fit, fuse_forward
from .serving import CompiledTransform, StreamingSession
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
    "serving",
    "export",
    "utils",
    "parallel",
    "native",
    "CompiledTransform",
    "StreamingSession",
    "save_transform",
    "load_transform",
    "export_program",
    "load_program",
    "invert_with_phase_fn",
    "fuse_forward",
    "fuse_fit",
    "chunk_signal",
    "scan_forward",
    "scan_invert",
    "scan_roundtrip",
    "resolve_device",
    "__version__",
] + list(_transforms_all)
