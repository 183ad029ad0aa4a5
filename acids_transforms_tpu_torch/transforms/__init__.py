"""Flat transform namespace of the port: every transform class of the JAX
package."""
from .base import (
    AudioTransform,
    ComposeAudioTransform,
    InversionEnumType,
    NotInvertibleError,
    apply_invert_transform_to_list,
    apply_transform_to_list,
)
from .dgt import DGT, RealtimeDGT
from .mel import MFCC
from .misc import OneHot, Squeeze, Transpose, Unsqueeze
from .norm import Normalize
from .oadd import OverlapAdd
from .raw import MidSide, Mono, MuLaw, Stereo, Window
from .spectral_repr import (
    IF,
    Cartesian,
    Dummy,
    Imaginary,
    Magnitude,
    Phase,
    Polar,
    PolarIF,
    Real,
    SpectralRepresentation,
)
from .stft import STFT, RealtimeSTFT

__all__ = [
    "AudioTransform",
    "ComposeAudioTransform",
    "NotInvertibleError",
    "InversionEnumType",
    "apply_transform_to_list",
    "apply_invert_transform_to_list",
    "Mono",
    "Stereo",
    "MidSide",
    "Window",
    "MuLaw",
    "Unsqueeze",
    "Squeeze",
    "Transpose",
    "OneHot",
    "MFCC",
    "STFT",
    "RealtimeSTFT",
    "DGT",
    "RealtimeDGT",
    "OverlapAdd",
    "Dummy",
    "Real",
    "Imaginary",
    "Magnitude",
    "Phase",
    "IF",
    "SpectralRepresentation",
    "Cartesian",
    "Polar",
    "PolarIF",
    "Normalize",
]

#: classes of the JAX package that the port does not have yet, with the
#: ROADMAP item that brings them (none since the transform classes are all in)
_UNPORTED: dict = {}


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            "transforms.%s is not ported yet (ROADMAP %s)" % (name, _UNPORTED[name])
        )
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
