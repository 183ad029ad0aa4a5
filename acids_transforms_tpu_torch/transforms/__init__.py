"""Flat transform namespace of the port (the classes ported so far)."""
from .base import (
    AudioTransform,
    ComposeAudioTransform,
    InversionEnumType,
    NotInvertibleError,
)
from .dgt import DGT, RealtimeDGT
from .norm import Normalize
from .oadd import OverlapAdd
from .raw import Mono
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
    "Mono",
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
#: ROADMAP item that brings them
_UNPORTED = {
    "Stereo": "Queue 1 item 6", "MidSide": "Queue 1 item 6", "Window": "Queue 1 item 6",
    "MuLaw": "Queue 1 item 6", "Unsqueeze": "Queue 1 item 6", "Squeeze": "Queue 1 item 6",
    "Transpose": "Queue 1 item 6", "OneHot": "Queue 1 item 6", "MFCC": "Queue 1 item 7",
}


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            "transforms.%s is not ported yet (ROADMAP %s)" % (name, _UNPORTED[name])
        )
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
