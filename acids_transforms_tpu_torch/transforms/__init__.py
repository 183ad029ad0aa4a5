"""Flat transform namespace of the port (the classes ported so far)."""
from .base import (
    AudioTransform,
    ComposeAudioTransform,
    InversionEnumType,
    NotInvertibleError,
)
from .dgt import DGT
from .norm import Normalize
from .raw import Mono
from .spectral_repr import Dummy, Magnitude
from .stft import STFT

__all__ = [
    "AudioTransform",
    "ComposeAudioTransform",
    "NotInvertibleError",
    "InversionEnumType",
    "Mono",
    "STFT",
    "DGT",
    "Dummy",
    "Magnitude",
    "Normalize",
]

#: classes of the JAX package that the port does not have yet, with the
#: ROADMAP item that brings them
_UNPORTED = {
    "Stereo": "Queue 1 item 6", "MidSide": "Queue 1 item 6", "Window": "Queue 1 item 6",
    "MuLaw": "Queue 1 item 6", "Unsqueeze": "Queue 1 item 6", "Squeeze": "Queue 1 item 6",
    "Transpose": "Queue 1 item 6", "OneHot": "Queue 1 item 6", "MFCC": "Queue 1 item 7",
    "Real": "Queue 1 item 8", "Imaginary": "Queue 1 item 8",
    "Phase": "Queue 1 item 8", "IF": "Queue 1 item 8",
    "SpectralRepresentation": "Queue 1 item 8", "Cartesian": "Queue 1 item 8",
    "Polar": "Queue 1 item 8", "PolarIF": "Queue 1 item 8",
    "OverlapAdd": "Queue 1 item 9", "RealtimeSTFT": "Queue 1 item 9",
    "RealtimeDGT": "Queue 1 item 9",
}


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            "transforms.%s is not ported yet (ROADMAP %s)" % (name, _UNPORTED[name])
        )
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
