"""ctypes binding of the native WAV loader / writer / resampler
(``native/wavio.cc``)."""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from . import build

__all__ = ["available", "load_wav", "save_wav", "resample"]

_declared = False
_f32p = ctypes.POINTER(ctypes.c_float)


def _lib() -> ctypes.CDLL:
    global _declared
    lib = build.load()
    if not _declared:
        lib.att_load_wav.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(_f32p),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.att_load_wav.restype = ctypes.c_int
        lib.att_save_wav.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32]
        lib.att_save_wav.restype = ctypes.c_int
        lib.att_resample.argtypes = [
            _f32p,
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(_f32p),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.att_resample.restype = ctypes.c_int
        lib.att_free.argtypes = [ctypes.c_void_p]
        lib.att_free.restype = None
        _declared = True
    return lib


def available() -> bool:
    """Whether the library builds and loads here (nothing in the package
    falls back when it does not: its callers raise)."""
    try:
        _lib()
        return True
    except (RuntimeError, OSError):
        return False


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """``(float32 (channels, n), sample_rate)`` of a WAV file."""
    lib = _lib()
    out = _f32p()
    ch, n, sr = ctypes.c_int32(), ctypes.c_int64(), ctypes.c_int32()
    rc = lib.att_load_wav(str(path).encode(), ctypes.byref(out), ctypes.byref(ch), ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        raise ValueError("att_load_wav failed with code %d for %s" % (rc, path))
    arr = np.ctypeslib.as_array(out, shape=(ch.value, n.value)).copy()
    lib.att_free(out)
    return arr, int(sr.value)


def save_wav(path: str, x: np.ndarray, sr: int = 44100) -> None:
    """Write ``(channels, n)`` or ``(n,)`` float audio as a float32 WAV."""
    lib = _lib()
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    rc = lib.att_save_wav(str(path).encode(), x.ctypes.data_as(_f32p), x.shape[0], x.shape[1], int(sr))
    if rc != 0:
        raise ValueError("att_save_wav failed with code %d" % rc)


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Kaiser-sinc polyphase resampling of the last axis."""
    lib = _lib()
    x = np.ascontiguousarray(x, dtype=np.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    out = _f32p()
    n_out = ctypes.c_int64()
    rc = lib.att_resample(
        x.ctypes.data_as(_f32p), x.shape[0], x.shape[1], int(sr_in), int(sr_out),
        ctypes.byref(out), ctypes.byref(n_out),
    )
    if rc != 0:
        raise ValueError("att_resample failed with code %d" % rc)
    arr = np.ctypeslib.as_array(out, shape=(x.shape[0], n_out.value)).copy()
    lib.att_free(out)
    return arr[0] if squeeze else arr
