"""ctypes binding of the native exact-heap PGHI (``native/pghi.cc``)."""
from __future__ import annotations

import ctypes

import numpy as np

from . import build

__all__ = ["available", "pghi"]

_declared = False


def _lib() -> ctypes.CDLL:
    global _declared
    lib = build.load()
    if not _declared:
        lib.att_pghi.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_double,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.att_pghi.restype = None
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


def pghi(mag: np.ndarray, gamma: float, n_fft: int, hop: int, tol: float) -> np.ndarray:
    """Exact heap PGHI of one ``(T, F)`` magnitude spectrogram."""
    lib = _lib()
    mag = np.ascontiguousarray(mag, dtype=np.float32)
    T, F = mag.shape
    out = np.empty((T, F), dtype=np.float32)
    lib.att_pghi(
        mag.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        T,
        F,
        float(gamma),
        int(n_fft),
        int(hop),
        float(tol),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
