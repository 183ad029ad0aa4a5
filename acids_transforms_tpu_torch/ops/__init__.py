"""Numerical kernels of the port: framing, windows, DFT-as-GEMM STFT, mel,
phase (unwrap, IF differences and integrals), Griffin-Lim, PGHI, and the
hand-written CUDA kernels under ``ops.cuda``."""
from . import fft, framing, griffinlim, mel, pghi, phase, windows
from .fft import istft, stft
from .framing import frame, overlap_add, pad_axis

__all__ = [
    "fft",
    "framing",
    "griffinlim",
    "mel",
    "pghi",
    "phase",
    "windows",
    "stft",
    "istft",
    "frame",
    "overlap_add",
    "pad_axis",
]
