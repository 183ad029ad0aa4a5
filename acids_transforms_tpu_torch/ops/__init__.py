"""Numerical kernels of the port: framing, windows, DFT-as-GEMM STFT, mel,
mu-law, phase (unwrap, IF differences and integrals), Griffin-Lim, PGHI, and the
hand-written CUDA kernels under ``ops.cuda``."""
from . import fft, framing, griffinlim, mel, mulaw, pghi, phase, windows
from .fft import istft, matmul_precision, set_matmul_precision, stft
from .framing import frame, overlap_add, pad_axis, reshape_batches

__all__ = [
    "fft",
    "framing",
    "griffinlim",
    "mel",
    "mulaw",
    "pghi",
    "phase",
    "windows",
    "stft",
    "istft",
    "set_matmul_precision",
    "matmul_precision",
    "frame",
    "overlap_add",
    "pad_axis",
    "reshape_batches",
]
