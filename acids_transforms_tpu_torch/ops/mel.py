"""Mel filterbank construction (HTK scale), matching
``torchaudio.functional.melscale_fbanks`` numerics.

The port's own copy of the JAX package's numpy-only ``ops/mel.py``: importing
anything from that package pulls in jax, so the bank constructors live here too.
Banks are built in float64 numpy at construction time and handed to the
transforms, which keep them as float32 buffers on their device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["melscale_fbanks", "square_mel_banks", "mel_banks"]


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def melscale_fbanks(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_freqs, n_mels)``.

    HTK mel scale, no area normalization — the ``torchaudio`` defaults used by
    the reference.  FFT bin centres are ``linspace(0, sr // 2, n_freqs)``.
    """
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    f_pts = _mel_to_hz(m_pts)

    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float64)


def square_mel_banks(
    n_fft: int, sr: int, keep_nyquist: bool = True, inverse: str = "transpose"
) -> Tuple[np.ndarray, np.ndarray]:
    """Square (n_bins x n_bins) forward/pseudo-inverse mel pair.

    Mirrors the reference ``Magnitude`` construction
    (spectral_repr.py:170-189): filters span the FFT bin frequency range with
    ``n_mels = n_bins``; the forward bank is column-normalized.

    ``inverse`` selects the inversion operator:

    * ``"transpose"`` — the reference's row-normalized transpose (a crude
      pseudo-inverse; default for behavioural parity);
    * ``"pinv"``      — Tikhonov-regularized least squares
      ``(B^T B + lam I)^-1 B^T`` of the *forward* bank, computed once in
      float64 at construction.  Reconstructs magnitudes ~an order of
      magnitude more accurately (see tests/test_transforms.py).

    Returns ``(mel_bank (F, M), inverse_mel_bank (M, F))`` float32.
    """
    n_bins = n_fft // 2 + 1
    fft_scale = np.arange(n_bins) / n_fft * sr
    if not keep_nyquist:
        fft_scale = fft_scale[1:]
    fb = melscale_fbanks(n_bins, float(fft_scale[0]), float(fft_scale[-1]), n_bins, sr)

    col = fb.sum(axis=0)
    fwd = fb / np.where(col != 0.0, col, 1.0)[None, :]
    if inverse == "pinv":
        lam = 1e-6
        gram = fwd.T @ fwd + lam * np.eye(fwd.shape[1])
        inv = np.linalg.solve(gram, fwd.T)
    elif inverse == "transpose":
        row = fb.sum(axis=1)
        inv = (fb / np.where(row != 0.0, row, 1.0)[:, None]).T
    else:
        raise ValueError("unknown mel inverse %r" % inverse)
    return fwd.astype(np.float32), inv.astype(np.float32)


def mel_banks(
    n_fft: int,
    sr: int,
    n_mels: int,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
) -> np.ndarray:
    """Rectangular mel bank ``(n_bins, n_mels)`` float32 of ``MFCC`` (the
    torchaudio ``MelSpectrogram`` defaults).  A filter narrower than the bin
    spacing can be all zeros (mel 0 of ``mel_banks(1024, 44100, 128)``)."""
    if f_max is None:
        f_max = sr / 2.0
    return melscale_fbanks(n_fft // 2 + 1, f_min, f_max, n_mels, sr).astype(np.float32)
