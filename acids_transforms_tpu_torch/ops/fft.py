"""STFT / ISTFT engine with ``torch.stft`` conventions, DFT as matrix products.

Twin of the JAX ``ops/fft.py``.  Conventions: ``center=True`` with reflect
padding, ``onesided=True``, ``normalized=False``, analysis window length
``n_fft``; the ISTFT is the least-squares inversion (synthesis window applied
to inverse frames, overlap-add, division by the squared-window envelope,
centre trim to ``hop * (T - 1)`` samples).  Layout is frame-major
``(..., frames, bins)`` everywhere.

Spectral backends (``impl``):

* ``"matmul"`` (``"auto"`` up to ``MATMUL_MAX_NFFT``): windowed frames against
  the cos/sin DFT matrices, two ``torch.matmul`` calls;
* ``"matmul2"``: the radix-2 split, two half-size real DFTs of the even and
  odd samples (one product batch) combined by a gather and the twiddles;
  the inverse takes the direct product, as in the JAX package;
* ``"fft"``: ``torch.fft``;
* ``"factored"``: the chunk-DFT factorization for cosine-sum windows.  It is
  the plain formulation the CUDA kernels (``ops/cuda``) are written from.

The matrix products here lie outside any hand-written kernel (as they lay
outside the Pallas kernels in the JAX package), so they stay ``torch.matmul``;
:func:`set_matmul_precision` picks their float32 precision, full float32 with
TF32 off unless the caller asks for less.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import under_fake_tensors
from .framing import frame, overlap_add

__all__ = [
    "stft",
    "stft_real",
    "istft",
    "rfft_frames",
    "irfft_frames",
    "spectral_frames",
    "window_taps",
    "taps_for_window",
    "set_matmul_precision",
    "matmul_precision",
    "MATMUL_MAX_NFFT",
]

MATMUL_MAX_NFFT = 4096

#: the JAX package's precision names -> torch's float32 matmul precision:
#: "highest" is full float32 (TF32 off), "high" lets the card use TF32 (about
#: three decimal digits, outside the 1e-4 budget of the STFT roundtrip),
#: "default" bfloat16 products where the backend has them
_PRECISIONS = {"default": "medium", "high": "high", "highest": "highest"}
_PRECISION = "highest"


def set_matmul_precision(precision: str) -> None:
    """Set the float32 precision of the products of the eager formulation
    ("default", "high" or "highest"; the port's default is "highest").  It is
    torch's process-wide ``torch.set_float32_matmul_precision``: the
    hand-written kernels compute in float32 whatever it says."""
    global _PRECISION
    if precision not in _PRECISIONS:
        raise ValueError("matmul precision must be one of %s, got %r" % (sorted(_PRECISIONS), precision))
    _PRECISION = precision
    torch.set_float32_matmul_precision(_PRECISIONS[precision])


def matmul_precision() -> str:
    """The name :func:`set_matmul_precision` last set."""
    return _PRECISION


# set here so that the port's numerics do not depend on what the caller's
# process set before
set_matmul_precision("highest")


@functools.lru_cache(maxsize=None)
def _dft_matrices(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Forward real-DFT basis: cos/-sin matrices of shape (n_fft, n_bins)."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _idft_matrices(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse real-DFT basis: (n_bins, n_fft) matrices A, B with
    ``x = Re @ A + Im @ B`` reproducing ``irfft`` (hermitian weights folded in)."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    w = np.full((n_bins, 1), 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    A = (w * np.cos(ang) / n_fft).astype(np.float32)
    B = (-w * np.sin(ang) / n_fft).astype(np.float32)
    return A, B


@functools.lru_cache(maxsize=None)
def _chunk_dft_matrices(n_fft: int, hop: int) -> Tuple[np.ndarray, np.ndarray]:
    """Full-resolution DFT basis restricted to one hop chunk: (hop, n_bins)."""
    n = np.arange(hop)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddles(n_fft: int, hop: int) -> Tuple[np.ndarray, np.ndarray]:
    """``e^{-2 pi i k j hop / n_fft}`` as (overlap, n_bins) cos/-sin tables."""
    overlap = n_fft // hop
    j = np.arange(overlap)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k * j * hop / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _hermitian_weights(n_fft: int) -> np.ndarray:
    """Per-bin weights ``2/n_fft`` (``1/n_fft`` at DC and nyquist) of the
    inverse real DFT."""
    wgt = np.full(n_fft // 2 + 1, 2.0, np.float32)
    wgt[0] = 1.0
    if n_fft % 2 == 0:
        wgt[-1] = 1.0
    return (wgt / n_fft).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _on_device(builder, args: tuple, device_str: str) -> Tuple[torch.Tensor, ...]:
    """The numpy tables of ``builder(*args)`` as tensors on ``device_str``."""
    out = builder(*args)
    if isinstance(out, np.ndarray):
        out = (out,)
    return tuple(torch.as_tensor(m, device=device_str) for m in out)


def _tables(builder, device: torch.device, *args) -> Tuple[torch.Tensor, ...]:
    if under_fake_tensors():  # a shape probe's fake tables must not be cached
        return _on_device.__wrapped__(builder, args, str(device))
    return _on_device(builder, args, str(device))


def _resolve_impl(impl: str, n_fft: int) -> str:
    if impl == "auto":
        return "matmul" if n_fft <= MATMUL_MAX_NFFT else "fft"
    if impl == "factored":
        # already-framed entry points have no chunk structure to exploit
        return "matmul"
    if impl not in ("fft", "matmul", "matmul2"):
        raise ValueError("unknown fft impl %r" % impl)
    return impl


@functools.lru_cache(maxsize=None)
def _radix2_tables(n_fft: int):
    """Tables of the radix-2 decimation-in-time rDFT ``X[k] = E[k] + W^k O[k]``
    (E, O the half-size DFTs of the even and odd samples): per bin k the index
    of ``k mod M`` (M = n_fft / 2) into the half-size rDFT, the sign of its
    imaginary part (conjugated where reflected), and the twiddle ``W^k``."""
    M = n_fft // 2
    k = np.arange(n_fft // 2 + 1)
    km = k % M
    idx = np.minimum(km, M - km)
    sign_im = (1.0 - 2.0 * (km > M // 2)).astype(np.float32)
    tw_re = np.cos(2.0 * np.pi * k / n_fft).astype(np.float32)
    tw_im = (-np.sin(2.0 * np.pi * k / n_fft)).astype(np.float32)
    return idx.astype(np.int64), sign_im, tw_re, tw_im


def _rfft_radix2(frames_w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) of the rDFT by the radix-2 split: both half-size rDFTs in one
    pair of products, then the gather and the twiddle combine."""
    n_fft, T = frames_w.shape[-1], frames_w.shape[-2]
    if n_fft % 2:
        raise ValueError("impl='matmul2' needs an even n_fft, got %d" % n_fft)
    Ch, Sh = _tables(_dft_matrices, frames_w.device, n_fft // 2)
    eo = torch.cat([frames_w[..., 0::2], frames_w[..., 1::2]], dim=-2)
    re_h, im_h = torch.matmul(eo, Ch), torch.matmul(eo, Sh)
    idx, sign_im, tw_re, tw_im = _tables(_radix2_tables, frames_w.device, n_fft)
    er, orr = re_h[..., :T, :].index_select(-1, idx), re_h[..., T:, :].index_select(-1, idx)
    ei, oi = im_h[..., :T, :].index_select(-1, idx) * sign_im, im_h[..., T:, :].index_select(-1, idx) * sign_im
    return er + tw_re * orr - tw_im * oi, ei + tw_re * oi + tw_im * orr


def rfft_frames(frames_w: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """rFFT of windowed frames ``(..., T, n_fft) -> (..., T, n_fft//2+1)`` complex."""
    n_fft = int(frames_w.shape[-1])
    impl = _resolve_impl(impl, n_fft)
    if impl == "fft":
        return torch.fft.rfft(frames_w, dim=-1)
    if impl == "matmul2":
        return torch.complex(*_rfft_radix2(frames_w))
    C, S = _tables(_dft_matrices, frames_w.device, n_fft)
    return torch.complex(torch.matmul(frames_w, C), torch.matmul(frames_w, S))


def irfft_frames(
    spec: torch.Tensor, n_fft: Optional[int] = None, impl: str = "auto"
) -> torch.Tensor:
    """Inverse rFFT of frames ``(..., T, n_bins) -> (..., T, n_fft)``."""
    n_bins = spec.shape[-1]
    if n_fft is None:
        n_fft = 2 * (n_bins - 1)
    impl = _resolve_impl(impl, n_fft)
    if impl == "fft":
        if n_fft % 2 == 0 and n_bins == n_fft // 2 + 1:
            # a real signal has no imaginary part at DC and nyquist: pocketfft
            # and XLA ignore it, cuFFT's C2R leaves the result undefined (on
            # an H100 at n_fft 8192 it moved frames by 6.5e-3 of their peak)
            keep = torch.ones(n_bins, dtype=spec.real.dtype, device=spec.device)
            keep[0] = keep[-1] = 0.0
            spec = torch.complex(spec.real, spec.imag * keep)
        return torch.fft.irfft(spec, n=n_fft, dim=-1)
    A, B = _tables(_idft_matrices, spec.device, n_fft)
    return torch.matmul(spec.real, A) + torch.matmul(spec.imag, B)


def _reflect_pad(x: torch.Tensor, pad: int, mode: str = "reflect") -> torch.Tensor:
    """Pad the last axis on both sides; ``reflect`` with as many reflections
    as the pad needs (``F.pad`` refuses a pad as long as the signal)."""
    if pad == 0:
        return x
    if mode != "reflect":
        return F.pad(x, (pad, pad), mode=mode)
    L = x.shape[-1]
    if pad < L:
        lead = x.shape[:-1]
        y = F.pad(x.reshape(-1, 1, L), (pad, pad), mode="reflect")
        return y.reshape(lead + (L + 2 * pad,))
    if L == 1:
        return x.expand(x.shape[:-1] + (1 + 2 * pad,)).clone()
    period = 2 * (L - 1)
    idx = (torch.arange(-pad, L + pad, device=x.device) % period)
    idx = torch.where(idx >= L, period - idx, idx)
    return x.index_select(-1, idx)


def spectral_frames(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    window: torch.Tensor,
    center: bool = True,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """Centre-pad and slice ``x (..., L)`` into windowed frames ``(..., T, n_fft)``."""
    if center:
        x = _reflect_pad(x, n_fft // 2, pad_mode)
    return frame(x, n_fft, hop_length, axis=-1) * window


# -- cosine-sum window factorization ------------------------------------------
#
# For windows that are short cosine sums (hann = 0.5 - 0.5 cos(2 pi n / N),
# hamming, blackman), the DFT of the window has 2P+1 nonzero bins (P = 1 for
# hann), so the *windowed* frame DFT factors exactly:
#
#   DFT(w . x_t)[k] = sum_p c_p X_t[k - p]            (P-tap spectral conv)
#   X_t[k]          = sum_j e^{-2 pi i k j hop / N} C[t + j, k]   (twiddle)
#   C[c, k]         = sum_{m < hop} x[c hop + m] e^{-2 pi i k m / N}
#
# where C is the DFT of the *non-overlapping* hop chunks against the
# full-resolution basis: a K=hop product computed once per chunk and reused
# by all `overlap` frames covering it.


@functools.lru_cache(maxsize=None)
def window_taps(
    window_key, tol: float = 1e-8, max_p: int = 4
) -> Optional[Tuple[float, ...]]:
    """Spectral taps ``(c_0, .., c_P)`` of a cosine-sum window, else None.

    ``window_key`` is the float64 bytes of the window; returns the real
    symmetric DFT coefficients ``c_p = W[p] / N`` when the window's DFT is
    supported on ``|p| <= max_p`` (hann/hamming: P=1, blackman: P=2)."""
    w = np.frombuffer(window_key, dtype=np.float64)
    n = w.shape[0]
    W = np.fft.fft(w) / n
    mag = np.abs(W)
    scale = float(mag.max())
    if scale == 0.0:
        return None
    nz = np.where(mag > tol * scale)[0]
    signed = np.where(nz <= n // 2, nz, nz - n)
    P = int(np.abs(signed).max()) if signed.size else 0
    if P > max_p:
        return None
    for p in range(P + 1):
        if abs(W[p].imag) > tol * scale * n:
            return None
        if p and abs(W[p] - W[-p]) > tol * scale * n:
            return None
    return tuple(float(W[p].real) for p in range(P + 1))


def taps_for_window(window) -> Optional[Tuple[float, ...]]:
    """Concrete-window convenience wrapper around :func:`window_taps`."""
    if isinstance(window, torch.Tensor):
        window = window.detach().cpu().numpy()
    w = np.asarray(window, dtype=np.float64)
    return window_taps(w.tobytes())


def _taps_conv(Xre: torch.Tensor, Xim: torch.Tensor, taps):
    """Hermitian-aware P-tap convolution along the bin axis:
    ``Y[k] = sum_p c_p (X[k-p] + X[k+p])`` with ``X[-m] = conj(X[m])`` and
    ``X[N+m] = conj(X[N-m])`` (real signal, N = nyquist index)."""
    Yre = taps[0] * Xre
    Yim = taps[0] * Xim
    for p in range(1, len(taps)):
        c = taps[p]
        # X[k-p]: left edge k < p wraps to conj(X[p-k])
        rp_re = torch.cat([Xre[..., 1: p + 1].flip(-1), Xre[..., :-p]], -1)
        rp_im = torch.cat([-Xim[..., 1: p + 1].flip(-1), Xim[..., :-p]], -1)
        # X[k+p]: right edge k > N-p reflects to conj(X[2N-k-p])
        lp_re = torch.cat([Xre[..., p:], Xre[..., -p - 1: -1].flip(-1)], -1)
        lp_im = torch.cat([Xim[..., p:], -Xim[..., -p - 1: -1].flip(-1)], -1)
        Yre = Yre + c * (rp_re + lp_re)
        Yim = Yim + c * (rp_im + lp_im)
    return Yre, Yim


def _twiddle_analysis(Cre: torch.Tensor, Cim: torch.Tensor, n_fft: int, hop: int, T: int):
    """``X[t] = sum_j tw_j C[t + j]`` for ``t < T`` (frame t collects the
    ``overlap`` chunks it covers)."""
    twr, twi = _tables(_twiddles, Cre.device, n_fft, hop)
    Xre = Xim = None
    for j in range(n_fft // hop):
        cr = Cre[..., j: j + T, :]
        ci = Cim[..., j: j + T, :]
        re_j = twr[j] * cr - twi[j] * ci
        im_j = twr[j] * ci + twi[j] * cr
        Xre = re_j if Xre is None else Xre + re_j
        Xim = im_j if Xim is None else Xim + im_j
    return Xre, Xim


def _twiddle_synthesis(Yre: torch.Tensor, Yim: torch.Tensor, n_fft: int, hop: int):
    """``D[c] = sum_j conj(tw_j) Y[c - j]`` for the ``T + overlap - 1`` chunks
    the ``T`` frames cover (chunk c collects frames ``c - j``)."""
    overlap = n_fft // hop
    twr, twi = _tables(_twiddles, Yre.device, n_fft, hop)
    T = Yre.shape[-2]
    Dre = Yre.new_zeros(Yre.shape[:-2] + (T + overlap - 1, Yre.shape[-1]))
    Dim = torch.zeros_like(Dre)
    for j in range(overlap):
        Dre[..., j: j + T, :] += twr[j] * Yre + twi[j] * Yim
        Dim[..., j: j + T, :] += twr[j] * Yim - twi[j] * Yre
    return Dre, Dim


def _stft_factored(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    taps: Tuple[float, ...],
    center: bool,
    pad_mode: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) STFT via the chunk-DFT factorization (see module comment)."""
    overlap = n_fft // hop_length
    if center:
        x = _reflect_pad(x, n_fft // 2, pad_mode)
    Lp = x.shape[-1]
    T = (Lp - n_fft) // hop_length + 1
    n_rows = T - 1 + overlap
    chunks = x[..., : n_rows * hop_length].reshape(x.shape[:-1] + (n_rows, hop_length))
    Ch, Sh = _tables(_chunk_dft_matrices, x.device, n_fft, hop_length)
    Cre = torch.matmul(chunks, Ch)
    Cim = torch.matmul(chunks, Sh)
    Xre, Xim = _twiddle_analysis(Cre, Cim, n_fft, hop_length, T)
    return _taps_conv(Xre, Xim, taps)


def stft_real(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    window: torch.Tensor,
    center: bool = True,
    pad_mode: str = "reflect",
    impl: str = "auto",
    taps: Optional[Tuple[float, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """STFT returning ``(re, im)`` without a complex intermediate.

    ``impl="factored"`` (with ``taps`` from :func:`taps_for_window`, and
    ``hop | n_fft``) runs the chunk-DFT factorization; every other impl takes
    the windowed-frames path."""
    if impl == "factored":
        if taps is None:
            raise ValueError(
                "impl='factored' needs cosine-sum window taps "
                "(taps_for_window); this window is not a cosine sum"
            )
        if n_fft % hop_length != 0:
            raise ValueError("impl='factored' requires hop | n_fft")
        return _stft_factored(x, n_fft, hop_length, taps, center, pad_mode)
    frames_w = spectral_frames(x, n_fft, hop_length, window, center, pad_mode)
    impl = _resolve_impl(impl, n_fft)
    if impl == "matmul":
        C, S = _tables(_dft_matrices, x.device, n_fft)
        return torch.matmul(frames_w, C), torch.matmul(frames_w, S)
    if impl == "matmul2":
        return _rfft_radix2(frames_w)
    spec = torch.fft.rfft(frames_w, dim=-1)
    return spec.real, spec.imag


def stft(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    window: torch.Tensor,
    center: bool = True,
    pad_mode: str = "reflect",
    impl: str = "auto",
    taps: Optional[Tuple[float, ...]] = None,
) -> torch.Tensor:
    """Short-time Fourier transform, torch conventions, frame-major output.

    ``x (..., L) -> complex (..., T, n_fft//2+1)`` with ``T = 1 + L // hop``
    when ``center=True``."""
    re, im = stft_real(x, n_fft, hop_length, window, center, pad_mode, impl, taps)
    return torch.complex(re, im)


def _istft_factored_frames(
    spec: torch.Tensor, n_fft: int, hop_length: int, taps: Tuple[float, ...]
) -> torch.Tensor:
    """``overlap_add(irfft(spec) * w, hop)`` via the chunk factorization.

    The synthesis window multiply is the hermitian taps conv in the spectral
    domain; the OLA target chunk ``c`` collects the ``overlap`` frames
    covering it as conjugate-twiddled accumulations, and one K=n_bins product
    against the (n_bins, hop) restricted inverse basis produces the samples.
    Returns the un-normalized OLA signal of length ``(T-1) hop + n_fft``."""
    overlap = n_fft // hop_length
    T = spec.shape[-2]
    re, im = _taps_conv(spec.real, spec.imag, taps)
    (scale,) = _tables(_hermitian_weights, spec.device, n_fft)
    Dre, Dim = _twiddle_synthesis(re * scale, im * scale, n_fft, hop_length)
    Ch, Sh = _tables(_chunk_dft_matrices, spec.device, n_fft, hop_length)
    chunks = torch.matmul(Dre, Ch.T) + torch.matmul(Dim, Sh.T)
    n_rows = T + overlap - 1
    return chunks.reshape(chunks.shape[:-2] + (n_rows * hop_length,))


def istft(
    spec: torch.Tensor,
    n_fft: int,
    hop_length: int,
    window: torch.Tensor,
    center: bool = True,
    length: Optional[int] = None,
    impl: str = "auto",
    taps: Optional[Tuple[float, ...]] = None,
) -> torch.Tensor:
    """Least-squares ISTFT matching ``torch.istft`` (frame-major input).

    ``spec (..., T, n_bins) -> (..., hop * (T - 1))`` when ``center=True`` and
    ``length`` is None.  ``taps``: cosine-sum coefficients of the *synthesis*
    window, used by ``impl="factored"``."""
    T = spec.shape[-2]
    if impl == "factored":
        if taps is None or n_fft % hop_length != 0:
            raise ValueError("impl='factored' needs cosine-sum taps and hop | n_fft")
        y = _istft_factored_frames(spec, n_fft, hop_length, taps)
    else:
        y = overlap_add(irfft_frames(spec, n_fft=n_fft, impl=impl) * window, hop_length)

    env = overlap_add((window ** 2).expand(T, n_fft), hop_length)
    tiny = torch.finfo(y.dtype).tiny
    y = y / torch.where(env > tiny, env, torch.ones_like(env))

    if center:
        start = n_fft // 2
        if length is None:
            stop = y.shape[-1] - (n_fft - n_fft // 2)
        else:
            stop = start + length
        y = y[..., start:stop]
        if length is not None and y.shape[-1] < length:
            y = F.pad(y, (0, length - y.shape[-1]))
    elif length is not None:
        y = y[..., :length]
    return y
