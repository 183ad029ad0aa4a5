"""Fused mel-spectrogram forward and fit statistics (twin of the JAX
``ops/pallas/spectral.py``, chunk-factored and full-K paths).

``fused_melspec`` computes ``(contrast(|stft(x)|^power @ mel_bank) - offset) /
scale`` and ``fused_melspec_stats`` the fit statistics of ``contrast(|stft(x)|)``
without the framed signal or the spectrogram ever reaching device memory.  On
a CUDA tensor both launch the hand-written kernels of ``csrc/spectral.cu`` (or
raise); on a CPU tensor they run the plain PyTorch version beside them
(``*_reference``), which is also what the kernels are checked against on the
card.  The plain versions are written from the factored formulation
(``ops/fft.py``: chunk DFT, twiddle combine, hermitian taps conv).

Two front ends share one epilogue.  With ``taps`` (a cosine-sum window) the
chunk-factored one runs; with ``taps=None`` and a ``window`` (any window, the
DGT's gaussian for one) the full-K one: frame ``t`` is the slice ``row[t hop :
t hop + n_fft]`` of the same padded rows against a basis of ``n_fft x 2F`` with
the window folded in, ``overlap`` times the multiply-adds of the factored form.
Both need ``hop | n_fft``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..fft import (
    _chunk_dft_matrices,
    _dft_matrices,
    _reflect_pad,
    _tables,
    _taps_conv,
    _twiddle_analysis,
    _twiddles,
)
from . import _build

__all__ = [
    "fused_melspec",
    "fused_melspec_reference",
    "fused_melspec_stats",
    "fused_melspec_stats_reference",
    "fused_melspec_available",
    "launches",
    "reset_launches",
]

TILES = (32, 16, 8)               # frames per block the kernels can run, widest first
MAX_SMEM = 232448                 # bytes of shared memory a block may use on sm_90
_CONTRASTS = {"none": 0, None: 0, "log1p": 1}

#: kernel launches made by the wrappers of this module, by kernel
launches: Dict[str, int] = {
    "fused_melspec": 0, "fused_melspec_stats": 0,
    "fused_melspec_fullk": 0, "fused_melspec_stats_fullk": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _smem_bytes(tile_t: int, hop: int, overlap: int, n_bins: int) -> int:
    """Shared memory of one block, as ``csrc/spectral.cu`` lays it out."""
    work = 2 * 32 * 128 + 2 * 40 * 128 + 2 * 32 * 128 + 2 * 128
    return 4 * ((tile_t + overlap - 1) * hop + tile_t * n_bins + work)


def _pick_tile(hop: int, overlap: int, n_bins: int) -> Optional[int]:
    """Frames per block: the widest tile whose hop chunks, magnitudes and work
    area fit shared memory (32 up to n_fft 1024, 16 at 2048, 8 at 4096), or
    None when none does."""
    for tile_t in TILES:
        if _smem_bytes(tile_t, hop, overlap, n_bins) <= MAX_SMEM:
            return tile_t
    return None


def fused_melspec_available(n_fft: int, hop_length: int, taps) -> bool:
    """Whether the chain's structure suits the CUDA kernels: ``hop | n_fft``
    with 2 <= overlap <= 8, hop a multiple of 32, and either cosine-sum taps
    (P <= 4, the factored front end) or ``taps=None`` (any window, the full-K
    front end).  A shape inside this gate whose narrowest tile still exceeds
    shared memory (n_fft above 4096) is not silently sent elsewhere: the
    wrappers raise ``NotImplementedError`` for it on a CUDA tensor."""
    if (taps is not None and len(taps) > 5) or n_fft % hop_length != 0 or n_fft % 2:
        return False
    overlap = n_fft // hop_length
    return 2 <= overlap <= 8 and hop_length % 32 == 0


def _prepare_rows(x: torch.Tensor, n_fft: int, hop: int, center: bool, tile_t: int = TILES[0]):
    """Centre-pad, pad to the tiled row count plus halo, reshape to hop rows.

    One concatenate builds the padded signal (reflect head, body, reflect
    tail, zero tail); a clip no longer than ``n_fft // 2`` needs several
    reflections and takes the general pad.  Keeps int16 input int16.
    Returns ``(rows (B, n_rows, hop), T, n_tiles)``."""
    B, L = x.shape
    overlap = n_fft // hop
    half = n_fft // 2
    if center:
        T = 1 + L // hop
        padded_len = L + 2 * half
    else:
        T = (L - n_fft) // hop + 1
        padded_len = L
    if T < 1:
        raise ValueError("signal of %d samples is shorter than one frame" % L)
    n_tiles = -(-T // tile_t)
    n_rows = n_tiles * tile_t + overlap - 1
    total = n_rows * hop
    if center and half >= L:
        pieces = [_reflect_pad(x, half)]
    else:
        pieces = []
        if center:
            pieces.append(x[:, 1: half + 1].flip(-1))
        pieces.append(x)
        if center:
            pieces.append(x[:, -half - 1: -1].flip(-1))
    if total > padded_len:
        pieces.append(x.new_zeros((B, total - padded_len)))
    rows = torch.cat(pieces, dim=-1)[:, :total]
    return rows.reshape(B, n_rows, hop).contiguous(), T, n_tiles


def _rows_to_float(rows: torch.Tensor) -> torch.Tensor:
    if rows.dtype == torch.int16:
        return rows.to(torch.float32) * 2.0 ** -15
    return rows


def _factored_spectrum(x, n_fft, hop, center, taps):
    """(re, im) of the windowed STFT from prepared rows: the kernels' front end."""
    rows, T, _ = _prepare_rows(x, n_fft, hop, center)
    rows = _rows_to_float(rows)
    Ch, Sh = _tables(_chunk_dft_matrices, x.device, n_fft, hop)
    Cre = torch.matmul(rows, Ch)
    Cim = torch.matmul(rows, Sh)
    Xre, Xim = _twiddle_analysis(Cre, Cim, n_fft, hop, T)
    return _taps_conv(Xre, Xim, taps)


def _fullk_basis(window: torch.Tensor, n_fft: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``w[n] * (cos, -sin)(2 pi n k / n_fft)`` as two ``(n_fft, F)`` tensors."""
    C, S = _tables(_dft_matrices, window.device, n_fft)
    w = window.to(torch.float32)[:, None]
    return (w * C).contiguous(), (w * S).contiguous()


def _fullk_spectrum(x, n_fft, hop, center, window):
    """(re, im) of the windowed STFT, the full-K kernels' front end: frames
    are overlapping slices of the prepared rows, the window lies in the basis."""
    rows, T, _ = _prepare_rows(x, n_fft, hop, center)
    flat = _rows_to_float(rows).reshape(rows.shape[0], -1)
    frames = flat.unfold(-1, n_fft, hop)[:, :T]
    WC, WS = _fullk_basis(window.to(x.device), n_fft)
    return torch.matmul(frames, WC), torch.matmul(frames, WS)


def _spectrum(x, n_fft, hop, center, taps, window):
    if taps is None:
        return _fullk_spectrum(x, n_fft, hop, center, window)
    return _factored_spectrum(x, n_fft, hop, center, taps)


def _apply_contrast(mag: torch.Tensor, contrast) -> torch.Tensor:
    if contrast == "log1p":
        return torch.log1p(mag)
    if contrast in ("none", None):
        return mag
    raise ValueError(
        "contrast %r is not covered by the fused kernels (log/log10 amplify "
        "the magnitude error without bound near silent bins)" % (contrast,)
    )


def _check_input(x: torch.Tensor, n_fft: int, hop: int, taps, window=None) -> None:
    if x.ndim != 2:
        raise ValueError("expected (B, L) audio, got shape %s" % (tuple(x.shape),))
    if x.dtype not in (torch.float32, torch.int16):
        raise TypeError("audio must be float32 or int16 PCM, got %s" % x.dtype)
    if taps is None and (window is None or window.shape != (n_fft,)):
        raise ValueError(
            "taps=None selects the full-K front end, which needs the analysis "
            "window as window=(n_fft,) tensor"
        )
    if n_fft % hop != 0:
        raise ValueError("the fused kernels require hop | n_fft")


def fused_melspec_reference(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    mel_bank: Optional[torch.Tensor] = None,
    offset=0.0,
    scale=1.0,
    contrast: str = "log1p",
    center: bool = True,
    taps: Optional[tuple] = None,
    power: float = 1.0,
    out_dtype: torch.dtype = torch.float32,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_melspec` (same arguments)."""
    _check_input(x, n_fft, hop_length, taps, window)
    re, im = _spectrum(x, n_fft, hop_length, center, taps, window)
    mag = re * re + im * im
    if power != 2.0:
        mag = torch.sqrt(mag)
    if mel_bank is not None:
        mag = torch.matmul(mag, mel_bank)
    y = (_apply_contrast(mag, contrast) - offset) / scale
    return y.to(out_dtype)


def fused_melspec_stats_reference(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    contrast: str = "log1p",
    center: bool = True,
    taps: Optional[tuple] = None,
    window: Optional[torch.Tensor] = None,
) -> dict:
    """Plain PyTorch version of :func:`fused_melspec_stats`."""
    x = x.reshape((-1, x.shape[-1]))
    _check_input(x, n_fft, hop_length, taps, window)
    re, im = _spectrum(x, n_fft, hop_length, center, taps, window)
    v = _apply_contrast(torch.sqrt(re * re + im * im), contrast)
    vd = v.double()
    return {
        "sum": vd.sum(),
        "sumsq": (vd * vd).sum(),
        "min": v.min(),
        "max": v.max(),
        "count": int(v.numel()),
    }


_band_cache: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _mel_band(bank: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per output column the row range [lo, hi) outside which the bank is
    zero, as int32 tensors on the bank's device.  Read from the bank itself,
    so a custom bank keeps all its contributions; cached per bank version."""
    key = (bank.data_ptr(), bank._version, tuple(bank.shape), str(bank.device))
    hit = _band_cache.get(key)
    if hit is None:
        nz = (bank != 0).cpu().numpy()
        any_nz = nz.any(axis=0)
        lo = np.where(any_nz, nz.argmax(axis=0), 0)
        hi = np.where(any_nz, nz.shape[0] - nz[::-1].argmax(axis=0), 0)
        hit = (
            torch.as_tensor(lo.astype(np.int32), device=bank.device),
            torch.as_tensor(hi.astype(np.int32), device=bank.device),
        )
        if len(_band_cache) > 16:
            _band_cache.clear()
        _band_cache[key] = hit
    return hit


def _front_end(device, n_fft, hop, taps, window):
    """What the entry points take for the front end: the two basis tensors,
    the twiddle pointers (None for full-K), the taps array and ``P`` (-1
    selects the full-K front end)."""
    if taps is None:
        WC, WS = _fullk_basis(window.to(device), n_fft)
        return (WC, WS), None, None, (ctypes.c_float * 5)(), -1
    Ch, Sh = _tables(_chunk_dft_matrices, device, n_fft, hop)
    twr, twi = _tables(_twiddles, device, n_fft, hop)
    taps_c, P = _build.taps_array(taps)
    return (Ch, Sh), twr.data_ptr(), twi.data_ptr(), taps_c, P


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _kernel_tile(n_fft, hop, taps) -> int:
    """The frame tile for this shape, or raise: the kernels never give way."""
    if not fused_melspec_available(n_fft, hop, taps):
        raise ValueError(
            "the CUDA melspec kernels do not cover n_fft=%d hop=%d (need "
            "cosine-sum taps with P <= 4 or taps=None, hop | n_fft, 2 <= "
            "overlap <= 8 and hop %% 32 == 0)" % (n_fft, hop)
        )
    tile_t = _pick_tile(hop, n_fft // hop, n_fft // 2 + 1)
    if tile_t is None:
        raise NotImplementedError(
            "the CUDA melspec kernels hold one block's tile in shared memory, "
            "which n_fft=%d hop=%d exceeds (ROADMAP Queue 2, K1: shapes above "
            "n_fft 4096); use backend='eager'" % (n_fft, hop)
        )
    return tile_t


def fused_melspec(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    mel_bank: Optional[torch.Tensor] = None,
    offset=0.0,
    scale=1.0,
    contrast: str = "log1p",
    center: bool = True,
    taps: Optional[tuple] = None,
    power: float = 1.0,
    out_dtype: torch.dtype = torch.float32,
    window: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused ``(B, L) -> (B, T, n_mels)`` mel-spectrogram pipeline.

    Equivalent to ``(contrast(|stft(x)|^power @ mel_bank) - offset) / scale``
    with torch STFT conventions.  ``mel_bank=None`` skips the mel projection.
    ``taps``: cosine-sum coefficients of the analysis window
    (``ops.fft.taps_for_window``); ``taps=None`` with ``window`` (the analysis
    window itself, any shape of window) takes the full-K front end instead,
    and ``window`` is not read otherwise.  ``offset`` / ``scale`` are floats or 0-d
    tensors on ``x``'s device (no host synchronisation).

    ``x`` may be int16 PCM, read as ``x / 32768`` and converted inside the
    kernel: bit-identical to feeding the pre-converted float32 samples.
    ``out_dtype=torch.bfloat16`` rounds only at the final store, bit-identical
    to ``fused_melspec(...).to(torch.bfloat16)``.
    """
    if x.ndim == 1:
        return fused_melspec(
            x[None], n_fft, hop_length, mel_bank, offset, scale, contrast,
            center, taps, power, out_dtype, window,
        )[0]
    if not x.is_cuda:
        return fused_melspec_reference(
            x, n_fft, hop_length, mel_bank, offset, scale, contrast, center,
            taps, power, out_dtype, window,
        )
    _check_input(x, n_fft, hop_length, taps, window)
    tile_t = _kernel_tile(n_fft, hop_length, taps)
    if contrast not in _CONTRASTS:
        _apply_contrast(x, contrast)  # raises with the reason
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("out_dtype must be float32 or bfloat16")
    if power not in (1.0, 2.0):
        raise ValueError("power must be 1 or 2")
    dev = x.device
    F = n_fft // 2 + 1
    rows, T, n_tiles = _prepare_rows(x, n_fft, hop_length, center, tile_t)
    B = rows.shape[0]
    (bc, bs), twr_p, twi_p, taps_c, P = _front_end(dev, n_fft, hop_length, taps, window)
    if mel_bank is not None:
        if mel_bank.device != dev or mel_bank.dtype != torch.float32 or mel_bank.shape[0] != F:
            raise ValueError("mel_bank must be float32 (n_bins, n_mels) on the input's device")
        bank = mel_bank.contiguous()
        lo, hi = _mel_band(bank)
        M = bank.shape[1]
        bank_p, lo_p, hi_p = bank.data_ptr(), lo.data_ptr(), hi.data_ptr()
    else:
        M, bank_p, lo_p, hi_p = F, None, None, None
    aff = torch.stack(
        [torch.as_tensor(offset, dtype=torch.float32, device=dev).reshape(()),
         torch.as_tensor(scale, dtype=torch.float32, device=dev).reshape(())]
    )
    out = torch.empty((B, T, M), dtype=out_dtype, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.att_melspec_forward(
            rows.data_ptr(), int(rows.dtype == torch.int16), B, n_tiles, tile_t,
            rows.shape[1], hop_length, n_fft // hop_length, F, T,
            bc.data_ptr(), bs.data_ptr(), twr_p, twi_p,
            taps_c, P, int(power == 2.0), _CONTRASTS[contrast],
            bank_p, lo_p, hi_p, M, aff.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), _stream(),
        )
    name = "fused_melspec" if taps is not None else "fused_melspec_fullk"
    _build.check(code, name)
    launches[name] += 1
    return out


def fused_melspec_stats(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    contrast: str = "log1p",
    center: bool = True,
    taps: Optional[tuple] = None,
    window: Optional[torch.Tensor] = None,
) -> dict:
    """One-pass fit statistics of ``contrast(|stft(x)|)`` (``taps`` /
    ``window``: see :func:`fused_melspec`).

    Returns ``{"sum", "sumsq", "min", "max", "count"}`` over the whole (batch,
    frames, bins) spectrogram without materializing it: 0-d tensors on ``x``'s
    device (``sum`` / ``sumsq`` in float64) and ``count`` as an exact Python
    int.  Statistics are taken on the non-mel contrasted magnitude, which is
    what ``Magnitude.fit`` fits on.  Blocks write per-bin partials and a second
    kernel reduces them in a fixed order, so the result is deterministic."""
    if x.ndim == 1:
        x = x[None]
    x = x.reshape((-1, x.shape[-1]))
    if not x.is_cuda:
        return fused_melspec_stats_reference(x, n_fft, hop_length, contrast, center, taps, window)
    _check_input(x, n_fft, hop_length, taps, window)
    tile_t = _kernel_tile(n_fft, hop_length, taps)
    if contrast not in _CONTRASTS:
        _apply_contrast(x, contrast)  # raises with the reason
    dev = x.device
    F = n_fft // 2 + 1
    rows, T, n_tiles = _prepare_rows(x, n_fft, hop_length, center, tile_t)
    B = rows.shape[0]
    (bc, bs), twr_p, twi_p, taps_c, P = _front_end(dev, n_fft, hop_length, taps, window)
    partials = torch.empty((B * n_tiles, 4, F), dtype=torch.float32, device=dev)
    stats = torch.empty((4, F), dtype=torch.float64, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.att_melspec_stats(
            rows.data_ptr(), int(rows.dtype == torch.int16), B, n_tiles, tile_t,
            rows.shape[1], hop_length, n_fft // hop_length, F, T,
            bc.data_ptr(), bs.data_ptr(), twr_p, twi_p,
            taps_c, P, _CONTRASTS[contrast], partials.data_ptr(),
            stats.data_ptr(), _stream(),
        )
    name = "fused_melspec_stats" if taps is not None else "fused_melspec_stats_fullk"
    _build.check(code, name)
    launches[name] += 1
    return {
        "sum": stats[0].sum(),
        "sumsq": stats[1].sum(),
        "min": stats[2].min().float(),
        "max": stats[3].max().float(),
        "count": B * T * F,
    }
