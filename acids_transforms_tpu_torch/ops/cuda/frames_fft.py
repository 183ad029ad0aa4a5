"""The shared-memory FFT of frames (``csrc/fft_smem.cuh:frames_rfft``): its
route rule, its tables and its plain version.

``frames_rfft`` computes the windowed real DFT ``X_r[k] = sum_n w[n] x_r[n]
e^{-2 pi i n k / n_fft}``, ``k <= n_fft / 2``, of every frame of a block, in
float32.  The session encode (R, and the magnitude encode of N) and the
full-K melspec front end (E, F) run it wherever :func:`fft_covers` takes
``n_fft``; every other ``n_fft`` keeps the window-folded product of
``dft_common.cuh``.  The rule reads ``n_fft`` alone.

The schedule, which :func:`frames_rfft_reference` repeats step for step:

* frames ``2j`` and ``2j + 1`` go through one complex FFT as ``z[n] = w[n]
  x_2j[n] + i w[n] x_2j+1[n]`` (an odd last frame pairs with a zero frame);
* the FFT is a Stockham auto-sort FFT: radix-4 stages, then one radix-2
  stage when ``log2 n_fft`` is odd.  Stage ``p`` (stride ``s = 4^p``) reads
  ``x[b + k n/4]``, ``k < 4``, for each butterfly ``b < n/4`` and writes
  ``y[4b - 3q + s k]`` (``q = b mod s``), the outputs 1-3 turned by the
  twiddles ``e^{-2 pi i k (b - q) / n}`` of one table built in float64 and
  rounded to float32 (:func:`fft_twiddles`).  The kernel runs two stages per
  trip through shared memory, which changes no operation;
* the split ``X_2j[k] = (Z[k] + conj Z[n - k]) / 2``, ``X_2j+1[k] = (Z[k] -
  conj Z[n - k]) / 2i``.

Every product and sum is one float32 operation rounded on its own (the kernel
uses ``__fmul_rn`` / ``__fadd_rn``, so the compiler contracts nothing), in
the order written here.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..fft import _tables

__all__ = [
    "FFT_MIN", "FFT_MAX", "fft_covers", "fft_twiddles", "fft_team_threads", "fft_max_teams",
    "fft_smem_floats", "frames_rfft_reference",
]

FFT_MIN, FFT_MAX = 64, 4096       # the sizes frames_rfft takes (powers of two)
THREADS = 256                     # threads of a block (dft_common.cuh kThreads)
VALUES = 16                       # complex values a thread holds in a pass


def fft_covers(n_fft: int) -> bool:
    """Whether the FFT route takes ``n_fft``: a power of two from 64 to 4096.
    The encode and the full-K melspec front end run the window-folded product
    for every other ``n_fft``."""
    n = int(n_fft)
    return FFT_MIN <= n <= FFT_MAX and n & (n - 1) == 0


@functools.lru_cache(maxsize=None)
def fft_twiddles(n_fft: int) -> np.ndarray:
    """``(cos, -sin)(2 pi j / n_fft)`` for ``j < n_fft`` as a ``(2, n_fft)``
    float32 table, computed in float64 and rounded once."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)]).astype(np.float32)


def fft_team_threads(n_fft: int) -> int:
    """Threads that run one FFT together: ``n_fft / 16``, so that each holds
    16 complex values in a pass (two warps at 1024, the block at 4096)."""
    return n_fft // VALUES


def fft_max_teams(n_fft: int) -> int:
    """FFTs a block of 256 threads runs at the same time."""
    return THREADS // fft_team_threads(n_fft)


def fft_smem_floats(n_fft: int, teams: int) -> int:
    """Shared memory of the FFT in floats, as ``csrc/fft_smem.cuh`` lays it
    out: the window (n_fft), the twiddles ``j < 3 n_fft / 4`` (cos and -sin),
    and per team a buffer of re and im and ``n_fft / 32`` floats more (so that
    teams sharing a warp start on other banks)."""
    return n_fft + 2 * (3 * n_fft // 4) + teams * (2 * n_fft + n_fft // 32)


def _stockham(re: torch.Tensor, im: torch.Tensor, twr: torch.Tensor, twi: torch.Tensor):
    """The complex FFT of the rows of ``(re, im)`` ``(P, n)``, natural order,
    in the kernel's passes."""
    P, n = re.shape
    s, nn = 1, n
    while nn >= 4:
        m = nn // 4
        ar, br, cr, dr = re.reshape(P, 4, m, s).unbind(1)
        ai, bi, ci, di = im.reshape(P, 4, m, s).unbind(1)
        apc_r, apc_i = ar + cr, ai + ci
        amc_r, amc_i = ar - cr, ai - ci
        bpd_r, bpd_i = br + dr, bi + di
        bmd_r, bmd_i = br - dr, bi - di
        # -i (b - d) = (bmd_i, -bmd_r)
        u = ((apc_r + bpd_r, apc_i + bpd_i),
             (amc_r + bmd_i, amc_i - bmd_r),
             (apc_r - bpd_r, apc_i - bpd_i),
             (amc_r - bmd_i, amc_i + bmd_r))
        base = torch.arange(m, device=re.device)[:, None] * s          # b - q = p s
        outs_r, outs_i = [u[0][0]], [u[0][1]]
        for k in (1, 2, 3):
            wr, wi = twr[k * base], twi[k * base]                       # (m, 1), over q
            ur, ui = u[k]
            outs_r.append(ur * wr - ui * wi)
            outs_i.append(ur * wi + ui * wr)
        # y[q + s (4 p + k)]: (P, m, 4, s)
        re = torch.stack(outs_r, dim=2).reshape(P, n)
        im = torch.stack(outs_i, dim=2).reshape(P, n)
        s, nn = 4 * s, m
    if nn == 2:
        ar, br = re.reshape(P, 2, s).unbind(1)
        ai, bi = im.reshape(P, 2, s).unbind(1)
        re = torch.stack([ar + br, ar - br], dim=1).reshape(P, n)
        im = torch.stack([ai + bi, ai - bi], dim=1).reshape(P, n)
    return re, im


def frames_rfft_reference(frames: torch.Tensor, window: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``frames_rfft``: ``(re, im)`` ``(..., T, n_fft // 2 +
    1)`` of the windowed frames ``(..., T, n_fft)``, float32, in the kernel's
    schedule (module notes): pairs ``(2j, 2j + 1)`` along ``T``, the Stockham
    passes, the split.  Uses no ``torch.fft``."""
    n = frames.shape[-1]
    if not fft_covers(n):
        raise ValueError("frames_rfft takes n_fft a power of two from %d to %d, got %d" % (FFT_MIN, FFT_MAX, n))
    lead, T = frames.shape[:-2], frames.shape[-2]
    x = frames.reshape((-1, T, n)).to(torch.float32)
    if T % 2:
        x = torch.cat([x, x.new_zeros((x.shape[0], 1, n))], dim=1)
    w = window.to(device=x.device, dtype=torch.float32)
    pairs = x.reshape(x.shape[0], -1, 2, n)
    re = (w * pairs[:, :, 0]).reshape(-1, n)
    im = (w * pairs[:, :, 1]).reshape(-1, n)
    (tw,) = _tables(fft_twiddles, x.device, n)
    zr, zi = _stockham(re, im, tw[0], tw[1])
    F = n // 2 + 1
    k = torch.arange(F, device=x.device)
    a, b = zr[:, :F], zi[:, :F]
    c, d = zr[:, (n - k) % n], zi[:, (n - k) % n]
    x0r, x0i = (a + c) * 0.5, (b - d) * 0.5
    x1r, x1i = (b + d) * 0.5, (c - a) * 0.5
    re = torch.stack([x0r, x1r], dim=1).reshape(x.shape[0], -1, F)[:, :T]
    im = torch.stack([x0i, x1i], dim=1).reshape(x.shape[0], -1, F)[:, :T]
    return re.reshape(lead + (T, F)), im.reshape(lead + (T, F))
