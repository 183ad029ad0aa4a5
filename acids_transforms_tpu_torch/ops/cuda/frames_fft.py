"""The shared-memory FFT of frames (``csrc/fft_smem.cuh``: ``frames_rfft``,
``frames_irfft``, ``frames_roundtrip``): its route rule, its tables, its
block plans and its plain versions.

``frames_rfft`` computes the windowed real DFT ``X_r[k] = sum_n w[n] x_r[n]
e^{-2 pi i n k / n_fft}``, ``k <= n_fft / 2``, of every frame of a block, in
float32; ``frames_irfft`` the windowed inverse ``y_r[i] = wsyn[i] sum_k c_k
Re(X_r[k] e^{2 pi i k i / n_fft})`` (``c_0 = c_{n/2} = 1``, else 2; ``wsyn``
the synthesis window over ``n_fft``, :func:`irfft_window`), whose frames the
caller overlap-adds in class order (:func:`overlap_add_classes`).  The
session encode (R, the magnitude encode of N) and the full-K melspec and
representation front ends (E, F, G, H) run the forward; K's synthesis the
inverse; the full-K Griffin-Lim step (J) both; the streaming roundtrips (L,
M) both in one team (``frames_roundtrip``), wherever :func:`fft_covers`
takes ``n_fft``; every other ``n_fft`` keeps the window-folded products of
``dft_common.cuh`` and ``synth_ola.cuh``.  The rule reads ``n_fft`` alone.

The schedule, which :func:`frames_rfft_reference` and
:func:`frames_irfft_reference` repeat step for step:

* frames ``r`` and ``r + stride`` go through one complex FFT, pairs of
  frames ``2 stride g + c`` and ``stride`` more (``c < stride``; ``stride =
  1``: ``2j`` and ``2j + 1``), a missing partner a zero frame; forward, as
  ``z[n] = w[n] x_a[n] + i w[n] x_b[n]``;
* the FFT is a Stockham auto-sort FFT: radix-4 stages, then one radix-2
  stage when ``log2 n_fft`` is odd.  Stage ``p`` (stride ``s = 4^p``) reads
  ``x[b + k n/4]``, ``k < 4``, for each butterfly ``b < n/4`` and writes
  ``y[4b - 3q + s k]`` (``q = b mod s``), the outputs 1-3 turned by the
  twiddles ``e^{-2 pi i k (b - q) / n}`` of one table built in float64 and
  rounded to float32 (:func:`fft_twiddles`).  The kernel runs two stages per
  trip through shared memory, which changes no operation;
* forward, the split ``X_a[k] = (Z[k] + conj Z[n - k]) / 2``, ``X_b[k] =
  (Z[k] - conj Z[n - k]) / 2i``;
* inverse, ``Z = X_a + i X_b`` over ``k < n`` (``X[n - k] = conj X[k]``, the
  imaginary parts at DC and nyquist dropped) goes in as ``conj Z``; the same
  forward passes give ``Y``, and ``x_a = wsyn Re Y``, ``x_b = -(wsyn Im
  Y)``.

Every product and sum is one float32 operation rounded on its own (the kernel
uses ``__fmul_rn`` / ``__fadd_rn``, so the compiler contracts nothing), in
the order written here: on the card the kernels come out bit-identical to
these plain versions.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..fft import _tables

__all__ = [
    "FFT_MIN", "FFT_MAX", "fft_covers", "fft_twiddles", "fft_team_threads", "fft_max_teams",
    "fft_smem_floats", "frames_rfft_reference", "frames_irfft_reference", "irfft_window",
    "overlap_add_classes", "class_plan", "taps_window",
]

FFT_MIN, FFT_MAX = 64, 4096       # the sizes frames_rfft takes (powers of two)
THREADS = 256                     # threads of a block (dft_common.cuh kThreads)
VALUES = 16                       # complex values a thread holds in a pass
MAX_SMEM = 232448                 # bytes of shared memory a block may use on sm_90
TWO_BLOCKS_SMEM = 233472 // 2 - 1024   # a block's share when two run on one SM (1 KB reserved each)


def fft_covers(n_fft: int) -> bool:
    """Whether the FFT route takes ``n_fft``: a power of two from 64 to 4096.
    R, E, F, G, H, J, K's synthesis, L and M run the window-folded products
    for every other ``n_fft``."""
    n = int(n_fft)
    return FFT_MIN <= n <= FFT_MAX and n & (n - 1) == 0


@functools.lru_cache(maxsize=None)
def fft_twiddles(n_fft: int) -> np.ndarray:
    """``(cos, -sin)(2 pi j / n_fft)`` for ``j < n_fft`` as a ``(2, n_fft)``
    float32 table, computed in float64 and rounded once."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def taps_window(taps: Tuple[float, ...], n_fft: int) -> np.ndarray:
    """The cosine-sum window of ``taps``, ``w[i] = taps[0] + 2 sum_{p >= 1}
    taps[p] cos(2 pi p i / n_fft)``, built in float64 and rounded once: the
    window the factored front end's taps conv applies, which the FFT route
    applies in the time domain (the Griffin-Lim step C / D / I, the log-mel
    forward and fit A and B, the representations' fit statistics H), so that
    both routes compute one function of the taps."""
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    w = sum((1.0 if p == 0 else 2.0) * c * np.cos(p * ang) for p, c in enumerate(taps))
    return np.asarray(w, dtype=np.float32)


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


def class_plan(n_fft: int, hop: int, smem_bytes: Callable[[int, int], int],
               analysis_pairs: Optional[Callable[[int], int]] = None,
               widest: int = 64) -> Optional[Tuple[int, int]]:
    """``(rows, teams)`` of a block that runs ``frames_irfft`` (or
    ``frames_roundtrip``) over the ``rows + 2 overlap`` frames behind ``rows``
    chunks, ``rows`` a multiple of ``2 overlap`` (so that its first frame
    starts a pair group of the whole signal), as many FFTs side by side as 256
    threads run: the ``rows`` with the most chunks per round of pair FFTs
    (``overlap`` classes of ``rows / (2 overlap) + 1`` pairs, plus
    ``analysis_pairs(rows)`` pairs of a separate analysis) among those whose
    block ``smem_bytes(rows, teams)`` leaves room for a second one on the SM,
    else among those that fit at all; None when none fits."""
    ov = n_fft // hop
    teams = fft_max_teams(n_fft)
    for limit in (TWO_BLOCKS_SMEM, MAX_SMEM):
        best, score = None, 0.0
        for rows in range(2 * ov, widest + 1, 2 * ov):
            if smem_bytes(rows, teams) > limit:
                break
            rounds = ov * -(-(rows // (2 * ov) + 1) // teams)
            if analysis_pairs is not None:
                rounds += -(-analysis_pairs(rows) // teams)
            if rows / rounds > score:
                best, score = rows, rows / rounds
        if best is not None:
            return best, teams
    return None


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


def _pairs(x: torch.Tensor, stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pairs of frames ``(..., T, m)`` -> ``(first, second)`` ``(P, m)``:
    frames ``2 stride g + c`` and ``2 stride g + c + stride`` (``c < stride``),
    ``T`` padded with zero frames to a multiple of ``2 stride``."""
    T, m = x.shape[-2], x.shape[-1]
    x = x.reshape((-1, T, m))
    pad = -T % (2 * stride)
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad, m))], dim=1)
    g = x.reshape(x.shape[0], -1, 2, stride, m)
    return g[:, :, 0].reshape(-1, m), g[:, :, 1].reshape(-1, m)


def _unpairs(first: torch.Tensor, second: torch.Tensor, lead, T: int, stride: int) -> torch.Tensor:
    """Inverse of :func:`_pairs`: ``(P, m)`` twice -> ``(lead..., T, m)``."""
    m = first.shape[-1]
    n_lead = int(np.prod(lead)) if len(lead) else 1
    y = torch.stack([first.reshape(n_lead, -1, stride, m), second.reshape(n_lead, -1, stride, m)], dim=2)
    return y.reshape(n_lead, -1, m)[:, :T].reshape(tuple(lead) + (T, m))


def _check_size(n: int) -> None:
    if not fft_covers(n):
        raise ValueError("frames_rfft takes n_fft a power of two from %d to %d, got %d" % (FFT_MIN, FFT_MAX, n))


def frames_rfft_reference(frames: torch.Tensor, window: torch.Tensor,
                          stride: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``frames_rfft``: ``(re, im)`` ``(..., T, n_fft // 2 +
    1)`` of the windowed frames ``(..., T, n_fft)``, float32, in the kernel's
    schedule (module notes): pairs ``(2 stride g + c, 2 stride g + c +
    stride)`` along ``T`` (``stride = 1``: ``(2j, 2j + 1)``), the Stockham
    passes, the split.  Uses no ``torch.fft``."""
    n = frames.shape[-1]
    _check_size(n)
    lead, T = frames.shape[:-2], frames.shape[-2]
    x = frames.to(torch.float32)
    w = window.to(device=x.device, dtype=torch.float32)
    first, second = _pairs(x, stride)
    (tw,) = _tables(fft_twiddles, x.device, n)
    zr, zi = _stockham(w * first, w * second, tw[0], tw[1])
    F = n // 2 + 1
    k = torch.arange(F, device=x.device)
    a, b = zr[:, :F], zi[:, :F]
    c, d = zr[:, (n - k) % n], zi[:, (n - k) % n]
    x0r, x0i = (a + c) * 0.5, (b - d) * 0.5
    x1r, x1i = (b + d) * 0.5, (c - a) * 0.5
    return _unpairs(x0r, x1r, lead, T, stride), _unpairs(x0i, x1i, lead, T, stride)


def irfft_window(window: torch.Tensor, n_fft: int) -> torch.Tensor:
    """The synthesis window as ``frames_irfft`` takes it: ``window / n_fft``
    in float32 (exact: ``n_fft`` is a power of two)."""
    return window.to(torch.float32) * (1.0 / n_fft)


def frames_irfft_reference(re: torch.Tensor, im: torch.Tensor, wsyn: torch.Tensor,
                           stride: int = 1) -> torch.Tensor:
    """Plain version of ``frames_irfft``: the windowed frames ``(..., T,
    n_fft)`` of the spectra ``(re, im)`` ``(..., T, n_fft // 2 + 1)``, float32,
    ``wsyn[i] sum_k c_k Re(X[k] e^{2 pi i k i / n_fft})`` with ``wsyn`` from
    :func:`irfft_window` (``c_0 = c_{n/2} = 1``, else 2; the imaginary parts
    at DC and nyquist are not read), in the kernel's schedule: pairs as
    :func:`frames_rfft_reference`'s, ``Z = X_0 + i X_1`` packed over ``k <
    n_fft`` as ``conj Z``, the Stockham passes, ``X_0 = wsyn Re``, ``X_1 =
    -(wsyn Im)``.  Uses no ``torch.fft``."""
    F = re.shape[-1]
    n = 2 * (F - 1)
    _check_size(n)
    lead, T = re.shape[:-2], re.shape[-2]
    ar, br = _pairs(re.to(torch.float32), stride)
    ai, bi = _pairs(im.to(torch.float32), stride)
    h = n // 2
    zr = torch.empty((ar.shape[0], n), dtype=torch.float32, device=ar.device)
    zi = torch.empty_like(zr)
    zr[:, 0], zi[:, 0] = ar[:, 0], -br[:, 0]
    zr[:, h], zi[:, h] = ar[:, h], -br[:, h]
    inner = slice(1, h)
    mirror = torch.arange(n - 1, h, -1, device=ar.device)          # n - k for 0 < k < n / 2
    zr[:, inner] = ar[:, inner] - bi[:, inner]
    zi[:, inner] = -(ai[:, inner] + br[:, inner])
    zr[:, mirror] = ar[:, inner] + bi[:, inner]
    zi[:, mirror] = ai[:, inner] - br[:, inner]
    (tw,) = _tables(fft_twiddles, ar.device, n)
    yr, yi = _stockham(zr, zi, tw[0], tw[1])
    w = wsyn.to(device=ar.device, dtype=torch.float32)
    return _unpairs(w * yr, -(w * yi), lead, T, stride)


def overlap_add_classes(frames: torch.Tensor, hop: int, offset: int = 0) -> torch.Tensor:
    """The overlap-add ``(..., (T - 1) hop + n_fft)`` of frames ``(..., T,
    n_fft)`` at hop stride, summed as ``frames_irfft``'s callers sum it: the
    frames ``t`` of class ``(t + offset) mod (n_fft / hop)`` (which do not
    overlap) added to a zero signal class after class, so each sample
    collects its terms in class order."""
    T, n = frames.shape[-2], frames.shape[-1]
    ov = n // hop
    out = frames.new_zeros(frames.shape[:-2] + ((T - 1) * hop + n,))
    for c in range(ov):
        t0 = (c - offset) % ov
        if t0 >= T:
            continue
        seg = frames[..., t0::ov, :].reshape(frames.shape[:-2] + (-1,))
        out[..., t0 * hop: t0 * hop + seg.shape[-1]] += seg
    return out
