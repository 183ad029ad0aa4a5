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
representation front ends (E, F, G, H) and O's two-launch analysis run the
forward; K's synthesis the inverse; the full-K Griffin-Lim step (J) and O's
polish both; the streaming roundtrips (L, M) both in one team
(``frames_roundtrip``), wherever :func:`fft_covers` takes ``n_fft``.  R,
N's encode, L, M, the streaming decodes (P, S, O's projection synthesis),
O's two-launch analysis, the full-K melspec forward and fit (E, F, and so
A and B under the taps' own window), the representation forward and fit (G,
H, full-K and under the taps' window), the Griffin-Lim steps (J, C, D, I),
K's synthesis and O's polish also take the mixed-radix schedule wherever
:func:`fft_covers_smooth` takes ``n_fft`` (even, ``2^a 3^b 5^c``, 64 to 4096,
not a power of two: 1200, 960, 768, 400, 1920, ...; the Griffin-Lim steps,
K's synthesis and the polish where their block fits too); R, N's encode, L,
M, the streaming decodes (P, S, O's projection synthesis), O's polish and
two-launch analysis, the full-K melspec forward and fit (E, F, and so A and
B), the full-K Griffin-Lim step J and K's synthesis also where
:func:`fft_covers_smooth7` does (a factor 7 as well: 896, 1344, 1680, 1764,
...; L, M, J, K's synthesis and the polish where their block fits, E and F
where a tile does: not at 4032/2016), with a radix-7 stage; every other
``n_fft`` keeps the window-folded products of ``dft_common.cuh`` and
``synth_ola.cuh`` (and A, B, G and H their factored front end; O's polish
the two-launch projection, its analysis a product).

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
* the mixed-radix schedule (``smooth=True``) is the same Stockham auto-sort
  FFT over the radices of :func:`fft_radices` (sevens, fives, threes, fours,
  then a two), one stage per trip: stage radix ``r`` with stride ``s`` reads
  ``x[b + k n/r]``, ``k < r``, for each butterfly ``b < n/r``, takes the
  length-``r`` DFT (:func:`_dft`; the radix-3, radix-5 and radix-7 constants
  rounded once from float64, :data:`SMOOTH_CONSTANTS`) and writes ``y[r (b - q) + q +
  s k]`` (``q = b mod s``), the outputs 1 to ``r - 1`` turned by the
  twiddles ``e^{-2 pi i k (b - q) / n}`` of the same table, except in the
  last stage, whose twiddles are all 1;
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
    "overlap_add_classes", "class_plan", "taps_window", "fft_covers_smooth", "fft_radices",
    "fft_smooth_team_threads", "fft_smooth_max_teams", "fft_smooth_table", "fft_smooth_smem_floats",
    "SMOOTH_CONSTANTS", "class_plan_smooth", "fft_area_floats", "fft_covers_smooth7",
]

FFT_MIN, FFT_MAX = 64, 4096       # the sizes frames_rfft takes (powers of two)
THREADS = 256                     # threads of a block (dft_common.cuh kThreads)
VALUES = 16                       # complex values a thread holds in a pass
MAX_SMEM = 232448                 # bytes of shared memory a block may use on sm_90
SM_SMEM = 233472                  # bytes of shared memory an SM holds for its blocks (1 KB reserved each)
TWO_BLOCKS_SMEM = SM_SMEM // 2 - 1024   # a block's share when two run on one SM


def fft_covers(n_fft: int) -> bool:
    """Whether the FFT route takes ``n_fft``: a power of two from 64 to 4096.
    Elsewhere R, L, M, the decodes, E and F (with A and B), G and H, J, C, D,
    I, K's synthesis and O's polish and analysis take the smooth route where
    :func:`fft_covers_smooth` does (R, N's encode, L, M, the decodes P, S
    and O's projection synthesis, O's polish and analysis, E and F with A
    and B, G and H, J and K's synthesis where :func:`fft_covers_smooth7`
    does), and the products (A, B, G and H the factored front end, O's
    polish the two-launch projection, its analysis a product) at every other
    ``n_fft``."""
    n = int(n_fft)
    return FFT_MIN <= n <= FFT_MAX and n & (n - 1) == 0


def fft_covers_smooth(n_fft: int) -> bool:
    """Whether the mixed-radix route takes ``n_fft``: even, ``2^a 3^b 5^c``
    (``a >= 1``), from 64 to 4096, and not a power of two (those keep
    :func:`fft_covers`'s schedule).  R, the magnitude encode, L, M, the
    streaming decodes (P, S, O's projection synthesis), the full-K melspec
    forward and fit E and F (so A and B, under the taps' own window), the
    representation forward and fit G and H, the Griffin-Lim steps J, C, D and
    I, K's synthesis and O's polish and analysis (each where its block fits)
    take it."""
    return _smooth(n_fft, (2, 3, 5))


def fft_covers_smooth7(n_fft: int) -> bool:
    """Whether the mixed-radix route with its radix-7 stage takes ``n_fft``:
    even, ``2^a 3^b 5^c 7^d`` (``a >= 1``), from 64 to 4096, and not a power
    of two; every size :func:`fft_covers_smooth` takes, and those with a
    factor 7 (896, 1344, 1680, 1764, ...).  R, the magnitude encode, L, M
    (L and M where their block fits), the streaming decodes P, S and O's
    projection synthesis, O's polish and two-launch analysis, the full-K
    melspec forward and fit E and F (so A and B under the taps' own window)
    and the representation forward and fit G and H
    (``spectral.melspec_route``; G and H where their block fits), the
    full-K Griffin-Lim step J (``glstep._fullk_plan``) and K's synthesis
    (``pghi_kernel.synth_route``) take it, J and K's synthesis where their
    block fits; the Griffin-Lim steps C, D and I keep
    :func:`fft_covers_smooth`."""
    return _smooth(n_fft, (2, 3, 5, 7))


def _smooth(n_fft: int, primes: Tuple[int, ...]) -> bool:
    n = int(n_fft)
    if not FFT_MIN <= n <= FFT_MAX or n % 2 or n & (n - 1) == 0:
        return False
    for p in primes:
        while n % p == 0:
            n //= p
    return n == 1


@functools.lru_cache(maxsize=None)
def fft_radices(n_fft: int) -> Tuple[int, ...]:
    """The radix plan of ``n_fft = 2^a 3^b 5^c 7^d``, in the order the
    stages run: the sevens, the fives, the threes, ``a // 2`` fours, then a
    two when ``a`` is odd (a power of two gets the radix-4 schedule's own
    radices).  The odd radices go first: their stride-``r`` writes (stride 1)
    fall on distinct banks, and the last stage, which needs no twiddle and
    writes where it reads, is a four or a two; a size without a seven keeps
    the plan it had before the radix-7 stage.  ``csrc/fft_smem.cuh:
    fft_smooth_plan`` is its twin."""
    n, out = int(n_fft), []
    for p in (7, 5, 3):
        while n % p == 0:
            out.append(p)
            n //= p
    while n % 4 == 0:
        out.append(4)
        n //= 4
    if n == 2:
        out.append(2)
        n = 1
    if n != 1:
        raise ValueError("n_fft=%d is no 2^a 3^b 5^c 7^d" % int(n_fft))
    return tuple(out)


def fft_smooth_team_threads(n_fft: int) -> int:
    """Threads that run one mixed-radix FFT together: the least power of two
    at or above ``n_fft / 16``, so that a thread holds 8 to 16 values, at
    most the power-of-two route's 16, and teams tile warps (128 at 1200,
    1920 and 1344, 64 at 960, 768 and 896, 32 at 400, 8 at 96)."""
    n, g = int(n_fft), 1
    while 16 * g < n:
        g *= 2
    return g


def fft_smooth_max_teams(n_fft: int) -> int:
    """Mixed-radix FFTs a block of 256 threads runs at the same time."""
    return THREADS // fft_smooth_team_threads(n_fft)


def fft_smooth_table(n_fft: int) -> int:
    """Twiddle-table entries the mixed-radix stages read: the largest ``k (b
    - q) + 1`` of a stage before the last, ``(r - 1)(n / r - s) + 1`` (957 at
    1200, whose first stage is a five; 763 at 896, 1147 at 1344 and 3451 at
    4032, whose first stage is a seven)."""
    n, s, out = int(n_fft), 1, 1
    rad = fft_radices(n)
    for r in rad[:-1]:
        out = max(out, (r - 1) * (n // r - s) + 1)
        s *= r
    return out


def fft_smooth_buf_floats(n_fft: int) -> int:
    """One team's buffer on the mixed-radix route: re and im of ``n_fft``
    values, unswizzled, then the second half the stages alternate with;
    teams that share a warp (fewer than 32 threads) start ``team threads``
    banks apart."""
    n, g = int(n_fft), fft_smooth_team_threads(n_fft)
    return 4 * n + ((g - 4 * n) % 32 if g < 32 else 0)


def fft_smooth_smem_floats(n_fft: int, teams: int) -> int:
    """Shared memory of the mixed-radix FFT in floats, as ``csrc/
    fft_smem.cuh`` lays it out: the window, the twiddles ``j <``
    :func:`fft_smooth_table` (cos and -sin) and the teams' buffers."""
    return n_fft + 2 * fft_smooth_table(n_fft) + teams * fft_smooth_buf_floats(n_fft)


#: the radix-3, radix-5 and radix-7 butterflies' constants, rounded once
#: from float64: sin(pi/3); cos(2 pi/5), cos(4 pi/5), sin(2 pi/5), sin(4
#: pi/5); cos and sin of 2 pi/7, 4 pi/7 and 6 pi/7 (``csrc/fft_smem.cuh``
#: holds the same floats as hex literals)
SMOOTH_CONSTANTS = {
    name: float(np.float32(v)) for name, v in (
        ("r3s", np.sin(np.pi / 3)), ("r5c1", np.cos(2 * np.pi / 5)), ("r5c2", np.cos(4 * np.pi / 5)),
        ("r5s1", np.sin(2 * np.pi / 5)), ("r5s2", np.sin(4 * np.pi / 5)),
        ("r7c1", np.cos(2 * np.pi / 7)), ("r7c2", np.cos(4 * np.pi / 7)), ("r7c3", np.cos(6 * np.pi / 7)),
        ("r7s1", np.sin(2 * np.pi / 7)), ("r7s2", np.sin(4 * np.pi / 7)), ("r7s3", np.sin(6 * np.pi / 7)))
}


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


def fft_area_floats(n_fft: int, teams: int) -> int:
    """``frames_rfft``'s area on the route ``n_fft`` takes, as the kernels'
    blocks lay it out (``csrc/fft_smem.cuh:fft_area_floats``): the FFT
    route's (:func:`fft_smem_floats`), else the smooth one's
    (:func:`fft_smooth_smem_floats`)."""
    return fft_smem_floats(n_fft, teams) if fft_covers(n_fft) else fft_smooth_smem_floats(n_fft, teams)


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


def class_plan_smooth(n_fft: int, hop: int, smem_bytes: Callable[[int, int], int],
                      widest: int = 64, blocks: int = 2,
                      analysis_pairs: Optional[Callable[[int], int]] = None) -> Optional[Tuple[int, int]]:
    """:func:`class_plan` of the mixed-radix route: ``(rows, teams)`` over
    every power of two of teams up to :func:`fft_smooth_max_teams` and every
    multiple of ``2 overlap`` up to ``widest``, the most chunks per round of
    pair FFTs (the synthesis's ``overlap`` classes, plus
    ``analysis_pairs(rows)`` pairs of a separate analysis where given: the
    Griffin-Lim steps run one after their synthesis) times the blocks an SM
    holds (as many as its shared memory takes at ``smem_bytes(rows, teams)``
    a block, 1 KB reserved each, at most ``blocks``: what the kernel's
    registers allow), ties to the taller block.
    A sweep of every plan at 1200/300, 960/240, 768/192, 400/100 and 1920/480
    (on an H100) found the largest rows of the most teams a bad rule there:
    fewer teams leave room for taller blocks (L: 24 chunks of 2 FFTs at
    960/240 0.68 ms, 8 of 4 FFTs 1.03); the decode's instance (64 registers,
    so 4 blocks an SM) took its fastest plan at all five with ``blocks=4``,
    up to 1.2x slower ones with 2 (400/100: 56 chunks of 8 FFTs 0.45 ms, 48
    chunks, three blocks an SM, 0.37); its radix-7 instance (80 registers,
    so ``blocks=3``) the fastest at 1344/336, 1792/448 and 1680/420 and
    within 3 % of it at 896/224 (48 chunks of 4 FFTs against 24)."""
    ov = n_fft // hop
    best, score = None, 0.0
    teams = 1
    while teams <= fft_smooth_max_teams(n_fft):
        for rows in range(2 * ov, widest + 1, 2 * ov):
            b = smem_bytes(rows, teams)
            if b > MAX_SMEM:
                break
            rounds = ov * -(-(rows // (2 * ov) + 1) // teams)
            if analysis_pairs is not None:
                rounds += -(-analysis_pairs(rows) // teams)
            s = min(blocks, SM_SMEM // (b + 1024)) * rows / rounds
            if s >= score:
                best, score = (rows, teams), s
        teams *= 2
    return best


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


def _dft(r: int, xr, xi):
    """The length-``r`` DFT (``e^{-2 pi i j k / r}``) of the lists ``(xr,
    xi)``, in the kernel's float32 operations (``fft_smem.cuh:fft_dft``)."""
    if r == 2:
        return [xr[0] + xr[1], xr[0] - xr[1]], [xi[0] + xi[1], xi[0] - xi[1]]
    if r == 4:
        apc_r, apc_i = xr[0] + xr[2], xi[0] + xi[2]
        amc_r, amc_i = xr[0] - xr[2], xi[0] - xi[2]
        bpd_r, bpd_i = xr[1] + xr[3], xi[1] + xi[3]
        bmd_r, bmd_i = xr[1] - xr[3], xi[1] - xi[3]
        return ([apc_r + bpd_r, amc_r + bmd_i, apc_r - bpd_r, amc_r - bmd_i],
                [apc_i + bpd_i, amc_i - bmd_r, apc_i - bpd_i, amc_i + bmd_r])
    c = SMOOTH_CONSTANTS
    if r == 3:
        # y0 = x0 + t, y1,2 = (x0 - t / 2) -+ i sin(pi/3) (x1 - x2), t = x1 + x2
        tr, ti = xr[1] + xr[2], xi[1] + xi[2]
        ar, ai = xr[0] - tr * 0.5, xi[0] - ti * 0.5
        br, bi = (xr[1] - xr[2]) * c["r3s"], (xi[1] - xi[2]) * c["r3s"]
        return [xr[0] + tr, ar + bi, ar - bi], [xi[0] + ti, ai - br, ai + br]
    if r == 5:
        s1r, s1i = xr[1] + xr[4], xi[1] + xi[4]
        d1r, d1i = xr[1] - xr[4], xi[1] - xi[4]
        s2r, s2i = xr[2] + xr[3], xi[2] + xi[3]
        d2r, d2i = xr[2] - xr[3], xi[2] - xi[3]
        a1r = (xr[0] + s1r * c["r5c1"]) + s2r * c["r5c2"]
        a1i = (xi[0] + s1i * c["r5c1"]) + s2i * c["r5c2"]
        a2r = (xr[0] + s1r * c["r5c2"]) + s2r * c["r5c1"]
        a2i = (xi[0] + s1i * c["r5c2"]) + s2i * c["r5c1"]
        b1r = d1r * c["r5s1"] + d2r * c["r5s2"]
        b1i = d1i * c["r5s1"] + d2i * c["r5s2"]
        b2r = d1r * c["r5s2"] - d2r * c["r5s1"]
        b2i = d1i * c["r5s2"] - d2i * c["r5s1"]
        # y1,4 = a1 -+ i b1, y2,3 = a2 -+ i b2
        return ([(xr[0] + s1r) + s2r, a1r + b1i, a2r + b2i, a2r - b2i, a1r - b1i],
                [(xi[0] + s1i) + s2i, a1i - b1r, a2i - b2r, a2i + b2r, a1i + b1r])
    if r == 7:
        return _dft7(xr, xi)
    raise ValueError("no radix-%d butterfly" % r)


#: the radix-7 butterfly's terms: for m = 1, 2, 3 the constants of cos(2 pi m
#: k / 7) and the signed constants of sin(2 pi m k / 7), k = 1, 2, 3
_R7_COS = (("r7c1", "r7c2", "r7c3"), ("r7c2", "r7c3", "r7c1"), ("r7c3", "r7c1", "r7c2"))
_R7_SIN = (((1, "r7s1"), (1, "r7s2"), (1, "r7s3")), ((1, "r7s2"), (-1, "r7s3"), (-1, "r7s1")),
           ((1, "r7s3"), (-1, "r7s1"), (1, "r7s2")))


def _dft7(xr, xi):
    """The length-7 DFT in the symmetric form, in this order of float32
    operations (``fft_smem.cuh:fft_dft<7>`` repeats it): ``s_k = x_k +
    x_{7-k}``, ``d_k = x_k - x_{7-k}`` (``k = 1, 2, 3``); ``y_0 = ((x_0 + s_1)
    + s_2) + s_3``; for ``m = 1, 2, 3`` ``a_m = ((x_0 + s_1 c_m1) + s_2 c_m2) +
    s_3 c_m3`` and ``b_m = (d_1 e_m1 + d_2 e_m2) + d_3 e_m3`` with ``c_mk =
    cos(2 pi m k / 7)`` and ``e_mk = sin(2 pi m k / 7)`` (each one of the six
    constants; a negative sine subtracts its term), then ``y_m = a_m - i b_m``,
    ``y_{7-m} = a_m + i b_m``."""
    c = SMOOTH_CONSTANTS
    sr = [xr[k] + xr[7 - k] for k in (1, 2, 3)]
    si = [xi[k] + xi[7 - k] for k in (1, 2, 3)]
    dr = [xr[k] - xr[7 - k] for k in (1, 2, 3)]
    di = [xi[k] - xi[7 - k] for k in (1, 2, 3)]
    yr, yi = [((xr[0] + sr[0]) + sr[1]) + sr[2]] + [None] * 6, [((xi[0] + si[0]) + si[1]) + si[2]] + [None] * 6
    for m in (1, 2, 3):
        cs, sn = _R7_COS[m - 1], _R7_SIN[m - 1]
        ar = ((xr[0] + sr[0] * c[cs[0]]) + sr[1] * c[cs[1]]) + sr[2] * c[cs[2]]
        ai = ((xi[0] + si[0] * c[cs[0]]) + si[1] * c[cs[1]]) + si[2] * c[cs[2]]
        br, bi = dr[0] * c[sn[0][1]], di[0] * c[sn[0][1]]
        for k in (1, 2):
            sign, name = sn[k]
            br = br + dr[k] * c[name] if sign > 0 else br - dr[k] * c[name]
            bi = bi + di[k] * c[name] if sign > 0 else bi - di[k] * c[name]
        yr[m], yi[m] = ar + bi, ai - br
        yr[7 - m], yi[7 - m] = ar - bi, ai + br
    return yr, yi


def _stockham_smooth(re: torch.Tensor, im: torch.Tensor, twr: torch.Tensor, twi: torch.Tensor):
    """The complex FFT of the rows of ``(re, im)`` ``(P, n)``, natural order,
    in the mixed-radix kernel's stages (:func:`fft_radices`)."""
    P, n = re.shape
    rad = fft_radices(n)
    s, nn = 1, n
    for st, r in enumerate(rad):
        m = nn // r
        ur, ui = _dft(r, list(re.reshape(P, r, m, s).unbind(1)), list(im.reshape(P, r, m, s).unbind(1)))
        if st < len(rad) - 1:
            base = torch.arange(m, device=re.device)[:, None] * s          # b - q = p s
            for k in range(1, r):
                wr, wi = twr[k * base], twi[k * base]                       # (m, 1), over q
                ur[k], ui[k] = ur[k] * wr - ui[k] * wi, ur[k] * wi + ui[k] * wr
        # y[q + s (r p + k)]: (P, m, r, s)
        re = torch.stack(ur, dim=2).reshape(P, n)
        im = torch.stack(ui, dim=2).reshape(P, n)
        s, nn = r * s, m
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


def _check_size(n: int, smooth: bool = False) -> None:
    if smooth:
        if not fft_covers_smooth7(n):
            raise ValueError("the mixed-radix schedule takes n_fft even, 2^a 3^b 5^c 7^d, from %d to %d and no "
                             "power of two, got %d" % (FFT_MIN, FFT_MAX, n))
    elif not fft_covers(n):
        raise ValueError("frames_rfft takes n_fft a power of two from %d to %d, got %d" % (FFT_MIN, FFT_MAX, n))


def frames_rfft_reference(frames: torch.Tensor, window: torch.Tensor,
                          stride: int = 1, smooth: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``frames_rfft``: ``(re, im)`` ``(..., T, n_fft // 2 +
    1)`` of the windowed frames ``(..., T, n_fft)``, float32, in the kernel's
    schedule (module notes): pairs ``(2 stride g + c, 2 stride g + c +
    stride)`` along ``T`` (``stride = 1``: ``(2j, 2j + 1)``), the Stockham
    passes, the split.  ``smooth``: the mixed-radix schedule, for ``n_fft``
    that :func:`fft_covers_smooth7` takes.  Uses no ``torch.fft``."""
    n = frames.shape[-1]
    _check_size(n, smooth)
    lead, T = frames.shape[:-2], frames.shape[-2]
    x = frames.to(torch.float32)
    w = window.to(device=x.device, dtype=torch.float32)
    first, second = _pairs(x, stride)
    (tw,) = _tables(fft_twiddles, x.device, n)
    zr, zi = (_stockham_smooth if smooth else _stockham)(w * first, w * second, tw[0], tw[1])
    F = n // 2 + 1
    k = torch.arange(F, device=x.device)
    a, b = zr[:, :F], zi[:, :F]
    c, d = zr[:, (n - k) % n], zi[:, (n - k) % n]
    x0r, x0i = (a + c) * 0.5, (b - d) * 0.5
    x1r, x1i = (b + d) * 0.5, (c - a) * 0.5
    return _unpairs(x0r, x1r, lead, T, stride), _unpairs(x0i, x1i, lead, T, stride)


def irfft_window(window: torch.Tensor, n_fft: int, smooth: bool = False) -> torch.Tensor:
    """The synthesis window as ``frames_irfft`` takes it: ``window / n_fft``
    in float32 (exact: ``n_fft`` is a power of two).  ``smooth`` (``n_fft``
    no power of two): the division in float64, rounded once to float32; the
    kernels read this table, so they round the fold as their plain versions
    do."""
    if smooth:
        return (window.to(torch.float64) / n_fft).to(torch.float32)
    return window.to(torch.float32) * (1.0 / n_fft)


def frames_irfft_reference(re: torch.Tensor, im: torch.Tensor, wsyn: torch.Tensor,
                           stride: int = 1, smooth: bool = False) -> torch.Tensor:
    """Plain version of ``frames_irfft``: the windowed frames ``(..., T,
    n_fft)`` of the spectra ``(re, im)`` ``(..., T, n_fft // 2 + 1)``, float32,
    ``wsyn[i] sum_k c_k Re(X[k] e^{2 pi i k i / n_fft})`` with ``wsyn`` from
    :func:`irfft_window` (``c_0 = c_{n/2} = 1``, else 2; the imaginary parts
    at DC and nyquist are not read), in the kernel's schedule: pairs as
    :func:`frames_rfft_reference`'s, ``Z = X_0 + i X_1`` packed over ``k <
    n_fft`` as ``conj Z``, the Stockham passes, ``X_0 = wsyn Re``, ``X_1 =
    -(wsyn Im)``.  ``smooth``: the mixed-radix schedule (``wsyn`` from
    ``irfft_window(..., smooth=True)``).  Uses no ``torch.fft``."""
    F = re.shape[-1]
    n = 2 * (F - 1)
    _check_size(n, smooth)
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
    yr, yi = (_stockham_smooth if smooth else _stockham)(zr, zi, tw[0], tw[1])
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
