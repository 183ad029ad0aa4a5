"""Phase Gradient Heap Integration (PGHI), peak-anchored scan formulation
(twin of the JAX ``ops/pghi.py``).

The phase of a Gaussian-window spectrogram follows from its magnitude: the
derivatives of the log-magnitude give the phase increments per frame and per
bin (Cauchy-Riemann relations of the Gabor transform),

    time_step[t, k] = dY/dk / fmul + 2 pi hop k / n_fft
    freq_step[t, k] = -fmul dY/dt + pi,        fmul = gamma / (hop n_fft)

and ``pghi_scan`` integrates them frame by frame with dense vector operations
only:

1. *time anchors*: bins that are local magnitude maxima along frequency and
   audible in this and the previous frame take the trapezoidal time integral
   from the previous frame's phase;
2. *frequency fill*: every other audible bin integrates the frequency
   trapezoid from its nearest anchor (two segmented scans, no heap);
3. *onset seeding*: a frame without a time anchor seeds at its loudest bin;
4. silent bins (below ``tolerance * max``) take random phases.

The random phases come in as ``angles`` or from an explicit
``torch.Generator``, never from a global seed.  Phases are not wrapped: the
carrier term alone adds ``2 pi hop k / n_fft`` per frame, so float32 phases
late in a long clip carry an absolute rounding of their own size's ulp.

``pghi_heap_numpy`` is the exact magnitude-ordered heap on the host, the
``pghi_exact`` inversion mode and the correctness oracle.
"""
from __future__ import annotations

import heapq
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["phase_gradients", "pghi_scan", "pghi_heap_numpy", "random_angles"]

EPS = 1.19e-7


def random_angles(shape, device, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform phases in ``[0, 2 pi)``; without a generator, one seeded with 0
    on ``device``."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return 2.0 * math.pi * torch.rand(tuple(shape), generator=generator, device=device)


def _edge_pad(x: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    """Replicate-pad one axis (``F.pad`` wants 3-D input for that mode)."""
    n = x.shape[dim]
    idx = torch.arange(-before, n + after, device=x.device).clamp_(0, n - 1)
    return x.index_select(dim, idx)


def phase_gradients(
    mag: torch.Tensor,
    gamma: float,
    n_fft: int,
    hop_length: int,
    time_stencil: str = "central",
    eps: float = EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase-gradient fields from a magnitude spectrogram ``(..., T, F)``.

    Returns ``(time_step, freq_step)``: the estimated phase increment per
    frame step (along T) and per bin step (along F).  ``time_stencil`` is
    ``"central"`` (offline) or ``"backward"``, the causal 3-point stencil
    ``(3 Y[t] - 4 Y[t-1] + Y[t-2]) / 2`` of the streaming variant."""
    fmul = gamma / (hop_length * n_fft)
    Y = torch.log(torch.clamp_min(mag, eps))
    Yf = _edge_pad(Y, -1, 1, 1)
    dY_dk = (Yf[..., 2:] - Yf[..., :-2]) / 2.0
    if time_stencil == "central":
        Yt = _edge_pad(Y, -2, 1, 1)
        dY_dt = (Yt[..., 2:, :] - Yt[..., :-2, :]) / 2.0
    elif time_stencil == "backward":
        Yt = _edge_pad(Y, -2, 2, 0)
        dY_dt = (3.0 * Yt[..., 2:, :] - 4.0 * Yt[..., 1:-1, :] + Yt[..., :-2, :]) / 2.0
    else:
        raise ValueError("unknown time stencil %r" % time_stencil)
    k = torch.arange(mag.shape[-1], device=mag.device, dtype=mag.dtype)
    time_step = dY_dk / fmul + (2.0 * math.pi * hop_length / n_fft) * k
    freq_step = -fmul * dY_dt + math.pi
    return time_step, freq_step


def _affine_scan(elems: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Inclusive prefix composition along the last axis of the affine maps
    ``x -> a x + b_i`` given as ``(a, b_0, b_1, ...)``; earlier maps apply
    first.  Pairwise recursion (combine neighbours, scan the halves,
    interleave): the order of additions of a work-efficient parallel scan."""

    def comb(l, r):
        return (l[0] * r[0],) + tuple(bl * r[0] + br for bl, br in zip(l[1:], r[1:]))

    n = elems[0].shape[-1]
    if n < 2:
        return tuple(elems)
    reduced = comb([e[..., 0:-1:2] for e in elems], [e[..., 1::2] for e in elems])
    odd = _affine_scan(reduced)
    if n % 2 == 0:
        even = comb([e[..., :-1] for e in odd], [e[..., 2::2] for e in elems])
    else:
        even = comb(odd, [e[..., 2::2] for e in elems])
    out = []
    for e, ev, od in zip(elems, even, odd):
        ev = torch.cat([e[..., :1], ev], dim=-1)
        full = e.new_empty(e.shape[:-1] + (n,))
        full[..., 0::2] = ev
        full[..., 1::2] = od
        out.append(full)
    return tuple(out)


def _nearest_anchor_fill(phase_anchor, anchored, freq_step):
    """Fill unanchored bins from the nearest anchored bin below (up-sweep) or
    above (down-sweep), the nearer of the two (below on a tie), integrating
    the ``freq_step`` trapezoid along the way.

    Two segmented affine scans: each bin is the map ``x -> v_k`` (anchored,
    which resets the chain) or ``x -> x + step_k``; a second channel counts
    the distance to the anchor.  A frame without any anchor comes out zero."""
    dt = phase_anchor.dtype
    n_bins = phase_anchor.shape[-1]
    trap = (freq_step[..., 1:] + freq_step[..., :-1]) / 2.0
    zero = torch.zeros_like(freq_step[..., :1])
    step_up = torch.cat([zero, trap], dim=-1)
    step_dn = torch.cat([-trap, zero], dim=-1)
    a = (~anchored).to(dt)
    dist0 = torch.where(anchored, 0.0, 1.0).to(dt)

    def scan_dir(step, reverse):
        b = torch.where(anchored, phase_anchor, step)
        elems = (a, b, dist0)
        if reverse:
            elems = tuple(e.flip(-1) for e in elems)
        ac, filled, dist = _affine_scan(elems)
        if reverse:
            ac, filled, dist = ac.flip(-1), filled.flip(-1), dist.flip(-1)
        return filled, dist, ac == 0

    f_up, d_up, v_up = scan_dir(step_up, False)
    f_dn, d_dn, v_dn = scan_dir(step_dn, True)
    big = float(10 * n_bins)
    du = torch.where(v_up, d_up, big)
    dd = torch.where(v_dn, d_dn, big)
    filled = torch.where(du <= dd, f_up, f_dn)
    any_anchor = anchored.any(dim=-1, keepdim=True)
    return torch.where(any_anchor, filled, torch.zeros_like(filled))


def _anchor_mask(m: torch.Tensor, prev_m: torch.Tensor, abstol: torch.Tensor):
    """Anchor selection for ``(..., T, F)`` frames at once: audible ridge cells
    that are also audible in the previous frame, plus onset seeding at the
    loudest bin of audible frames without an anchor.  ``abstol (..., 1)``.
    Returns ``(anchored, sig)``."""
    thr = abstol[..., None, :] if m.ndim > abstol.ndim else abstol
    sig = m > thr
    prev_sig = prev_m > thr
    mpad = F.pad(m, (1, 1), value=-1.0)
    peak = (m >= mpad[..., :-2]) & (m >= mpad[..., 2:])
    anchored = sig & prev_sig & peak
    no_anchor = ~anchored.any(dim=-1, keepdim=True)
    is_gmax = m == m.amax(dim=-1, keepdim=True)
    return anchored | (no_anchor & sig & is_gmax), sig


def _pghi_core(anchored, sig, c, freq_step, rnd, init_phase) -> torch.Tensor:
    """The serial time recurrence over the frame axis (-2).  Per frame, in
    this order: ``phi + c`` (anchored bins), the fill from those, the
    anchored / filled select, the silent-bin select."""
    phi = init_phase
    out = []
    for t in range(c.shape[-2]):
        anch = anchored[..., t, :]
        phi_t = phi + c[..., t, :]
        fill = _nearest_anchor_fill(
            torch.where(anch, phi_t, torch.zeros_like(phi_t)), anch, freq_step[..., t, :]
        )
        phi = torch.where(anch, phi_t, fill)
        phi = torch.where(sig[..., t, :], phi, rnd[..., t, :])
        out.append(phi)
    return torch.stack(out, dim=-2)


def pghi_scan(
    mag: torch.Tensor,
    gamma: float,
    n_fft: int,
    hop_length: int,
    tolerance: float = 1e-2,
    prev_mag: Optional[torch.Tensor] = None,
    prev_phase: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    time_stencil: str = "backward",
    parallel: Optional[bool] = None,
    block: Optional[int] = None,
    angles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Peak-anchored PGHI phases of ``mag (..., T, F)`` (see the module notes).

    ``prev_mag (..., 2, F)`` / ``prev_phase (..., F)`` carry streaming state
    across chunk boundaries; omit them offline.  Silent bins take ``angles``
    (same shape as ``mag``) or, without them, a draw from ``generator``.

    ``parallel`` / ``block`` are accepted for signature parity: the JAX
    package's sqrt-blocked schedule exists to cut the number of dispatched
    steps and computes the same recurrence up to the order of a few float
    additions; here the serial form always runs."""
    batch_shape = mag.shape[:-2]
    n_bins = mag.shape[-1]
    if prev_mag is None:
        prev_mag = mag.new_zeros(batch_shape + (2, n_bins))
    if prev_phase is None:
        prev_phase = mag.new_zeros(batch_shape + (n_bins,))
    mag_ext = torch.cat([prev_mag, mag], dim=-2)
    time_step, freq_step = phase_gradients(
        mag_ext, gamma, n_fft, hop_length, time_stencil=time_stencil
    )
    # the buffered frame's own time step seeds the first trapezoid, so chunked
    # streaming equals processing the frames in one call
    prev_ts = time_step[..., 1:2, :]
    time_step = time_step[..., 2:, :]
    freq_step = freq_step[..., 2:, :]
    mx = mag.amax(dim=(-2, -1), keepdim=True)
    abstol = torch.clamp_min(tolerance * mx, EPS)[..., 0, :]
    if angles is None:
        angles = random_angles(mag.shape, mag.device, generator)
    prev_m = torch.cat([prev_mag[..., 1:2, :], mag[..., :-1, :]], dim=-2)
    anchored, sig = _anchor_mask(mag, prev_m, abstol)
    ts_prev = torch.cat([prev_ts, time_step[..., :-1, :]], dim=-2)
    c = (ts_prev + time_step) / 2.0
    return _pghi_core(anchored, sig, c, freq_step, angles.to(mag.dtype), prev_phase)


def pghi_heap_numpy(
    mag: np.ndarray,
    gamma: float,
    n_fft: int,
    hop_length: int,
    tolerance: float = 1e-2,
) -> np.ndarray:
    """Exact magnitude-ordered heap integration of one ``(T, F)`` spectrogram
    on the host: seed at the global magnitude maximum, grow the region in
    decreasing-magnitude order, integrating the trapezoidal phase-gradient
    targets to the 4 neighbours; restart at the next maximum until only bins
    below ``tolerance * max`` remain (phase 0 there)."""
    mag = np.asarray(mag, dtype=np.float64)
    T, n_bins = mag.shape
    fmul = gamma / (hop_length * n_fft)
    Y = np.log(np.maximum(mag, EPS))
    Yp = np.pad(Y, 1, mode="edge")
    dY_dk = (Yp[1:-1, 2:] - Yp[1:-1, :-2]) / 2.0
    dY_dt = (Yp[2:, 1:-1] - Yp[:-2, 1:-1]) / 2.0
    time_step = dY_dk / fmul + (2.0 * np.pi * hop_length / n_fft) * np.arange(n_bins)
    freq_step = -fmul * dY_dt + np.pi

    phase = np.zeros((T, n_bins))
    m = mag.copy()
    m[m < m.max() * tolerance] = EPS
    heap = []
    remaining = m > EPS

    def push_seed():
        if not remaining.any():
            return False
        t, k = np.unravel_index(np.argmax(np.where(remaining, m, -np.inf)), m.shape)
        heapq.heappush(heap, (-m[t, k], int(t), int(k)))
        remaining[t, k] = False
        return True

    while push_seed():
        while heap:
            _, t, k = heapq.heappop(heap)
            for dt_, dk_, grad, sign in (
                (1, 0, time_step, +1.0),
                (-1, 0, time_step, -1.0),
                (0, 1, freq_step, +1.0),
                (0, -1, freq_step, -1.0),
            ):
                nt, nk = t + dt_, k + dk_
                if 0 <= nt < T and 0 <= nk < n_bins and remaining[nt, nk]:
                    phase[nt, nk] = phase[t, k] + sign * (grad[t, k] + grad[nt, nk]) / 2.0
                    heapq.heappush(heap, (-m[nt, nk], nt, nk))
                    remaining[nt, nk] = False
    return phase.astype(np.float32)
